"""P1: the toy kernel of ``scripts/probe_toy_mask.py`` on the card.

``toy_mask(mode, rays, aabb)`` replaces the Pallas kernel ``kernel``
(``pallas_call`` at ``probe_toy_mask.py:63``), a bisect of a scoped-VMEM
OOM on the TPU.  ``rays`` (8 n, RT) float32 holds n blocks of 8 rows:
origin (rows 0-2), direction (3-5; the kernel takes 1 / d), distance (6),
row 7 unused.  ``aabb`` (L, >= 6) float32: box min in columns 0-2, max in
3-5.  Per block:

- ``grid``: the slab test of the block's RT rays against every box in
  the window [1e-4, dist], min and max propagating NaN (``jnp.minimum``,
  ``jnp.maximum``), reduced to mask[l] = 1 if any ray enters box l; every
  row of the block's output is mask[0] + dist;
- ``scalar``: mask all ones; then, while k < L and any output is below 3,
  add 1 to the block's output where mask[k] is set;
- ``both``: the ``grid`` mask, then the ``scalar`` loop.

Each trip of the loop adds 1 to all of the block's output, so the loop
ends with ``min(3, set boxes)``: the plain version runs the loop, trip by
trip, and the CUDA kernel computes that closed form from the mask's
popcount, a cluster of 8 CTAs a block, each testing a chunk of the boxes
and writing one row (``csrc/probes.cu``).  (Pallas's interpret mode
reads the loop condition's ref at its value on entry, so there
``scalar`` gives L and ``both`` the count of set boxes; the kernel's own
function is ``min(3, that)``.)  The script's ``grid`` store of a (1, RT)
row into the (8, RT) block does not trace; its meaning, the row
broadcast over the 8 rows, is computed here.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import card, launch

__all__ = ["L", "RT", "LP", "MODES", "slab_hits", "box_mask", "toy_mask",
           "toy_mask_plain", "script_inputs", "hazard_inputs", "count_inputs",
           "main"]

L, RT = 156, 512  # boxes, rays of a block (probe_toy_mask.py:19)
LP = 160  # the mask scratch's rows: at most LP boxes
MODES = ("grid", "scalar", "both")
ROWS = 8  # rows of a ray block
SLAB_OPS = 25  # FP32 operations of one ray-box slab test (3 x 8 + compare)


def _check(mode: str, rays: torch.Tensor, aabb: torch.Tensor) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    if rays.dtype != torch.float32 or rays.ndim != 2 or \
            rays.shape[0] % ROWS or not 0 < rays.shape[1] <= 1024:
        raise ValueError(f"rays must be (8 n, RT <= 1024) float32, got "
                         f"{tuple(rays.shape)} {rays.dtype}")
    if aabb.dtype != torch.float32 or aabb.ndim != 2 or \
            not 0 < aabb.shape[0] <= LP or aabb.shape[1] < 6:
        raise ValueError(f"aabb must be (1..{LP}, >= 6) float32, got "
                         f"{tuple(aabb.shape)} {aabb.dtype}")
    if rays.device != aabb.device or rays.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rays on {rays.device}, aabb on {aabb.device}")


def slab_hits(rays: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """(n, L, RT) bool: does ray j of block i enter box l in its window
    [1e-4, dist] (the ``grid`` slab test; min and max propagate NaN, so a
    NaN on any axis fails the box)."""
    nb, rt, n_boxes = rays.shape[0] // ROWS, rays.shape[1], aabb.shape[0]
    blk = rays.reshape(nb, ROWS, rt)
    o, si = blk[:, 0:3], 1.0 / blk[:, 3:6]
    t0 = torch.full((nb, n_boxes, rt), 1e-4, dtype=torch.float32,
                    device=rays.device)
    t1 = blk[:, 6][:, None, :].expand(nb, n_boxes, rt)
    for a in range(3):
        oa, sa = o[:, a][:, None, :], si[:, a][:, None, :]
        lo = (aabb[:, a][None, :, None] - oa) * sa
        hi = (aabb[:, a + 3][None, :, None] - oa) * sa
        t0 = torch.maximum(t0, torch.minimum(lo, hi))
        t1 = torch.minimum(t1, torch.maximum(lo, hi))
    return t0 <= t1


def box_mask(rays: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """(n, L) bool: does any ray of block i enter box l (``slab_hits``)."""
    return slab_hits(rays, aabb).any(dim=2)


def toy_mask_plain(mode: str, rays: torch.Tensor, aabb: torch.Tensor,
                   stats: dict | None = None) -> torch.Tensor:
    """Plain version of ``toy_mask``, on the inputs' device.  ``stats``
    (optional) receives the FP32 operations the function does on these
    inputs (``ops``) and its ray-box pairs (``pairs``)."""
    _check(mode, rays, aabb)
    nb, rt, n_boxes = rays.shape[0] // ROWS, rays.shape[1], aabb.shape[0]
    pairs = 0
    if mode == "scalar":
        mask = torch.ones(nb, n_boxes, dtype=torch.bool, device=rays.device)
    else:
        mask = box_mask(rays, aabb)
        pairs = nb * n_boxes * rt
    trips = 0
    if mode == "grid":
        v = mask[:, 0:1].to(torch.float32) + rays.reshape(nb, ROWS, rt)[:, 6]
    else:
        # the block's output is uniform: each trip adds 1 to all of it
        v = torch.zeros(nb, 1, dtype=torch.float32, device=rays.device)
        for k in range(n_boxes):
            live = v < 3.0
            if not bool(live.any()):
                break
            v = torch.where(live & mask[:, k:k + 1], v + 1.0, v)
        trips = int(v.sum())
        v = v.expand(nb, rt)
    if stats is not None:
        stats["pairs"] = pairs
        stats["ops"] = pairs * SLAB_OPS + 3 * nb * rt + trips * ROWS * rt
    return v[:, None, :].expand(nb, ROWS, rt).reshape(nb * ROWS, rt) \
        .contiguous()


def toy_mask(mode: str, rays: torch.Tensor, aabb: torch.Tensor
             ) -> torch.Tensor:
    """(8 n, RT) float32: the probe's output for ``mode`` (module
    docstring).  The CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    _check(mode, rays, aabb)
    if rays.device.type == "cpu":
        return toy_mask_plain(mode, rays, aabb)
    rays, aabb = rays.contiguous(), aabb.contiguous()
    out = torch.empty_like(rays)
    launch("toy_mask", "toy_mask", MODES.index(mode), rays, aabb,
           rays.shape[0] // ROWS, rays.shape[1], aabb.shape[0],
           aabb.shape[1], out)
    toy_mask.launches += 1
    return out


toy_mask.launches = 0


def script_inputs(device="cuda"):
    """The script's inputs (``probe_toy_mask.py:77-78``): all ones, (64,
    512) rays and (156, 8) boxes."""
    return (torch.ones(64, RT, dtype=torch.float32, device=device),
            torch.ones(L, 8, dtype=torch.float32, device=device))


def hazard_inputs(seed: int = 0, device="cuda"):
    """Seeded (64, 512) rays and (156, 8) boxes with the slab test's
    hazards: direction components of +0 and -0 (1 / d infinite), box
    faces through such a ray's origin (0 * inf = NaN: the box fails on
    that axis), and a NaN distance in every block.  Blocks 0-2 start
    outside every box and reach one only through 0, 1 and 2 rays aimed at
    their nearest boxes, so few of their boxes are set (0, 1 and 3 with
    seed 0) and ``both`` is exercised below its cap of 3; blocks 3-7
    start inside the boxes' cube and reach from 0.01 to 3 units (mask[0]
    is 0 in blocks 0-2 and 1 in 3-7 with seed 0)."""
    rng = np.random.default_rng(seed)
    nb = 8
    c = rng.uniform(-1, 1, (L, 3))
    h = rng.uniform(0.02, 0.3, (L, 3))
    aabb = np.zeros((L, 8), np.float32)
    aabb[:, 0:3], aabb[:, 3:6] = c - h, c + h
    o = rng.uniform(-1, 1, (nb, 3, RT))
    o[:3] = rng.uniform(3, 4, (3, 3, RT))
    d = rng.uniform(-1, 1, (nb, 3, RT))
    reach = np.array([0.003, 0.003, 0.003, 0.01, 0.1, 0.3, 1.0, 3.0])
    dist = rng.uniform(0, 1, (nb, RT)) * reach[:, None]
    for blk in (1, 2):
        for lane in range(blk):  # to the centre of its lane-th nearest box
            near = np.argsort(np.linalg.norm(c - o[blk, :, lane], axis=1))
            d[blk, :, lane] = c[near[lane]] - o[blk, :, lane]
            dist[blk, lane] = 1.0
    zero = rng.random((nb, 3, RT)) < 0.05
    zero[1:3, :, 0:2] = False
    d[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
    dist[:, 7] = np.nan
    rays = np.zeros((nb, ROWS, RT), np.float32)
    rays[:, 0:3], rays[:, 3:6], rays[:, 6] = o, d, dist
    blocks, axes, lanes = np.nonzero(zero[3:])
    for box in range(0, L, 5):  # a face through a zero-direction origin
        i = rng.integers(blocks.size)
        b, a, j = blocks[i] + 3, axes[i], lanes[i]
        aabb[box, a + 3 * int(rng.integers(2))] = rays[b, a, j]
    return (torch.from_numpy(rays.reshape(nb * ROWS, RT)).to(device),
            torch.from_numpy(aabb).to(device))


def count_inputs(n_boxes: int, rt: int = 100, seed: int = 0,
                 device="cuda"):
    """Seeded (64, rt >= 22) rays and (n_boxes, 8) boxes whose 8 blocks set
    0, 1, 2, 3, 4, 7, 20 and rt - 2 boxes (at most ``n_boxes``): disjoint boxes
    of side 1, 3 apart along x; a block's chosen rays (at random columns)
    cross the centres of distinct boxes nearly along z (direction x and y
    within 0.05, some of them +0 or -0), its other rays start left of
    every box.  Block 3's boxes include box 0, so ``grid``'s mask[0] is
    set there.  Two of a block's other rays meet a box's hazards and
    enter nothing: a NaN distance, and an origin on a box's face with a
    zero direction on that axis (0 * inf = NaN)."""
    rng = np.random.default_rng(seed)
    nb = 8
    cx = 3.0 * np.arange(n_boxes)
    aabb = np.zeros((n_boxes, 8), np.float32)
    aabb[:, 0], aabb[:, 3] = cx - 0.5, cx + 0.5
    aabb[:, 1:3], aabb[:, 4:6] = -0.5, 0.5
    rays = np.zeros((nb, ROWS, rt), np.float32)
    for blk, want in enumerate((0, 1, 2, 3, 4, 7, 20, rt - 2)):
        count = min(want, n_boxes)
        boxes = rng.permutation(n_boxes)[:count]
        if blk == 3 and count:
            boxes[boxes == 0] = boxes[0]
            boxes[0] = 0
        cols = rng.permutation(rt)
        o = np.stack([rng.uniform(-12, -10, rt), rng.uniform(-0.2, 0.2, rt),
                      np.full(rt, -5.0)])
        d = np.stack([rng.uniform(-0.05, 0.05, rt),
                      rng.uniform(-0.05, 0.05, rt), np.ones(rt)])
        zero = rng.random((2, rt)) < 0.3
        d[:2][zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
        dist = np.full(rt, 10.0)
        o[0, cols[:count]] = cx[boxes] + rng.uniform(-0.2, 0.2, count)
        nan_ray, face_ray = cols[count], cols[count + 1]
        o[0, nan_ray] = cx[rng.integers(n_boxes)]
        dist[nan_ray] = np.nan
        o[0, face_ray] = aabb[rng.integers(n_boxes), 0]
        d[0, face_ray] = 0.0
        rays[blk, 0:3], rays[blk, 3:6], rays[blk, 6] = o, d, dist
    return (torch.from_numpy(rays.reshape(nb * ROWS, rt)).to(device),
            torch.from_numpy(aabb).to(device))


def main() -> None:
    """``python -m raytracinginonesemester_tpu_torch.probes.toy_mask``:
    each mode on the script's inputs, as the script prints it, with the
    kernel's time on the card."""
    from ..utils.timing import cuda_time_ms

    print(card(), flush=True)
    rays, aabb = script_inputs()
    for mode in MODES:
        out = toy_mask(mode, rays, aabb)
        ms = cuda_time_ms(lambda: toy_mask(mode, rays, aabb), warmup=1,
                          iters=5)["median_ms"]
        print(f"{mode}: OK {float(out[0].sum()):.1f}  {ms:.4f} ms (median "
              f"of 5 CUDA-event timings)", flush=True)


if __name__ == "__main__":
    main()
