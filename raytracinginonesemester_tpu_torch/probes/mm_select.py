"""P2: the one-hot attribute selection of ``scripts/probe_mm_select.py``
on the card.

On each of ``visits`` visits, ray r (of RT) selects lane w = (win[r] + k)
mod B of a table whose rows are attributes, and adds what it selected to
its sum, visit after visit.  As in the script, win + k is an int32 sum
that wraps past 2^31 - 1 and the mod takes the sign of B (``jnp``'s
``%``); for a B that divides 2^32 the wrap changes no lane.

- ``sel7(win, q)`` replaces ``sel_kernel`` (``pallas_call`` at
  ``probe_mm_select.py:86``): 7 masked lane reductions of q (22, B) a
  visit, ``acc += q[f, w]`` for f < 7 (a reduction with one nonzero term
  is that term).  The kernel stages the 7 rows, each followed by its
  first ``SEL_STRETCH`` lanes again, at a row stride of ``SEL_MAX_LANES``
  + ``SEL_STRETCH`` floats, walks ``SEL_STRETCH`` visits at a time with
  its reads ``SEL_AHEAD`` adds ahead, and deals the rays to warps sorted
  by their lane's bank (mod ``SEL_BANKS``) so that a warp's reads rarely
  share a bank (``csrc/probes.cu``);
- ``mm22(win, qsel)`` replaces ``mm_kernel`` (:88): the (RT, B) one-hot
  pick in bf16 times ``qsel`` (B, 128) bf16, accumulated in float32 (the
  kernel runs the product on the tensor cores with ``wgmma``), then
  ``acc += (hi + mid) + lo`` for each of the 22 attributes, whose three
  bf16 parts (``split3``) ``make_qsel`` packs at columns 0, 32 and 64.
  The wrapper packs the 72 columns the sums read for the kernel's
  shared-memory descriptor (``pack_qsel``) and allocates its staging
  ring and flags: in one launch the kernel multiplies the visits over
  the card while a warp a group of 32 rays adds the staged attributes
  in order close behind (``csrc/probes.cu``).

Both return (1, RT) float32.  The plain versions gather the selected
lanes (the product's one nonzero term) and add in the kernels' order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ._common import card, launch, timed

__all__ = ["RT", "B", "F", "VISITS", "split3", "make_qsel", "sel7",
           "sel7_plain", "mm22", "mm22_plain", "pack_qsel", "script_inputs",
           "hazard_inputs", "main"]

RT, B, F, VISITS = 512, 512, 22, 4096  # probe_mm_select.py:22
SEL_ROWS = 7  # sel_kernel's reductions a visit
# sel7's kernel (csrc/probes.cu kSel*): visits a stretch, the most lanes,
# reads ahead of the adds, bank classes
SEL_STRETCH, SEL_MAX_LANES, SEL_AHEAD, SEL_BANKS = 32, 1024, 28, 32
PARTS = (0, 32, 64)  # qsel's columns of hi, mid and lo
# mm22's kernel (csrc/probes.cu kMm*): the 9 column tiles of 8 the sums
# read, hi 0-23, mid 32-55, lo 64-87 (N = 72); K padded to a multiple of
# MM_KBLOCK; a staging ring of MM_SLOTS visits, [group of MM_GROUP rays]
# [visit mod MM_SLOTS][attribute][ray of the group], that the chain reads
# MM_COPY visits at a time
MM_COLS = [(j // 3) * 32 + (j % 3) * 8 + i for j in range(9) for i in range(8)]
MM_KBLOCK, MM_SLOTS, MM_COPY, MM_GROUP = 128, 512, 16, 32


def split3(q: torch.Tensor):
    """float32 -> (hi, mid, lo) bf16 with hi + mid + lo ~ q, as the
    script's ``split3`` (torch's bf16 cast rounds to nearest even, as
    ``astype(jnp.bfloat16)``)."""
    hi = q.to(torch.bfloat16).to(torch.float32)
    r = q - hi
    mid = r.to(torch.bfloat16).to(torch.float32)
    lo = (r - mid).to(torch.bfloat16)
    return hi.to(torch.bfloat16), mid.to(torch.bfloat16), lo


def make_qsel(q: torch.Tensor) -> torch.Tensor:
    """q (F, B) float32 -> qsel (B, 128) bf16: ``split3``'s parts of the
    F attributes at columns 0, 32 and 64, zeros elsewhere."""
    f = q.shape[0]
    qsel = torch.zeros(q.shape[1], 128, dtype=torch.bfloat16, device=q.device)
    for col, part in zip(PARTS, split3(q)):
        qsel[:, col:col + f] = part.t()
    return qsel


def _lanes(win: torch.Tensor, visits: int, lanes: int) -> torch.Tensor:
    """(visits, RT) int64: the lane each ray selects on each visit,
    (win + k) mod lanes with the sum wrapping in int32 as the script's."""
    k = torch.arange(visits, device=win.device)
    s = win.reshape(-1).to(torch.int64)[None, :] + k[:, None]
    return ((s + 2 ** 31) % 2 ** 32 - 2 ** 31) % lanes


def _ordered_sum(seq: torch.Tensor) -> torch.Tensor:
    """(n, RT) -> (1, RT): acc = acc + seq[i] for i = 0, 1, ... in float32."""
    acc = torch.zeros(seq.shape[1], dtype=torch.float32, device=seq.device)
    for row in seq:
        acc = acc + row
    return acc[None, :]


def _check_win(win: torch.Tensor) -> None:
    if win.dtype != torch.int32 or win.numel() == 0 or \
            win.reshape(-1).shape[0] != win.shape[0]:
        raise ValueError(f"win must be (RT,) or (RT, 1) int32, got "
                         f"{tuple(win.shape)} {win.dtype}")
    if win.device.type not in ("cpu", "cuda"):
        raise ValueError(f"win on {win.device}")


def _check_sel(win, q, visits):
    _check_win(win)
    if q.dtype != torch.float32 or q.ndim != 2 or q.shape[0] < SEL_ROWS \
            or not 0 < q.shape[1] <= SEL_MAX_LANES:
        raise ValueError(f"q must be (>= 7, B <= {SEL_MAX_LANES}) float32, "
                         f"got {tuple(q.shape)} {q.dtype}")
    if q.device != win.device or visits < 0:
        raise ValueError(f"q on {q.device}, win on {win.device}, "
                         f"visits={visits}")


def sel7_plain(win: torch.Tensor, q: torch.Tensor, visits: int = VISITS,
               stats: dict | None = None) -> torch.Tensor:
    """Plain version of ``sel7`` on the inputs' device; ``stats``
    (optional) receives its FP32 adds (``ops``)."""
    _check_sel(win, q, visits)
    w = _lanes(win, visits, q.shape[1])
    vals = q[:SEL_ROWS][:, w].permute(1, 0, 2)  # (visits, 7, RT)
    if stats is not None:
        stats["ops"] = vals.numel()
    return _ordered_sum(vals.reshape(-1, w.shape[1]))


def sel7(win: torch.Tensor, q: torch.Tensor, visits: int = VISITS
         ) -> torch.Tensor:
    """(1, RT) float32: each ray's sum over ``visits`` visits of q[f, w]
    for f < 7.  The CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    _check_sel(win, q, visits)
    if win.device.type == "cpu":
        return sel7_plain(win, q, visits)
    win, q = win.reshape(-1).contiguous(), q.contiguous()
    out = torch.empty(1, win.shape[0], dtype=torch.float32, device=q.device)
    launch("sel7", "sel7", win, q, win.shape[0], q.shape[1], visits, out)
    sel7.launches += 1
    return out


sel7.launches = 0


def _check_mm(win, qsel, visits):
    _check_win(win)
    if qsel.dtype != torch.bfloat16 or qsel.ndim != 2 or \
            qsel.shape[1] < PARTS[-1] + 24 or qsel.shape[0] % 16 or \
            not 0 < qsel.shape[0] <= 1024:
        raise ValueError(f"qsel must be (B, >= 88) bf16 with B a multiple "
                         f"of 16 up to 1024, got {tuple(qsel.shape)} "
                         f"{qsel.dtype}")
    if win.shape[0] % 16:
        raise ValueError(f"{win.shape[0]} rays: a multiple of 16")
    if qsel.device != win.device or visits < 0:
        raise ValueError(f"qsel on {qsel.device}, win on {win.device}, "
                         f"visits={visits}")


def mm22_plain(win: torch.Tensor, qsel: torch.Tensor, visits: int = VISITS,
               stats: dict | None = None) -> torch.Tensor:
    """Plain version of ``mm22`` on the inputs' device.  The product's
    row for ray r is qsel[w] (one term 1 x value, the rest zeros, exact
    in float32).  ``stats`` (optional): ``ops``, the FP32 adds;
    ``bf16_ops``, the product's operations on the columns the sums
    read."""
    _check_mm(win, qsel, visits)
    part = qsel.to(torch.float32)
    attr = part[:, 0:F] + part[:, 32:32 + F]
    attr = attr + part[:, 64:64 + F]  # (B, F): (hi + mid) + lo
    w = _lanes(win, visits, qsel.shape[0])
    vals = attr[w].permute(0, 2, 1)  # (visits, F, RT)
    if stats is not None:
        stats["ops"] = 3 * vals.numel()
        stats["bf16_ops"] = 2 * w.numel() * qsel.shape[0] * 3 * F
    return _ordered_sum(vals.reshape(-1, w.shape[1]))


def _pack(t: torch.Tensor) -> torch.Tensor:
    """(Kp, 72) -> flat, in ``pack_qsel``'s order: [k // 16][n // 8]
    [k % 16 // 8][n % 8][k % 8]."""
    t = t.reshape(t.shape[0] // 16, 2, 8, 9, 8).permute(0, 3, 1, 4, 2)
    return t.contiguous().reshape(-1)


@functools.lru_cache(maxsize=8)
def _pack_index(lanes: int, qcols: int, device: str) -> torch.Tensor:
    """Where each packed element comes from in qsel (B, qcols) flattened;
    B * qcols (one past the end: a zero) for the padding rows."""
    kp = -(-lanes // MM_KBLOCK) * MM_KBLOCK
    src = torch.full((kp, len(MM_COLS)), lanes * qcols, dtype=torch.int64)
    src[:lanes] = (torch.arange(lanes)[:, None] * qcols
                   + torch.tensor(MM_COLS)[None, :])
    return _pack(src).to(device)


def pack_qsel(qsel: torch.Tensor) -> torch.Tensor:
    """qsel (B, >= 88) bf16 -> the kernel's B operand, flat bf16: the 72
    read columns (``MM_COLS``) K-major in core matrices of 8 columns x 8
    k (16 bytes a column), no swizzle, K padded with zero rows to a
    multiple of ``MM_KBLOCK``.  Element (n, k) of k-step s = k // 16 sits
    at byte s * 2304 + (k % 16 // 8) * 128 + (n // 8) * 256 + (n % 8) *
    16 + (k % 8) * 2: the descriptor's leading byte offset (128) steps
    along K, its stride byte offset (256) along N.  One gather."""
    lanes, qcols = qsel.shape
    flat = qsel.reshape(-1)
    if lanes % MM_KBLOCK:
        flat = torch.cat([flat, flat.new_zeros(1)])
    return flat.index_select(0, _pack_index(lanes, qcols, str(qsel.device)))


def _mm22_launch(win: torch.Tensor, qsel: torch.Tensor, visits: int,
                 parts: int = 3) -> torch.Tensor:
    """``rt_mm22`` on CUDA tensors -> out; ``parts`` 1 runs the product
    alone, 2 the chain alone (on whatever the staging holds), 3 both."""
    win = win.reshape(-1).contiguous()
    qpack = pack_qsel(qsel)
    groups = -(-win.shape[0] // MM_GROUP)
    stage = torch.empty(groups * MM_SLOTS * F * MM_GROUP,
                        dtype=torch.float32, device=qsel.device)
    # the products counted a block of MM_COPY visits, then the visits
    # each group's chain has landed
    counters = torch.zeros(-(-visits // MM_COPY) + groups, dtype=torch.int32,
                           device=qsel.device)
    out = torch.empty(1, win.shape[0], dtype=torch.float32,
                      device=qsel.device)
    launch("mm22", "mm22", win, qpack, win.shape[0], qsel.shape[0],
           qpack.numel() // (16 * len(MM_COLS)), visits, stage, counters, out,
           parts)
    return out


def mm22(win: torch.Tensor, qsel: torch.Tensor, visits: int = VISITS
         ) -> torch.Tensor:
    """(1, RT) float32: each ray's sum over ``visits`` visits of (hi + mid)
    + lo of its selected lane, attribute after attribute, the selection
    a one-hot product on the tensor cores.  The CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check_mm(win, qsel, visits)
    if win.device.type == "cpu":
        return mm22_plain(win, qsel, visits)
    out = _mm22_launch(win, qsel, visits)
    mm22.launches += 1
    return out


mm22.launches = 0


def script_inputs(device="cuda"):
    """The script's inputs (``probe_mm_select.py:74-76``):
    ``default_rng(0)``'s q (22, 512) float32, then win (512,) -> (win
    (512, 1) int32, q, qsel)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((F, B)).astype(np.float32))
    win = torch.from_numpy(rng.integers(0, B, RT).astype(np.int32))
    q, win = q.to(device), win.reshape(RT, 1).to(device)
    return win, q, make_qsel(q)


def hazard_inputs(lanes: int = B, device="cuda"):
    """(wins, q): q (22, ``lanes``) float32 (the script's at B lanes, else
    ``default_rng(lanes)``'s) and {name: (RT,) int32 win} on the walks'
    hazards: the script's; within 12 lanes of 511 (visits wrap past lane
    511); negative, down to -2^31; all equal; 32 lanes apart (every ray
    in one bank class); and within 24 visits of 2^31 - 1, one at 2^31 - 1
    itself (win + k wraps to -2^31 in int32; for B lanes the lane goes on
    as without the wrap, for a ``lanes`` that does not divide 2^32 it
    jumps)."""
    win, q, _ = script_inputs(device)
    if lanes != B:
        rng = np.random.default_rng(lanes)
        q = torch.from_numpy(rng.standard_normal((F, lanes))
                             .astype(np.float32)).to(device)
    i = torch.arange(RT, dtype=torch.int32, device=device)
    neg = np.random.default_rng(1).integers(-2 ** 31, 0, RT).astype(np.int32)
    neg[0] = -2 ** 31
    wins = {"script": win.reshape(-1), "near 511": 500 + i % 12,
            "negative": torch.from_numpy(neg).to(device),
            "all equal": torch.full_like(i, 7), "32 apart": 32 * i + 5,
            "int32 edge": 2 ** 31 - 1 - i % 24}
    return wins, q


def main() -> None:
    """``python -m raytracinginonesemester_tpu_torch.probes.mm_select``:
    the script's two timed lines on the card, then its per-attribute bit
    check of the one-hot product against the masked reductions."""
    print(card(), flush=True)
    win, q, qsel = script_inputs()
    timed("sel7", lambda: sel7(win, q), VISITS)
    timed("mm22", lambda: mm22(win, qsel), VISITS)
    torch.backends.cuda.matmul.allow_tf32 = False
    pick = torch.zeros(RT, B, dtype=torch.float32, device=q.device)
    pick[torch.arange(RT), win[:, 0].long()] = 1.0
    sel_exact = torch.stack([torch.where(pick > 0, q[f][None, :], 0.0)
                             .sum(dim=1) for f in range(F)])
    mm_out = pick @ qsel.to(torch.float32)  # bf16 values, exact in float32
    mm_attr = (mm_out[:, 0:F] + mm_out[:, 32:32 + F]
               + mm_out[:, 64:64 + F]).t()
    same = sel_exact == mm_attr
    print("attr values bit-identical:", bool(same.all()),
          f"({float(same.float().mean()):.6f})")


if __name__ == "__main__":
    main()
