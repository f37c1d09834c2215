"""P3: the dynamic row reads of ``scripts/probe_dyn_reads.py`` on the card.

A (12 L, B) float32 table of 12 planes of L = 39 blocks; on each of
``visits`` visits, b = k mod L, and each column adds the visit's 12 rows
to its sum:

- ``dyn12(q)`` replaces ``dyn12_kernel`` (``pallas_call`` at
  ``probe_dyn_reads.py:54``): rows f L + b for f < 12 (plane-major);
- ``blk1(q)`` replaces ``blk1_kernel`` (:56): one (12, B) block at rows
  12 b .. 12 b + 11 (block-major).

Both return (1, B) float32, added in the kernels' order: visit after
visit, row after row.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import card, launch, timed

__all__ = ["RT", "B", "L", "VISITS", "PLANES", "dyn12", "dyn12_plain",
           "blk1", "blk1_plain", "script_inputs", "main"]

RT, B, L, VISITS = 512, 512, 39, 4096  # probe_dyn_reads.py:23
PLANES = 12  # rows a visit reads


def _check(q: torch.Tensor, visits: int) -> None:
    if q.dtype != torch.float32 or q.ndim != 2 or \
            q.shape[0] != PLANES * L or visits < 0:
        raise ValueError(f"q must be ({PLANES * L}, B) float32 and visits "
                         f">= 0, got {tuple(q.shape)} {q.dtype}, "
                         f"visits={visits}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q on {q.device}")


def _plain(q, visits, block_major, stats):
    _check(q, visits)
    b = torch.arange(visits, device=q.device) % L
    f = torch.arange(PLANES, device=q.device)
    rows = (b[:, None] * PLANES + f[None, :] if block_major
            else f[None, :] * L + b[:, None])  # (visits, 12)
    if stats is not None:
        stats["ops"] = rows.numel() * q.shape[1]
    acc = torch.zeros(q.shape[1], dtype=torch.float32, device=q.device)
    for row in q[rows.reshape(-1)]:
        acc = acc + row
    return acc[None, :]


def _kernel(q, visits, block_major):
    q = q.contiguous()
    out = torch.empty(1, q.shape[1], dtype=torch.float32, device=q.device)
    name = "blk1" if block_major else "dyn12"
    launch("dyn_reads", name, int(block_major), q, q.shape[1], visits, out)
    return out


def dyn12_plain(q: torch.Tensor, visits: int = VISITS,
                stats: dict | None = None) -> torch.Tensor:
    """Plain version of ``dyn12`` on the input's device; ``stats``
    (optional) receives its FP32 adds (``ops``)."""
    return _plain(q, visits, False, stats)


def dyn12(q: torch.Tensor, visits: int = VISITS) -> torch.Tensor:
    """(1, B): each column's sum of rows f L + b, f < 12, over the
    visits.  The CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    _check(q, visits)
    if q.device.type == "cpu":
        return dyn12_plain(q, visits)
    out = _kernel(q, visits, False)
    dyn12.launches += 1
    return out


def blk1_plain(q: torch.Tensor, visits: int = VISITS,
               stats: dict | None = None) -> torch.Tensor:
    """Plain version of ``blk1`` on the input's device; ``stats``
    (optional) receives its FP32 adds (``ops``)."""
    return _plain(q, visits, True, stats)


def blk1(q: torch.Tensor, visits: int = VISITS) -> torch.Tensor:
    """(1, B): each column's sum of rows 12 b + f, f < 12, over the
    visits.  The CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    _check(q, visits)
    if q.device.type == "cpu":
        return blk1_plain(q, visits)
    out = _kernel(q, visits, True)
    blk1.launches += 1
    return out


dyn12.launches = blk1.launches = 0


def script_inputs(device="cuda") -> torch.Tensor:
    """The script's table (``probe_dyn_reads.py:51-52``): ``default_rng(0)``
    standard normals, (468, 512) float32."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(
        rng.standard_normal((PLANES * L, B)).astype(np.float32)).to(device)


def main() -> None:
    """``python -m raytracinginonesemester_tpu_torch.probes.dyn_reads``:
    the script's two timed lines, on the card."""
    print(card(), flush=True)
    q = script_inputs()
    timed("dyn12", lambda: dyn12(q), VISITS)
    timed("blk1", lambda: blk1(q), VISITS)


if __name__ == "__main__":
    main()
