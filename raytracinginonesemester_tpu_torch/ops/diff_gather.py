"""Differentiable row gather whose backward pass is kernel J.

PyTorch/CUDA port of ``raytracinginonesemester_tpu.ops.diff_gather``.
The differentiable integrator gathers each ray's winner triangle
(``vertices[idx]``, (R, 3, 3)), its vertex normals and its material row,
and backpropagates pixel gradients into those tables.  ``gather_rows``
is that gather as a ``torch.autograd.Function``: the forward is plain
clamped indexing, the backward sends the table cotangent through
``segment_accum_rows`` and never through autograd's own ``index``
backward (an atomic scatter-add on the card, whose float sums change
from run to run).

``segment_accum_rows`` replaces the Pallas kernel ``_segment_accum_kernel``
(``diff_gather.py:46``, called at ``:99``), a one-hot MXU contraction over
512-ray tiles.  Here it is a sorted segmented reduction: the glue sorts
the ids stably and gives each bin its run of rays, and the CUDA kernel
(``csrc/segment_accum.cu``) sums each (bin, feature) in ascending ray
order, with no float atomics, so the gradient is the same on every run.
On CPU tensors the plain version runs instead: ``index_add_`` on the
host, which adds in ascending ray order too, so the two agree bit for
bit.  The bf16-split MXU selection of the forward (``_mxu_gather``) and
the one-hot ``gather_table_small`` are TPU workarounds and not ported.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

__all__ = ["MAX_FEATURES", "gather_rows", "gather_int_rows",
           "segment_accum_rows", "segment_accum_rows_plain", "launch_counts",
           "reset_launch_counts"]

MAX_FEATURES = 16  # the JAX kernel's (16, R) feature rows


def _check(idx: torch.Tensor, ct: torch.Tensor, rows: int) -> None:
    if idx.ndim != 1 or idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise ValueError(f"idx must be a 1-D integer tensor, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if ct.ndim != 2 or ct.shape[0] != idx.shape[0] or ct.dtype != torch.float32:
        raise ValueError(f"ct must be (R, F) float32 with R = {idx.shape[0]}, "
                         f"got {tuple(ct.shape)} {ct.dtype}")
    if ct.shape[1] > MAX_FEATURES:
        raise ValueError(f"{ct.shape[1]} features per row; at most "
                         f"{MAX_FEATURES}")
    if idx.device != ct.device or ct.device.type not in ("cpu", "cuda"):
        raise ValueError(f"idx on {idx.device}, ct on {ct.device}")
    if rows < 0:
        raise ValueError(f"rows={rows}")


def segment_accum_rows_plain(idx: torch.Tensor, ct: torch.Tensor,
                             rows: int) -> torch.Tensor:
    """Plain version of ``segment_accum_rows``, on the inputs' device.

    The sums are taken on the host: ``index_add_`` there adds the rows
    one by one in ascending ray order (CUDA's ``index_add_`` uses float
    atomics, whose order changes from run to run)."""
    _check(idx, ct, rows)
    i = idx.detach().cpu().to(torch.int64)
    c = ct.detach().cpu()
    keep = (i >= 0) & (i < rows)
    out = torch.zeros(rows, ct.shape[1], dtype=torch.float32)
    out.index_add_(0, i[keep], c[keep])
    return out.to(ct.device)


def segment_accum_rows(idx: torch.Tensor, ct: torch.Tensor,
                       rows: int) -> torch.Tensor:
    """Sum-scatter ``ct`` (R, F <= 16) float32 into ``rows`` bins by
    ``idx`` (R,) -> (rows, F): ``out[b] = sum of ct[r]`` over the rays
    with ``idx[r] == b`` in ascending r; ids outside [0, rows) are
    dropped.  Kernel J for CUDA tensors, the plain version for CPU
    tensors."""
    _check(idx, ct, rows)
    if ct.device.type == "cpu":
        return segment_accum_rows_plain(idx, ct, rows)
    r, f = ct.shape
    dev = ct.device
    out = torch.empty(rows, f, dtype=torch.float32, device=dev)
    if rows == 0 or f == 0:
        return out
    # glue: a stable sort puts each bin's rays in one run, in ascending
    # ray order; ids out of range key past the last bin and are never read
    i = idx.to(torch.int64)
    key = torch.where((i >= 0) & (i < rows), i, rows)
    perm = torch.argsort(key, stable=True).to(torch.int32)
    count = torch.bincount(key, minlength=rows + 1)[:rows]
    start = (torch.cumsum(count, 0) - count).to(torch.int32)
    count = count.to(torch.int32)
    ct_fm = ct.detach().t().contiguous()  # (F, R) feature-major
    from ._native import load

    lib = load("segment_accum")

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    err = lib.rt_segment_accum(
        ptr(ct_fm), ptr(perm), ptr(start), ptr(count), r, rows, f, ptr(out),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        msg = lib.rt_error_string(err).decode()
        raise RuntimeError(f"segment_accum kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    segment_accum_rows.launches += 1
    return out


segment_accum_rows.launches = 0


class _GatherRows(torch.autograd.Function):
    """``table[clamp(idx)]``; the table's gradient through kernel J."""

    @staticmethod
    def forward(ctx, table, idx):
        rows = int(table.shape[0])
        ctx.rows = rows
        ctx.trail = tuple(table.shape[1:])
        ctx.save_for_backward(idx)
        return table[torch.clamp(idx.to(torch.int64), 0, rows - 1)]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        f = int(np.prod(ctx.trail)) if ctx.trail else 1
        g = segment_accum_rows(idx, grad.reshape(idx.shape[0], f)
                               .to(torch.float32).contiguous(), ctx.rows)
        return g.reshape((ctx.rows,) + ctx.trail), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[clamp(idx, 0, rows - 1)]`` for a (rows, ...) float32 table
    whose trailing dims hold at most 16 elements; idx (R,) integer.  The
    index gets no gradient; the table's gradient is
    ``segment_accum_rows`` of the cotangent by the unclamped ``idx``
    (out-of-range rays drop out, as in the JAX custom VJP)."""
    trail = int(np.prod(table.shape[1:])) if table.ndim > 1 else 1
    if trail > MAX_FEATURES:
        raise ValueError(f"rows of {trail} elements; at most {MAX_FEATURES}")
    if table.shape[0] == 0:
        raise ValueError("empty table")
    return _GatherRows.apply(table, idx)


def gather_int_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[clamp(idx, 0, rows - 1)]`` for an integer row vector (the
    per-triangle object ids): plain indexing, no gradient."""
    return table[torch.clamp(idx.to(torch.int64), 0, int(table.shape[0]) - 1)]


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"segment_accum": segment_accum_rows.launches}


def reset_launch_counts() -> None:
    segment_accum_rows.launches = 0
