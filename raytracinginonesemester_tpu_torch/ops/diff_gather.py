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
512-ray tiles.  Here it is a sorted segmented reduction in a fixed
two-level order: the glue (``segment_plan``) sorts the ids stably, so
each bin's rays form one run in ascending ray order, and cuts each run
into chunks of ``CHUNK`` entries; the CUDA kernel
(``csrc/segment_accum.cu``) sums each chunk with one warp (lane l adds
entries l, l + 32, ... from +0.0, a fixed xor tree joins the 32 lanes),
then each bin's chunk sums the same way.  No float atomics: the gradient
is the same on every run.  On CPU tensors the plain version runs
instead, the same expression tree evaluated step by step in float32 on
the host, so the two agree bit for bit.  The bf16-split MXU selection of
the forward (``_mxu_gather``) and the one-hot ``gather_table_small`` are
TPU workarounds and not ported.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

__all__ = ["CHUNK", "MAX_FEATURES", "gather_rows", "gather_int_rows",
           "segment_accum_rows", "segment_accum_rows_plain", "segment_plan",
           "segment_accum_planned",
           "launch_counts", "reset_launch_counts"]

MAX_FEATURES = 16  # the JAX kernel's (16, R) feature rows
CHUNK = 256  # run entries a warp sums (kChunk of csrc/segment_accum.cu)
LANES = 32  # the lanes of a warp: the first level of each sum


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


def _lane_tree(seg, pos, vals, n_seg: int) -> torch.Tensor:
    """One level of the kernel's order, in float32 step by step: entry
    ``vals[k]`` (N, F) sits at position ``pos[k]`` of segment ``seg[k]``;
    lane p % 32 of each segment adds its entries in ascending p from
    +0.0, then the xor tree (16, 8, 4, 2, 1) joins the lanes, lane l
    holding v_l + v_(l + h) -> (n_seg, F)."""
    acc = torch.zeros(n_seg, LANES, vals.shape[1], dtype=torch.float32)
    lane, level = pos % LANES, pos // LANES
    for lv in range(int(level.max()) + 1 if level.numel() else 0):
        m = level == lv  # one entry per (segment, lane) at each level
        s, l = seg[m], lane[m]
        acc[s, l] = acc[s, l] + vals[m]
    h = LANES // 2
    while h:
        acc = acc[:, :h] + acc[:, h:2 * h]
        h //= 2
    return acc[:, 0]


def segment_accum_rows_plain(idx: torch.Tensor, ct: torch.Tensor,
                             rows: int) -> torch.Tensor:
    """Plain version of ``segment_accum_rows``, on the inputs' device:
    the kernel's expression tree, evaluated on the host.  Each bin's
    rays in ascending order are cut into chunks of ``CHUNK``; a chunk's
    sum and then the bin's sum over its chunks each take
    ``_lane_tree``'s order.  An empty bin is +0.0."""
    _check(idx, ct, rows)
    i = idx.detach().cpu().to(torch.int64)
    c = ct.detach().cpu()
    keep = (i >= 0) & (i < rows)
    key, vals = i[keep], c[keep]
    order = torch.argsort(key, stable=True)
    key, vals = key[order], vals[order]
    count = torch.bincount(key, minlength=rows)
    nch = (count + CHUNK - 1) // CHUNK
    first = torch.cumsum(nch, 0) - nch  # each bin's first chunk
    pos = torch.arange(key.numel()) - (torch.cumsum(count, 0) - count)[key]
    partial = _lane_tree(first[key] + pos // CHUNK, pos % CHUNK, vals,
                         int(nch.sum()))
    used = (nch > 0).nonzero().squeeze(1)
    chunk_bin = torch.repeat_interleave(torch.arange(used.numel()), nch[used])
    m = torch.arange(partial.shape[0]) - first[used][chunk_bin]
    out = torch.zeros(rows, c.shape[1], dtype=torch.float32)
    out[used] = _lane_tree(chunk_bin, m, partial, used.numel())
    return out.to(ct.device)


def segment_plan(idx: torch.Tensor, rows: int):
    """The glue of kernel J on the ids' device -> (perm, bounds, cstart,
    max_chunks): ``perm`` (R,) int32 the stable order of the ids, each
    bin's rays one run in ascending ray order and out-of-range ids keyed
    past the last bin; ``bounds`` (rows + 1,) int32 the runs' starts
    (``bounds[rows]``: the rays kept); ``cstart`` (rows + 1,) int32 each
    bin's first chunk of ``CHUNK`` (``cstart[rows]``: all chunks); and
    ``max_chunks``, a bound on the chunks known without reading them."""
    dev = idx.device
    i = idx.to(torch.int32)
    key = torch.where((i >= 0) & (i < rows), i, rows)
    key, perm = torch.sort(key, stable=True)
    bounds = torch.searchsorted(
        key, torch.arange(rows + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    cstart = torch.zeros(rows + 1, dtype=torch.int32, device=dev)
    torch.cumsum((bounds[1:] - bounds[:-1] + (CHUNK - 1)) // CHUNK, 0,
                 dtype=torch.int32, out=cstart[1:])
    r = int(idx.shape[0])
    return (perm.to(torch.int32), bounds, cstart,
            r // CHUNK + min(rows, r) + 1)


def segment_accum_rows(idx: torch.Tensor, ct: torch.Tensor,
                       rows: int) -> torch.Tensor:
    """Sum-scatter ``ct`` (R, F <= 16) float32 into ``rows`` bins by
    ``idx`` (R,) -> (rows, F): ``out[b] = sum of ct[r]`` over the rays
    with ``idx[r] == b``, in the fixed order of the module docstring;
    ids outside [0, rows) are dropped.  Kernel J for CUDA tensors, the
    plain version for CPU tensors."""
    _check(idx, ct, rows)
    if ct.device.type == "cpu":
        return segment_accum_rows_plain(idx, ct, rows)
    if rows == 0 or ct.shape[1] == 0:
        return torch.empty(rows, ct.shape[1], dtype=torch.float32,
                           device=ct.device)
    return segment_accum_planned(ct, segment_plan(idx, rows), rows)


def segment_accum_planned(ct: torch.Tensor, plan, rows: int) -> torch.Tensor:
    """Kernel J on a CUDA ``ct`` (R, F) and the ``segment_plan`` of its
    ids -> (rows, F)."""
    perm, bounds, cstart, max_chunks = plan
    f = ct.shape[1]
    dev = ct.device
    out = torch.empty(rows, f, dtype=torch.float32, device=dev)
    partial = torch.empty(max_chunks, f, dtype=torch.float32, device=dev)
    ct = ct.detach().contiguous()  # (R, F) row-major: a lane reads a row
    from ._native import load

    lib = load("segment_accum")

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    err = lib.rt_segment_accum(
        ptr(ct), ptr(perm), ptr(bounds), ptr(cstart), rows, f, max_chunks,
        ptr(partial), ptr(out),
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
