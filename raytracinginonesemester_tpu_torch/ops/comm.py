"""The collectives of the sharded paths, over one process group each.

A group of ``None`` is a group of one rank that needs no process group
(a single-process run): every collective is then the identity.

PyTorch's gloo backend reduces and broadcasts CUDA tensors, but gathers
and exchanges CPU tensors only; ranks that share one card must use gloo,
since NCCL refuses two ranks on one device.  So every collective here
stages a CUDA tensor through host memory when its group's backend is
gloo, chosen by the backend (never by catching a failure), and runs on
the tensor's own device otherwise (NCCL on the card, gloo on the CPU).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["size", "rank", "all_gather", "all_reduce", "all_to_all",
           "broadcast", "gather_rows"]


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    """This process's index in ``group`` (0 for ``None``)."""
    return 0 if group is None else dist.get_rank(group)


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _run(fn, x: torch.Tensor, group, shape):
    """``fn(out, src)`` on the collective's device -> ``out`` (``shape``)
    on ``x``'s device."""
    staged = _staged(x, group)
    src = (x.cpu() if staged else x).contiguous()
    out = torch.empty(shape, dtype=x.dtype, device=src.device)
    fn(out, src)
    return out.to(x.device) if staged else out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(S, *x.shape): every rank's ``x`` (at least 1-d), in group-rank
    order."""
    if group is None:
        return x[None]
    s = size(group)
    out = _run(lambda out, src: dist.all_gather_into_tensor(
        out, src, group=group), x, group,
        (s * x.shape[0],) + tuple(x.shape[1:]))
    return out.reshape((s,) + tuple(x.shape))


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``x`` reduced by ``op`` over the group."""
    if group is None:
        return x.clone()

    def reduce(out, src):
        out.copy_(src)
        dist.all_reduce(out, op=op, group=group)

    return _run(reduce, x, group, tuple(x.shape))


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Exchange of equal slices: ``x`` (S * n, ...) is split along dim 0,
    slice j goes to group rank j, and slice j of the result came from
    group rank j."""
    if group is None:
        return x
    return _run(lambda out, src: dist.all_to_all_single(out, src, group=group),
                x, group, tuple(x.shape))


def broadcast(x: torch.Tensor, group) -> torch.Tensor:
    """Group rank 0's ``x`` on every rank (a new tensor)."""
    if group is None:
        return x.clone()
    src_rank = dist.get_global_rank(group, 0)

    def bcast(out, src):
        out.copy_(src)
        dist.broadcast(out, src_rank, group=group)

    return _run(bcast, x, group, tuple(x.shape))


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 whose gradient is this rank's rows of the
    incoming gradient: every rank computes the same function of the
    gathered tensor, so its own rows' share of the gradient is that
    slice (the transpose of ``shard_map``'s gathered output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return all_gather(x, group).reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        r = rank(ctx.group)
        return grad[r * ctx.n:(r + 1) * ctx.n], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (n, ...) concatenated in group-rank order ->
    (S * n, ...), differentiable (``_GatherRows``)."""
    if group is None:
        return x
    return _GatherRows.apply(x, group)
