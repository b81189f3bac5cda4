"""The collectives of data- and sequence-parallel training, over
``torch.distributed`` process groups.

- :func:`gather_frames`: the differentiable all-gather of K / V along the
  frame axis (sequence parallelism).  Its backward reduce-scatters each
  rank's full-length gradient to the owners of the frames, summing: the
  transpose of the gather, as JAX's ``all_gather`` transposes to
  ``psum_scatter``.
- :func:`all_reduce_sum`: a summed all-reduce (loss sums and counts).
- :func:`all_reduce_flat_`: the gradients' all-reduce, one flat fp32 bucket
  in a fixed order, so every rank issues the same collective and gets the
  same sums bit for bit.
- :func:`copy_to_model` / :func:`reduce_from_model`: the two conjugate
  operators of Megatron-style tensor parallelism over the ``model`` group.
  ``copy_to_model`` (the identity forward, a summed all-reduce backward)
  goes at the input of every column-parallel product, ``reduce_from_model``
  (a summed all-reduce forward, the identity backward) at the output of
  every row-parallel product and vocab-sharded lookup.  Both reduce in fp32
  and cast back once: one rounding after the sum, and no reliance on gloo's
  bf16 reductions.

Backends.  NCCL (a card per rank) and gloo (ranks that share one card, or
the CPU) both take these collectives on the tensors' own device: gloo takes
all-gather, reduce-scatter and all-reduce on CUDA tensors (it copies them
through host memory itself).  A group of ``None`` stands for a mesh axis of
size 1: every collective on it is the identity.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_gather_frames(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in rank order
    (not differentiable: see :func:`gather_frames`)."""
    n = group_size(group)
    if n == 1:
        return x
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_frames(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Rank ``r``'s block of ``x`` along ``dim`` (``size / n`` wide), summed
    over the group."""
    n = group_size(group)
    if n == 1:
        return x
    parts = [p.contiguous() for p in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=group)
    return out


class _GatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_frames(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_frames(grad, ctx.group, ctx.dim), None, None


def gather_frames(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """All-gather ``x`` along its frame axis ``dim`` over ``group``,
    differentiably: the gradient of each rank's block is the sum of every
    rank's gradient of the gathered tensor at that block."""
    if group_size(group) == 1:
        return x
    return _GatherFrames.apply(x, group, dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (a new tensor on ``x``'s device)."""
    if group_size(group) == 1:
        return x
    buf = x.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def all_reduce_flat_(tensors: List[torch.Tensor], group) -> None:
    """In place: each tensor becomes its sum over ``group``.  The tensors
    are packed into one flat fp32 bucket on their device in list order,
    summed with one collective and unpacked into their own dtypes."""
    if group_size(group) == 1 or not tensors:
        return
    bucket = torch.empty(sum(t.numel() for t in tensors), dtype=torch.float32,
                         device=tensors[0].device)
    offsets: List[int] = []
    o = 0
    for t in tensors:
        bucket[o:o + t.numel()].copy_(t.reshape(-1))
        offsets.append(o)
        o += t.numel()
    dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=group)
    for t, o in zip(tensors, offsets):
        t.copy_(bucket[o:o + t.numel()].view(t.shape))


def _all_reduce_fp32(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in fp32, cast back to ``x``'s dtype (a new
    tensor).  Every rank of the group gets the same bits."""
    if x.numel() == 0:  # the group's ranks share their shapes: all skip
        return x.clone()
    buf = x.detach().to(torch.float32, copy=True).contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_fp32(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_fp32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient is summed over ``group`` (the input of
    a column-parallel product, whose ranks each give the gradient of their
    own columns)."""
    if group_size(group) == 1:
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (the partial sums of a row-parallel
    product, or the rows of a vocab-sharded lookup); its gradient passes
    through unchanged."""
    if group_size(group) == 1:
        return x
    return _ReduceFromModel.apply(x, group)
