"""Megatron-style sequence parallelism over the tp group (counterpart of
scaletorch_tpu/parallel/sequence_parallel.py).

SP shards the norm and residual regions of a decoder along the sequence
(dim 1 of ``[B, S, H]``), so their activations and the RMSNorm math are
1/tp-sized; attention and the MLP still see the whole sequence. The two
region functions are ``torch.autograd.Function``s whose backward is the
other collective, as the reference's JAX transposes are:

  * ``all_gather_sequence``: all-gather forward, reduce-scatter backward;
  * ``reduce_scatter_sequence``: reduce-scatter forward, all-gather
    backward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from scaletorch_tpu_torch.parallel.mesh import (
    all_gather_cat,
    axis_group,
    group_size,
)

Tensor = torch.Tensor


def _reduce_scatter(x: Tensor, group, dim: int) -> Tensor:
    world = group_size(group)
    if world == 1:
        return x
    if x.shape[dim] % world:
        raise ValueError(
            f"dim {dim} of size {x.shape[dim]} does not split over {world} "
            "ranks")
    parts = [p.contiguous() for p in x.chunk(world, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


class _AllGatherSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.group, ctx.dim), None, None


class _ReduceScatterSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad, ctx.group, ctx.dim), None, None


def all_gather_sequence(x: Tensor, axis: Optional[str] = "tp",
                        seq_dim: int = 1) -> Tensor:
    """Enter a full-sequence region: [B, S/tp, H] -> [B, S, H]."""
    return _AllGatherSequence.apply(x, axis_group(axis), seq_dim)


def reduce_scatter_sequence(x: Tensor, axis: Optional[str] = "tp",
                            seq_dim: int = 1) -> Tensor:
    """Leave a full-sequence region: [B, S, H] (tp-partial sums) ->
    [B, S/tp, H], summed over the group."""
    return _ReduceScatterSequence.apply(x, axis_group(axis), seq_dim)
