"""Ulysses context parallelism: the heads <-> sequence all-to-all
(counterpart of scaletorch_tpu/ops/ulysses.py).

Two all-to-alls on the cp group swap the sharded axis: sequence-sharded
``[B, H, S/cp, D]`` becomes head-sharded ``[B, H/cp, S, D]``, each rank
runs one full-sequence causal ``flash_attention`` (K1-K3 on the card,
their plain versions on the CPU) over its heads, and the inverse
exchange brings the output back to sequence shards. Every rank owns
whole heads, so the causal work is balanced in the contiguous layout
(the trainer does not permute the batch for it). cp must divide both
head counts. The exchange is a ``torch.autograd.Function`` whose
backward is the inverse all-to-all.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from scaletorch_tpu_torch.models.registry import register_attention_backend
from scaletorch_tpu_torch.ops import flash as _flash
from scaletorch_tpu_torch.parallel.mesh import current_mesh_manager

Tensor = torch.Tensor


def _all_to_all(x: Tensor, group, split_dim: int, concat_dim: int) -> Tensor:
    """Chunk i of ``x`` along ``split_dim`` goes to rank i; the chunks
    received are concatenated along ``concat_dim`` in rank order."""
    world = dist.get_world_size(group)
    send = [c.contiguous() for c in x.chunk(world, dim=split_dim)]
    recv = [torch.empty_like(c) for c in send]
    dist.all_to_all(recv, send, group=group)
    return torch.cat(recv, dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return (_all_to_all(grad, ctx.group, ctx.concat_dim, ctx.split_dim),
                None, None, None)


def ulysses_attention(q: Tensor, k: Tensor, v: Tensor, *,
                      causal: bool = True, scale: Optional[float] = None,
                      axis: str = "cp") -> Tensor:
    """q [B, Hq, S/cp, D]; k, v [B, Hkv, S/cp, D]: this rank's sequence
    shards in the contiguous layout, over the cp axis of the current mesh
    manager. Requires Hq % cp == Hkv % cp == 0."""
    if axis != "cp":
        raise ValueError(f"ulysses runs over the 'cp' axis, not {axis!r}")
    mm = current_mesh_manager()
    cp = mm.cp
    hq, hkv = q.shape[1], k.shape[1]
    if hq % cp or hkv % cp:
        raise ValueError(
            f"ulysses needs cp ({cp}) to divide both query heads ({hq}) and "
            f"kv heads ({hkv}); use the 'ring' backend for higher cp")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if cp == 1:
        return _flash.flash_attention(q, k, v, causal=causal, scale=scale)
    group = mm.group("cp")
    qh, kh, vh = (_AllToAll.apply(t, group, 1, 2) for t in (q, k, v))
    o = _flash.flash_attention(qh, kh, vh, causal=causal, scale=scale)
    return _AllToAll.apply(o, group, 2, 1)


register_attention_backend("ulysses", ulysses_attention)
