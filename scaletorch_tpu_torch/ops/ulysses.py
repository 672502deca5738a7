"""Ulysses context parallelism: the heads <-> sequence all-to-all
(counterpart of scaletorch_tpu/ops/ulysses.py).

Two all-to-alls on the cp group swap the sharded axis: sequence-sharded
``[B, H, S/cp, D]`` becomes head-sharded ``[B, H/cp, S, D]``, each rank
runs one full-sequence causal ``flash_attention`` (K1-K3 on the card,
their plain versions on the CPU) over its heads, and the inverse
exchange brings the output back to sequence shards. Every rank owns
whole heads, so the causal work is balanced in the contiguous layout
(the trainer does not permute the batch for it). cp must divide both
head counts. The three steps run as one dispatcher op,
``scaletorch_tpu_torch::ulysses_attention`` (``ULYSSES_ATTENTION_OP``,
whose VJP takes dO to the heads, runs K2/K3 and brings dQ, dK, dV back
by the inverse all-to-all), so a selective remat policy keeps or
recomputes them together.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def _ulysses_group(cp: int):
    return current_mesh_manager().group("cp") if cp > 1 else None


@torch.library.custom_op("scaletorch_tpu_torch::ulysses_attention",
                         mutates_args=())
def _ulysses_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                scale: float) -> Tuple[Tensor, Tensor, Tensor, Tensor,
                                       Tensor, Tensor]:
    """The exchange, K1 and the inverse exchange as ONE dispatcher op:
    (out, and the backward's residuals qh, kh, vh, out_h, lse on this
    rank's heads). A selective-checkpoint policy sees this op and none of
    the all-to-alls and K1 inside it, so it keeps or recomputes them
    together (``save_attn`` keeps them; another policy re-runs all three
    in order on every rank)."""
    group = _ulysses_group(current_mesh_manager().cp)
    qh, kh, vh = (_all_to_all(t, group, 1, 2) for t in (q, k, v))
    oh, lse = _flash.flash_forward(qh, kh, vh, causal=causal, scale=scale)
    return _all_to_all(oh, group, 2, 1), qh, kh, vh, oh, lse


@_ulysses_op.register_fake
def _ulysses_fake(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                  scale: float):
    cp = current_mesh_manager().cp
    b, hq, s, d = q.shape
    qh = q.new_empty(b, hq // cp, s * cp, d)
    kh = k.new_empty(b, k.shape[1] // cp, s * cp, d)
    return (torch.empty_like(q), qh, kh, torch.empty_like(kh),
            torch.empty_like(qh),
            q.new_empty(b, hq // cp, s * cp, dtype=torch.float32))


def _ulysses_setup(ctx, inputs, output) -> None:
    _, qh, kh, vh, oh, lse = output
    ctx.save_for_backward(qh, kh, vh, oh, lse)
    ctx.causal, ctx.scale = inputs[3], inputs[4]
    ctx.group = _ulysses_group(current_mesh_manager().cp)


def _ulysses_vjp(ctx, dout, *_residual_grads):
    """dO to this rank's heads, K2/K3, and dQ, dK, dV back to the
    sequence shards (the residual outputs are never differentiated)."""
    qh, kh, vh, oh, lse = ctx.saved_tensors
    group = ctx.group
    doh = _all_to_all(dout, group, 1, 2)
    dqh, dkh, dvh = _flash.flash_block_backward(
        qh, kh, vh, oh, lse, doh, causal=ctx.causal, scale=ctx.scale)
    return (*(_all_to_all(t, group, 2, 1) for t in (dqh, dkh, dvh)),
            None, None)


_ulysses_op.register_autograd(_ulysses_vjp, setup_context=_ulysses_setup)
ULYSSES_ATTENTION_OP = torch.ops.scaletorch_tpu_torch.ulysses_attention.default


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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return ULYSSES_ATTENTION_OP(q, k, v, bool(causal), float(scale))[0]


# the op holds the backward's residuals: save_attn keeps it, no copy
ulysses_attention.saves_attn_residuals = True
register_attention_backend("ulysses", ulysses_attention)
