"""Ring attention: context parallelism over the ``cp`` mesh axis
(counterpart of scaletorch_tpu/ops/ring_attention.py).

Each rank holds its sequence shard of q, k, v ``[B, H, S/cp, D]``. The
K/V blocks circulate the cp ring (rank r sends to r+1 and receives from
r-1) by ``torch.distributed.batch_isend_irecv`` on the cp group; each
ring step computes one block of attention and merges it into a running
``(out, lse)`` pair by the reference's LSE recurrence (``_merge``). As
the reference's ``ppermute`` does, the exchange runs **at every step on
every rank**; a skipped block skips only the compute (a rank that
skipped its sends would stall its neighbours). The forward posts the
next step's exchange before it computes the current block, so the
transfer overlaps the block.

Blocks go through the flash kernels: K1 (``ops/flash.flash_forward_
with_lse``) forward, K2/K3 (``flash_block_backward``) backward, on a CUDA
tensor, and their plain versions on a CPU tensor. The backward
re-circulates K/V with the fp32 dK/dV accumulators: the flash identity
makes one block's gradients against the GLOBAL lse that block's additive
contribution, and after cp rotations (one more than the forward's) each
accumulator is home with every rank's part. GQA: K/V travel unexpanded.

Two sequence layouts (the trainer permutes the host batch for zigzag,
``parallel/zigzag.py``):

  * ``contiguous``: rank r holds tokens [r·S/cp, (r+1)·S/cp). Query shard
    r never attends key shard j > r, so those steps skip their compute;
    rank r computes r+1 blocks.
  * ``zigzag``: the sequence is cut into 2·cp stripes and rank r holds
    stripes r and 2cp-1-r. Every step then costs two stripe-pairs on
    every rank: the diagonal step three half blocks (low×low and
    high×high causal, high×low full), a block from an older rank (j < r)
    the whole query shard against its low stripe (Sq = S/cp, Skv =
    S/2cp), a newer one (j > r) the high query stripe against its whole
    shard (Sq = S/2cp, Skv = S/cp).

The ring runs as one dispatcher op, ``scaletorch_tpu_torch::
ring_attention`` (``RING_ATTENTION_OP``, with its VJP), so a selective
remat policy keeps or recomputes it whole (``models/llama.py``:
``save_attn`` keeps its ``(out, lse)``; the dots policies re-run it, its
exchanges in order), never a part of its exchanges.

Registered backends: ``ring`` and ``ring_contiguous`` (the contiguous
layout) and ``ring_zigzag``. The axis names the cp axis of the
current ``parallel.mesh.MeshManager`` (the train step installs its own,
``using_mesh_manager``).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from scaletorch_tpu_torch.models.registry import register_attention_backend
# looked up at call time: ops/flash imports models, whose __init__
# imports this module
from scaletorch_tpu_torch.ops import flash as _flash
from scaletorch_tpu_torch.parallel.mesh import current_mesh_manager

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class _Ring:
    group: object  # the cp process group (None: one rank)
    send: int      # global rank of the next rank on the ring
    recv: int      # global rank of the previous one
    size: int
    rank: int      # this rank's cp coordinate


def _ring_of(axis: str) -> _Ring:
    """The cp ring of the current mesh manager."""
    mm = current_mesh_manager()
    if axis != "cp":
        raise ValueError(f"ring attention runs over the 'cp' axis, not "
                         f"{axis!r}")
    send, recv = mm.cp_ring_peers()
    return _Ring(mm.group("cp"), send, recv, mm.cp, mm.axis_rank("cp"))


def _start(ring: _Ring, tensors: Sequence[Tensor]):
    """Post the sends of ``tensors`` to the next rank and the receives of
    the previous rank's into fresh buffers."""
    recv = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, recv):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), ring.send,
                              ring.group))
        ops.append(dist.P2POp(dist.irecv, r, ring.recv, ring.group))
    return dist.batch_isend_irecv(ops), recv


def _finish(pending) -> list:
    reqs, recv = pending
    for req in reqs:
        req.wait()
    return recv


def _exchange(ring: _Ring, tensors: Sequence[Tensor]) -> list:
    return _finish(_start(ring, tensors))


def _fwd_block(q, k, v, scale: float, causal: bool) -> Tuple[Tensor, Tensor]:
    """One block through K1: (normalised out fp32, lse fp32)."""
    o, lse = _flash.flash_forward_with_lse(q, k, v, causal=causal,
                                           scale=scale)
    return o.float(), lse


def _bwd_block(q, k, v, out, lse, dout, scale: float, causal: bool):
    """One block's (dq, dk, dv) through K2/K3 against the global lse, in
    fp32; dk/dv unexpanded."""
    dq, dk, dv = _flash.flash_block_backward(q, k, v, out, lse, dout,
                                             causal=causal, scale=scale)
    return dq.float(), dk.float(), dv.float()


def _merge(o1, lse1, o2, lse2):
    """Merge two normalised partial results (fp32)."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    lsum = w1 + w2
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / lsum[..., None]
    return o, m + torch.log(lsum)


def _ring_forward(q, k, v, ring: _Ring, scale: float):
    """Contiguous layout -> (out in q's dtype, lse fp32 [B, H, S/cp])."""
    cp, r = ring.size, ring.rank
    cur = (k, v)
    pending = _start(ring, cur) if cp > 1 else None
    # the diagonal block, causal: every query row sees itself
    o, lse = _fwd_block(q, k, v, scale, causal=True)
    for t in range(1, cp):
        cur = _finish(pending)
        pending = _start(ring, cur) if t < cp - 1 else None
        if (r - t) % cp < r:  # origin rank j < r: keys before ours
            o2, lse2 = _fwd_block(q, cur[0], cur[1], scale, causal=False)
            o, lse = _merge(o, lse, o2, lse2)
    return o.to(q.dtype), lse


def _ring_forward_zigzag(q, k, v, ring: _Ring, scale: float):
    """Zigzag layout: local shards are [low stripe; high stripe]."""
    cp, r = ring.size, ring.rank
    sh = q.shape[2] // 2
    ql, qh = q[:, :, :sh], q[:, :, sh:]
    cur = (k, v)
    pending = _start(ring, cur) if cp > 1 else None
    kl, kh, vl, vh = k[:, :, :sh], k[:, :, sh:], v[:, :, :sh], v[:, :, sh:]
    o_l, lse_l = _fwd_block(ql, kl, vl, scale, causal=True)
    o_hh, lse_hh = _fwd_block(qh, kh, vh, scale, causal=True)
    o_hl, lse_hl = _fwd_block(qh, kl, vl, scale, causal=False)
    o_h, lse_h = _merge(o_hh, lse_hh, o_hl, lse_hl)
    o = torch.cat([o_l, o_h], dim=2)
    lse = torch.cat([lse_l, lse_h], dim=2)
    for t in range(1, cp):
        k_blk, v_blk = _finish(pending)
        pending = _start(ring, (k_blk, v_blk)) if t < cp - 1 else None
        if (r - t) % cp < r:
            # older: [ql; qh] attend the block's low stripe, fully
            o2, lse2 = _fwd_block(q, k_blk[:, :, :sh], v_blk[:, :, :sh],
                                  scale, causal=False)
            o, lse = _merge(o, lse, o2, lse2)
        else:
            # newer: only qh attends, to both of the block's stripes (the
            # low query rows' merge with nothing is the identity)
            o2h, lse2h = _fwd_block(qh, k_blk, v_blk, scale, causal=False)
            o[:, :, sh:], lse[:, :, sh:] = _merge(
                o[:, :, sh:], lse[:, :, sh:], o2h, lse2h)
    return o.to(q.dtype), lse


def _ring_backward(q, k, v, out, lse, dout, ring: _Ring, scale: float):
    cp, r = ring.size, ring.rank
    dq, dk_acc, dv_acc = _bwd_block(q, k, v, out, lse, dout, scale,
                                    causal=True)
    k_blk, v_blk = k, v
    for t in range(1, cp):
        k_blk, v_blk, dk_acc, dv_acc = _exchange(
            ring, (k_blk, v_blk, dk_acc, dv_acc))
        if (r - t) % cp < r:
            dq_c, dk_c, dv_c = _bwd_block(q, k_blk, v_blk, out, lse, dout,
                                          scale, causal=False)
            dq += dq_c
            dk_acc += dk_c
            dv_acc += dv_c
    if cp > 1:  # one more rotation brings every accumulator home
        dk_acc, dv_acc = _exchange(ring, (dk_acc, dv_acc))
    return dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


def _ring_backward_zigzag(q, k, v, out, lse, dout, ring: _Ring,
                          scale: float):
    """The zigzag schedule mirrored: the dk/dv accumulator travels with
    its K/V block in the origin rank's [low; high] layout and takes each
    step's contribution into the stripes that step attended."""
    cp, r = ring.size, ring.rank
    sh = q.shape[2] // 2
    ql, qh = q[:, :, :sh], q[:, :, sh:]
    kl, kh, vl, vh = k[:, :, :sh], k[:, :, sh:], v[:, :, :sh], v[:, :, sh:]
    out_l, out_h = out[:, :, :sh], out[:, :, sh:]
    do_l, do_h = dout[:, :, :sh], dout[:, :, sh:]
    lse_l, lse_h = lse[:, :, :sh], lse[:, :, sh:]
    dql, dkl, dvl = _bwd_block(ql, kl, vl, out_l, lse_l, do_l, scale, True)
    dqh, dkh, dvh = _bwd_block(qh, kh, vh, out_h, lse_h, do_h, scale, True)
    dqh2, dkl2, dvl2 = _bwd_block(qh, kl, vl, out_h, lse_h, do_h, scale,
                                  False)
    dq = torch.cat([dql, dqh + dqh2], dim=2)
    dk_acc = torch.cat([dkl + dkl2, dkh], dim=2)
    dv_acc = torch.cat([dvl + dvl2, dvh], dim=2)
    k_blk, v_blk = k, v
    for t in range(1, cp):
        k_blk, v_blk, dk_acc, dv_acc = _exchange(
            ring, (k_blk, v_blk, dk_acc, dv_acc))
        if (r - t) % cp < r:
            dq_c, dk_c, dv_c = _bwd_block(
                q, k_blk[:, :, :sh], v_blk[:, :, :sh], out, lse, dout,
                scale, False)
            dq += dq_c
            dk_acc[:, :, :sh] += dk_c
            dv_acc[:, :, :sh] += dv_c
        else:
            dq_c, dk_c, dv_c = _bwd_block(qh, k_blk, v_blk, out_h, lse_h,
                                          do_h, scale, False)
            dq[:, :, sh:] += dq_c
            dk_acc += dk_c
            dv_acc += dv_c
    if cp > 1:
        dk_acc, dv_acc = _exchange(ring, (dk_acc, dv_acc))
    return dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


@torch.library.custom_op("scaletorch_tpu_torch::ring_attention",
                         mutates_args=())
def _ring_attention_op(q: Tensor, k: Tensor, v: Tensor, scale: float,
                       layout: str) -> Tuple[Tensor, Tensor]:
    """The whole ring forward as ONE dispatcher op: (out in q's dtype,
    lse fp32). A selective-checkpoint policy sees this op and none of the
    exchanges and K1 calls inside it, so it keeps or recomputes the ring
    whole: ``save_attn`` keeps (out, lse) and the recomputation skips the
    ring; another policy re-runs it, its exchanges re-issued in order on
    every rank. The ring is the current mesh manager's."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    fwd = _ring_forward_zigzag if layout == "zigzag" else _ring_forward
    return fwd(q, k, v, _ring_of("cp"), scale)


@_ring_attention_op.register_fake
def _ring_attention_fake(q: Tensor, k: Tensor, v: Tensor, scale: float,
                         layout: str) -> Tuple[Tensor, Tensor]:
    return (torch.empty_like(q),
            q.new_empty(q.shape[:3], dtype=torch.float32))


def _ring_setup(ctx, inputs, output) -> None:
    q, k, v, scale, layout = inputs
    out, lse = output
    ctx.save_for_backward(q.contiguous(), k.contiguous(), v.contiguous(),
                          out, lse)
    ctx.ring, ctx.scale, ctx.layout = _ring_of("cp"), scale, layout


def _ring_vjp(ctx, dout, dlse):
    """The dual K/V + dK/dV ring (``lse`` is an output no caller
    differentiates)."""
    q, k, v, out, lse = ctx.saved_tensors
    bwd = (_ring_backward_zigzag if ctx.layout == "zigzag"
           else _ring_backward)
    dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(), ctx.ring,
                     ctx.scale)
    return dq, dk, dv, None, None


_ring_attention_op.register_autograd(_ring_vjp, setup_context=_ring_setup)
RING_ATTENTION_OP = torch.ops.scaletorch_tpu_torch.ring_attention.default


def _check_layout(layout: str, causal: bool, seq_local: int) -> None:
    if not causal:
        raise NotImplementedError("ring attention is causal-only")
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown cp layout {layout!r}")
    if layout == "zigzag" and seq_local % 2:
        raise ValueError(
            f"zigzag layout needs an even local sequence, got {seq_local}")


def ring_attention(q: Tensor, k: Tensor, v: Tensor, axis: str = "cp",
                   causal: bool = True, scale: Optional[float] = None,
                   layout: str = "contiguous") -> Tensor:
    """Ring attention over the cp axis of the current mesh manager. q
    [B, Hq, S/cp, D]; k, v [B, Hkv, S/cp, D] (this rank's shards); causal
    only, as the reference's."""
    _check_layout(layout, causal, q.shape[2])
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"query heads {q.shape[1]} not a multiple of kv heads "
            f"{k.shape[1]}")
    if axis != "cp":
        raise ValueError(f"ring attention runs over the 'cp' axis, not "
                         f"{axis!r}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out, _ = RING_ATTENTION_OP(q, k, v, float(scale), layout)
    return out


def ring_attention_backend(q, k, v, *, layout: str, causal: bool = True,
                           scale: Optional[float] = None, axis: str = "cp"):
    """A registry entry: model code calls a backend as
    ``fn(q, k, v, causal=, scale=)``, so each entry fixes its layout."""
    return ring_attention(q, k, v, axis, causal, scale, layout)


def _backend(layout: str):
    fn = partial(ring_attention_backend, layout=layout)
    # the ring's own op holds (out, lse): save_attn keeps it, no copy
    fn.saves_attn_residuals = True
    return fn


register_attention_backend("ring", _backend("contiguous"))
register_attention_backend("ring_contiguous", _backend("contiguous"))
register_attention_backend("ring_zigzag", _backend("zigzag"))
