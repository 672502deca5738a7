"""Pipeline parallelism over the pp axis (counterpart of
scaletorch_tpu/parallel/pipeline_parallel.py).

The reference is SPMD: every stage ticks in lockstep, computes on zeros in
its bubble ticks and gets its backward from autodiff of ``ppermute``.
Here, as in PyTorch's and the original ScaleTorch's pipelines, it is
MPMD: a stage runs only its live microbatches and moves activations
forward and their gradients back with ``torch.distributed.
batch_isend_irecv`` on the pp group. Bubble time is spent waiting on a
receive, not computing zeros. The reference's definitions are kept:

  * the schedule is the reference's tick schedule (``tick_plan``): at
    tick t, rank r runs microbatch ``mb`` of its local chunk ``c`` when
    that slot is live; every rank walks every tick and, after it, posts
    in ONE ``batch_isend_irecv`` the send of its output and the receive
    of its next input, so the posts of two neighbours always match;
  * the backward walks the ticks in reverse: each live slot runs
    ``torch.autograd.backward`` from the gradient the next stage sent
    (or from the loss on the last one) and sends its input's gradient
    back;
  * the loss is the mean over M microbatches of the last stage's CE, plus
    each stage's aux loss over its live ticks only (MoE); the routing
    statistics are the sum over live slots and stages divided by
    M·vpp·pp;
  * ``afab`` is one pass over all M microbatches (vpp 1, the chain);
    ``memory_chunked`` passes over chunks of pp microbatches plus a
    shorter remainder pass, recombined weighted by their microbatch
    counts (the spmd step); ``interleaved`` gives rank r the chunks r,
    pp + r, ... of the layers in interleaved storage order
    (``interleave_stacked_params``) and circulates each microbatch vpp
    times round the ring;
  * uneven layer counts use identity padding slots
    (``pad_stacked_params``; the stage runs only its ``active`` slots).

The positions travel with the activation, as in the reference (RoPE
needs the microbatch's positions at every stage). Under gradient
checkpointing a stage's layers are checkpointed as on one card; the
point-to-point calls stay outside every checkpointed region, so a
recomputation never re-issues one.

The arithmetic (partitions, padding, the interleave order, tick
accounting) is the reference's, over torch tensors or numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from scaletorch_tpu_torch.parallel.mesh import MeshManager, all_reduce_

Tensor = torch.Tensor

# the scalar routing statistics a MoE stage reports
MOE_PIPELINE_STATS: Tuple[str, ...] = ("moe_dropped_fraction", "moe_load_cv")
PP_ENGINES = ("afab", "memory_chunked", "interleaved")


# ---- the arithmetic -------------------------------------------------------------
def stage_layer_partition(
    num_layers: int,
    pp_size: int,
    custom_distribution: Optional[Sequence[int]] = None,
) -> List[List[int]]:
    """Contiguous greedy layer split, the remainder to the EARLY stages:
    per stage, the global layer indices it owns. ``custom_distribution``
    gives the per-stage counts (summing to ``num_layers``)."""
    if num_layers < pp_size:
        raise ValueError(f"num_layers={num_layers} < pp_size={pp_size}: "
                         "every stage needs a layer")
    if custom_distribution is not None:
        counts = list(custom_distribution)
        if len(counts) != pp_size:
            raise ValueError(f"custom_distribution has {len(counts)} "
                             f"entries, expected {pp_size}")
        if any(c < 1 for c in counts):
            raise ValueError("every stage must get >= 1 layer")
        if sum(counts) != num_layers:
            raise ValueError(f"custom_distribution sums to {sum(counts)}, "
                             f"expected {num_layers}")
    else:
        base, rem = divmod(num_layers, pp_size)
        counts = [base + (1 if s < rem else 0) for s in range(pp_size)]
    out, start = [], 0
    for c in counts:
        out.append(list(range(start, start + c)))
        start += c
    return out


def validate_pp_divisibility(cfg, pp: int) -> None:
    """The stacked layer axis splits evenly over pp."""
    if cfg.num_hidden_layers % pp != 0:
        raise ValueError(
            f"num_hidden_layers={cfg.num_hidden_layers} not divisible by "
            f"pp={pp} (use a layer count divisible by pp, or pad with "
            "identity layers)")


def padded_stage_counts(num_layers: int, pp: int) -> Tuple[List[int], int]:
    """(real layers per stage, slots per stage): the stacked axis is
    padded to pp·slots, each stage's trailing slots identity padding."""
    counts = [len(g) for g in stage_layer_partition(num_layers, pp)]
    return counts, max(counts)


def _cat(blocks: List[Any]) -> Any:
    if isinstance(blocks[0], torch.Tensor):
        return torch.cat(blocks, 0)
    return np.concatenate(blocks, 0)


def _zeros_like_rows(w: Any, rows: int) -> Any:
    if isinstance(w, torch.Tensor):
        return w.new_zeros((rows,) + tuple(w.shape[1:]))
    return np.zeros((rows,) + w.shape[1:], w.dtype)


def _take(w: Any, idx: Sequence[int]) -> Any:
    if isinstance(w, torch.Tensor):
        return w[torch.as_tensor(list(idx), device=w.device)]
    return w[np.asarray(idx)]


def _map_layers(layers: Dict[str, Any], fn: Callable) -> Dict[str, Any]:
    return {k: fn(v) for k, v in layers.items()}


def pad_leaf(w: Any, num_layers: int, pp: int) -> Any:
    """One stacked [L, ...] leaf re-blocked into [pp·slots, ...]: stage s's
    block holds its real layers followed by zero padding."""
    counts, slots = padded_stage_counts(num_layers, pp)
    if slots * pp == num_layers:
        return w
    blocks, start = [], 0
    for c in counts:
        blocks.append(w[start:start + c])
        if c < slots:
            blocks.append(_zeros_like_rows(w, slots - c))
        start += c
    return _cat(blocks)


def pad_stacked_params(layers: Dict[str, Any], num_layers: int, pp: int
                       ) -> Dict[str, Any]:
    """Every stacked leaf through ``pad_leaf`` (uneven layer counts: the
    zero padding never trains, its slots are never run)."""
    return _map_layers(layers, lambda w: pad_leaf(w, num_layers, pp))


def unpad_stacked_params(layers: Dict[str, Any], num_layers: int, pp: int
                         ) -> Dict[str, Any]:
    """Inverse of ``pad_stacked_params``: the true layer order."""
    counts, slots = padded_stage_counts(num_layers, pp)
    if slots * pp == num_layers:
        return layers
    keep: List[int] = []
    for s, c in enumerate(counts):
        keep.extend(range(s * slots, s * slots + c))
    return _map_layers(layers, lambda w: _take(w, keep))


def validate_interleaved_divisibility(num_layers: int, pp: int, vpp: int
                                      ) -> None:
    """Each rank's layer shard splits into vpp even chunks."""
    if vpp < 2:
        raise ValueError(
            f"pp_virtual_stages must be >= 2 for the interleaved engine, "
            f"got {vpp} (vpp=1 is exactly the afab schedule: use "
            "pp_engine='afab')")
    if num_layers % (pp * vpp) != 0:
        raise ValueError(
            f"num_hidden_layers={num_layers} not divisible by pp*vpp="
            f"{pp}*{vpp}={pp * vpp}: the interleaved engine needs even "
            "virtual-stage chunks (pick a layer count divisible by pp*vpp "
            "or reduce pp_virtual_stages)")


def suggest_virtual_stages(num_layers: int, pp: int, max_vpp: int = 4) -> int:
    """Largest vpp in [2, max_vpp] dividing the per-rank layer count (1
    when none does)."""
    if pp < 2 or num_layers % pp != 0:
        return 1
    per_rank = num_layers // pp
    for v in range(min(max_vpp, per_rank), 1, -1):
        if per_rank % v == 0:
            return v
    return 1


def _interleaved_layer_order(num_layers: int, pp: int, vpp: int
                             ) -> List[int]:
    """Global layer indices in rank-major interleaved storage order: rank
    r's shard = [chunk 0 | chunk 1 | ...], chunk c the layers of virtual
    stage c·pp + r."""
    lc = num_layers // (pp * vpp)
    order: List[int] = []
    for r in range(pp):
        for c in range(vpp):
            v = c * pp + r
            order.extend(range(v * lc, (v + 1) * lc))
    return order


def _check_uniform_stack(layers: Dict[str, Any], num_layers: int) -> None:
    for w in layers.values():
        if w.shape[0] != num_layers:
            raise ValueError(
                f"interleaved pipeline needs uniformly stacked layers (every "
                f"leaf's leading dim == num_hidden_layers={num_layers}, got "
                f"{w.shape[0]}); use 'afab' for a dense/sparse mix")


def interleave_stacked_params(layers: Dict[str, Any], num_layers: int,
                              pp: int, vpp: int) -> Dict[str, Any]:
    """The stacked leaves in interleaved storage order, so the plain
    leading-axis split hands rank r its vpp chunks back to back."""
    validate_interleaved_divisibility(num_layers, pp, vpp)
    _check_uniform_stack(layers, num_layers)
    order = _interleaved_layer_order(num_layers, pp, vpp)
    return _map_layers(layers, lambda w: _take(w, order))


def deinterleave_stacked_params(layers: Dict[str, Any], num_layers: int,
                                pp: int, vpp: int) -> Dict[str, Any]:
    """Inverse of ``interleave_stacked_params``."""
    validate_interleaved_divisibility(num_layers, pp, vpp)
    _check_uniform_stack(layers, num_layers)
    inv = np.argsort(np.asarray(_interleaved_layer_order(num_layers, pp,
                                                         vpp)))
    return _map_layers(layers, lambda w: _take(w, inv.tolist()))


def interleaved_finish_ticks(m: int, pp: int, vpp: int) -> List[int]:
    """The tick at which microbatch i's final chunk (virtual stage
    vpp·pp - 1, on rank pp - 1) completes; cohorts of pp microbatches
    enter the ring every pp·vpp ticks."""
    return [(pp - 1) + (i // pp) * pp * vpp + (vpp - 1) * pp + (i % pp)
            for i in range(m)]


def interleaved_tick_schedule(m: int, pp: int, vpp: int) -> Dict[str, float]:
    """The schedule's tick accounting: ticks, bubble and the step time
    relative to afab (each interleaved tick costs 1/(pp·vpp) of the
    stack, an afab tick 1/pp)."""
    ticks = interleaved_finish_ticks(m, pp, vpp)[-1] + 1
    ideal = m * vpp
    afab_ticks = m + pp - 1
    return {
        "ticks": ticks,
        "ideal_ticks": ideal,
        "bubble_ticks": ticks - ideal,
        "bubble_fraction": (ticks - ideal) / ticks,
        "afab_ticks": afab_ticks,
        "afab_bubble_fraction": (pp - 1) / afab_ticks,
        "relative_step_time": ticks / (vpp * afab_ticks),
    }


def stage_layer_layout(num_layers: int, pp: int, engine: str,
                       vpp: int = 1) -> Optional[Callable[[Any], Any]]:
    """The re-blocking of one stacked [L, ...] leaf before its pp split
    (the Trainer's order: padding for an uneven afab or memory_chunked
    split, the interleave order for ``interleaved``); None when the plain
    split is the layout."""
    if pp < 2:
        return None
    if engine == "interleaved":
        validate_interleaved_divisibility(num_layers, pp, vpp)
        order = _interleaved_layer_order(num_layers, pp, vpp)
        return lambda w: _take(w, order)
    _, slots = padded_stage_counts(num_layers, pp)
    if slots * pp == num_layers:
        return None
    return lambda w: pad_leaf(w, num_layers, pp)


def stage_layer_unlayout(num_layers: int, pp: int, engine: str,
                         vpp: int = 1) -> Optional[Callable[[Any], Any]]:
    """The inverse of ``stage_layer_layout``: one re-blocked leaf back in
    model order (None when the layout is the plain split)."""
    if stage_layer_layout(num_layers, pp, engine, vpp) is None:
        return None
    if engine == "interleaved":
        inv = np.argsort(np.asarray(_interleaved_layer_order(num_layers, pp,
                                                             vpp)))
        return lambda w: _take(w, inv.tolist())
    return lambda w: unpad_stacked_params({"w": w}, num_layers, pp)["w"]


# ---- the schedule ---------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Slot:
    """What a rank runs at one tick: microbatch ``mb`` through its local
    chunk ``chunk``; ``first`` embeds (no input from a neighbour),
    ``last`` ends in the loss (no output to one)."""

    mb: int
    chunk: int
    first: bool
    last: bool


def tick_plan(m: int, pp: int, vpp: int, rank: int) -> List[Optional[Slot]]:
    """The reference's schedule for pp rank ``rank``: per tick, its live
    slot or None. At tick t the rank is u = t - rank ticks into the ring;
    cohort u // (pp·vpp), local chunk (u mod pp·vpp) // pp, microbatch
    cohort·pp + u mod pp (afab: vpp 1, microbatch t - rank)."""
    period = pp * vpp
    ticks = interleaved_finish_ticks(m, pp, vpp)[-1] + 1
    plan: List[Optional[Slot]] = []
    for t in range(ticks):
        u = t - rank
        if u < 0:
            plan.append(None)
            continue
        w = u % period
        c = w // pp
        mb = (u // period) * pp + (w % pp)
        if mb >= m:
            plan.append(None)
            continue
        plan.append(Slot(mb=mb, chunk=c, first=rank == 0 and c == 0,
                         last=rank == pp - 1 and c == vpp - 1))
    return plan


# ---- the engine -----------------------------------------------------------------
@dataclasses.dataclass
class PipelineFns:
    """The model's pieces, the reference's protocol:

    ``embed_fn(params, ids) -> x``: the first stage's entry;
    ``stage_fn(params, x, pos, chunk) -> x`` or ``(x, aux, stats)`` (MoE,
    ``has_aux``): local chunk ``chunk`` of this rank's layers (0 for the
    chain);
    ``loss_fn(params, x, targets) -> loss``: the last stage's epilogue.
    ``carry_shape(batch_rows, seq) -> shape`` of the activation a stage
    sends (the sequence slice under SP) and ``carry_dtype`` its dtype."""

    embed_fn: Callable
    stage_fn: Callable
    loss_fn: Callable
    carry_shape: Callable[[int, int], Tuple[int, ...]]
    carry_dtype: torch.dtype
    has_aux: bool = False


class _Links:
    """This rank's neighbours on the pp ring and the one post of a tick."""

    def __init__(self, mm: MeshManager) -> None:
        self.group = mm.group("pp")
        self.next, self.prev = mm.pp_ring_peers()

    def post(self, sends: Sequence[Tuple[Tensor, int]],
             recvs: Sequence[Tuple[Tensor, int]]) -> None:
        """Post every send and receive of a tick in one
        ``batch_isend_irecv`` and wait for all of them."""
        ops = [dist.P2POp(dist.isend, t.contiguous(), peer, self.group)
               for t, peer in sends]
        ops += [dist.P2POp(dist.irecv, t, peer, self.group)
                for t, peer in recvs]
        if not ops:
            return
        for req in dist.batch_isend_irecv(ops):
            req.wait()


_warm_groups: set = set()


def warm_up_links(mm: MeshManager, device) -> None:
    """One all-reduce on the pp group, once a group, so its communicator
    exists before the first point-to-point: NCCL builds it on first use,
    and a first ``batch_isend_irecv`` that not every rank of the group
    joins is undefined. Every stage calls it at its first pass, outside
    any timed window."""
    group = mm.group("pp")
    if mm.pp > 1 and id(group) not in _warm_groups:
        all_reduce_(torch.zeros(1, device=device), group)
        _warm_groups.add(id(group))


@dataclasses.dataclass
class _Live:
    x_in: Tensor          # the slot's input (requires grad when received)
    out: Tensor           # its output, or its loss on the last slot
    aux: Optional[Tensor]


def run_pipeline(params, batch: Dict[str, Tensor], mm: MeshManager,
                 fns: PipelineFns, *, vpp: int = 1,
                 leaves: Optional[List[Tensor]] = None,
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One pass over the batch's M microbatches (``input_ids``/
    ``target_ids`` [M, B, S], ``position_ids`` [M, S]) on this stage.

    Returns (loss, stats), each the whole pipeline's (summed over the pp
    group): the mean over the microbatches of the last stage's CE plus
    every stage's live aux, and the routing statistics over M·vpp·pp
    slots. With ``leaves`` it also runs the backward, each leaf's gradient
    accumulating in its ``.grad`` (the caller reads and clears them);
    without, it runs under ``torch.no_grad()`` (eval)."""
    ids, tgt, pos = (batch["input_ids"], batch["target_ids"],
                     batch["position_ids"])
    m, b, s = ids.shape
    stage = mm.axis_rank("pp")
    plan = tick_plan(m, mm.pp, vpp, stage)
    links = _Links(mm)
    dev = ids.device
    warm_up_links(mm, dev)
    carry = fns.carry_shape(b, s)
    grad_on = leaves is not None
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    loss_sum, aux_sum = zero.clone(), zero.clone()
    stats_sum: Dict[str, Tensor] = ({k: zero.clone() for k in
                                     MOE_PIPELINE_STATS}
                                    if fns.has_aux else {})
    live: Dict[int, _Live] = {}
    inbox: Optional[Tuple[Tensor, Tensor]] = None
    with torch.set_grad_enabled(grad_on):
        for t, slot in enumerate(plan):
            if slot is not None:
                if slot.first:
                    x_in = fns.embed_fn(params, ids[slot.mb])
                    p_in = pos[slot.mb]
                else:
                    x_in, p_in = inbox
                    if grad_on:
                        x_in.requires_grad_(True)
                out = fns.stage_fn(params, x_in, p_in, slot.chunk)
                aux = None
                if fns.has_aux:
                    out, aux, stats = out
                    aux_sum = aux_sum + aux.detach().float()
                    for k in stats_sum:
                        stats_sum[k] = stats_sum[k] + stats[k].detach()
                if slot.last:
                    out = fns.loss_fn(params, out, tgt[slot.mb])
                    loss_sum = loss_sum + out.detach().float()
                if grad_on:
                    live[t] = _Live(x_in, out, aux)
                send_x, send_p = out, p_in
            inbox = None
            sends, recvs = [], []
            if slot is not None and not slot.last:
                sends += [(send_x.detach(), links.next),
                          (send_p, links.next)]
            nxt = plan[t + 1] if t + 1 < len(plan) else None
            if nxt is not None and not nxt.first:
                inbox = (torch.empty(carry, dtype=fns.carry_dtype,
                                     device=dev),
                         torch.empty(s, dtype=pos.dtype, device=dev))
                recvs += [(inbox[0], links.prev), (inbox[1], links.prev)]
            links.post(sends, recvs)
    if grad_on:
        _backward(plan, live, links, m, leaves)
    total = all_reduce_((loss_sum + aux_sum).reshape(1), links.group)[0] / m
    if stats_sum:
        keys = list(stats_sum)
        vals = all_reduce_(torch.stack([stats_sum[k] for k in keys]),
                           links.group) / (m * vpp * mm.pp)
        stats_sum = dict(zip(keys, vals.unbind(0)))
    return total, stats_sum


def _backward(plan: List[Optional[Slot]], live: Dict[int, _Live],
              links: _Links, m: int, leaves: List[Tensor]) -> None:
    """The ticks in reverse: each live slot's backward from the gradient
    its successor sent (from the loss on the last slot), seeded with 1/M
    for the loss and the aux, its input's gradient sent back."""
    inputs = list(leaves)
    inbox: Optional[Tensor] = None
    for t in range(len(plan) - 1, -1, -1):
        slot = plan[t]
        sends, recvs = [], []
        if slot is not None:
            rec = live.pop(t)
            if slot.last:
                obj = rec.out if rec.aux is None else rec.out + rec.aux
                outs, seeds = [obj / m], [None]
            else:
                outs, seeds = [rec.out], [inbox]
                if rec.aux is not None:
                    outs.append(rec.aux / m)
                    seeds.append(None)
            ins = inputs if slot.first else [rec.x_in] + inputs
            torch.autograd.backward(outs, grad_tensors=seeds, inputs=ins)
            if not slot.first:
                g = rec.x_in.grad
                if g is None:
                    g = torch.zeros_like(rec.x_in)
                sends.append((g, links.prev))
            del rec
        inbox = None
        prev = plan[t - 1] if t > 0 else None
        if prev is not None and not prev.last:
            inbox = torch.empty_like(live[t - 1].out)
            recvs.append((inbox, links.next))
        links.post(sends, recvs)


# ---- the model bindings -----------------------------------------------------------
def _stage_active_layers(num_layers: int, mm: MeshManager) -> Optional[int]:
    """This stage's real-layer count when the split is uneven, else None."""
    counts, slots = padded_stage_counts(num_layers, mm.pp)
    if slots * mm.pp == num_layers:
        return None
    return counts[mm.axis_rank("pp")]


def _bind(mm: MeshManager, cfg, stack: Callable, *, attention_backend,
          sequence_parallel: bool, vpp: int, has_aux: bool) -> PipelineFns:
    from scaletorch_tpu_torch.models import llama
    from scaletorch_tpu_torch.models.layers import get_cos_sin
    from scaletorch_tpu_torch.models.registry import get_attention_backend
    from scaletorch_tpu_torch.parallel.tensor_parallel import (
        fused_vocab_parallel_cross_entropy,
    )
    from scaletorch_tpu_torch.trainer.train_step import ce_chunk_size

    attn_fn = (attention_backend if callable(attention_backend)
               else get_attention_backend(attention_backend))
    tp = "tp" if mm.tp > 1 else None
    sp = sequence_parallel and tp is not None
    num_layers = cfg.num_hidden_layers
    if vpp > 1:
        validate_interleaved_divisibility(num_layers, mm.pp, vpp)
        lc = num_layers // (mm.pp * vpp)
        active = None
    else:
        active = _stage_active_layers(num_layers, mm)
    chunk_size = ce_chunk_size()

    def embed_fn(params, ids):
        return llama.embed(params, ids, cfg, tp_axis=tp, sequence_parallel=sp)

    def stage_fn(params, x, pos, chunk):
        cos, sin = get_cos_sin(pos.shape[0], cfg.actual_head_dim,
                               cfg.rope_theta, positions=pos, device=x.device)
        layers = params["layers"]
        if vpp > 1:  # this rank's local chunk: a view of its shard
            layers = {k: w[chunk * lc:(chunk + 1) * lc]
                      for k, w in layers.items()}
        return stack(x, layers, cos, sin, cfg, attn_fn, tp_axis=tp,
                     sequence_parallel=sp, active_layers=active)

    def loss_fn(params, x, targets):
        x = llama.final_hidden(params, x, cfg, tp_axis=tp,
                               sequence_parallel=sp)
        return fused_vocab_parallel_cross_entropy(
            x, llama.lm_head_weight(params, cfg), targets, axis=tp,
            chunk_size=chunk_size)

    def carry_shape(rows: int, seq: int) -> Tuple[int, ...]:
        return (rows, seq // (mm.tp if sp else 1), cfg.hidden_size)

    return PipelineFns(embed_fn, stage_fn, loss_fn, carry_shape, cfg.dtype,
                       has_aux=has_aux)


def make_llama_pipeline_fns(mm: MeshManager, cfg, *, attention_backend="sdpa",
                            gradient_checkpointing: bool = False,
                            remat_policy: str = "nothing_saveable",
                            sequence_parallel: bool = False,
                            vpp: int = 1) -> PipelineFns:
    """The Llama/Qwen3 pieces (the reference's ``make_llama_pipeline_loss``):
    the (vocab-parallel) embedding, this stage's ``decoder_stack`` (its
    padded slots masked, or local chunk ``chunk`` of the interleaved
    shard), and the final norm + chunked vocab-parallel CE."""
    from scaletorch_tpu_torch.models import llama

    def stack(x, layers, cos, sin, cfg_, attn_fn, **kw):
        return llama.decoder_stack(
            x, layers, cos, sin, cfg_, attn_fn,
            gradient_checkpointing=gradient_checkpointing,
            remat_policy=remat_policy, **kw)

    return _bind(mm, cfg, stack, attention_backend=attention_backend,
                 sequence_parallel=sequence_parallel, vpp=vpp, has_aux=False)


def make_moe_pipeline_fns(mm: MeshManager, cfg, *, attention_backend="sdpa",
                          gradient_checkpointing: bool = False,
                          remat_policy: str = "nothing_saveable",
                          sequence_parallel: bool = False,
                          vpp: int = 1) -> PipelineFns:
    """The Qwen3-MoE pieces (the reference's ``make_moe_pipeline_loss``, pp
    x ep): each stage's ``moe_decoder_stack`` runs the ep exchange inside
    and returns its aux loss and routing statistics beside the
    activation."""
    from scaletorch_tpu_torch.models import qwen3_moe

    if not cfg.is_uniform_sparse:
        raise NotImplementedError(
            "pipeline parallelism over an interleaved dense/sparse Qwen3-MoE "
            f"is not supported: the per-kind layer stacks (sparse "
            f"{cfg.sparse_layer_ids()}, dense {cfg.dense_layer_ids()}) do "
            "not align with a pp-split layer axis; run it with pp=1")
    ep = "ep" if mm.ep > 1 else None

    def stack(x, layers, cos, sin, cfg_, attn_fn, **kw):
        return qwen3_moe.moe_decoder_stack(
            x, layers, cos, sin, cfg_, attn_fn, ep_axis=ep,
            gradient_checkpointing=gradient_checkpointing,
            remat_policy=remat_policy, **kw)

    return _bind(mm, cfg, stack, attention_backend=attention_backend,
                 sequence_parallel=sequence_parallel, vpp=vpp, has_aux=True)


def _passes(accum: int, pp: int, engine: str) -> List[Tuple[int, int]]:
    """The microbatch ranges of a step's pipeline passes: one for afab and
    interleaved; chunks of pp and a shorter remainder for
    memory_chunked."""
    if engine != "memory_chunked":
        return [(0, accum)]
    bounds = list(range(0, accum, pp)) + [accum]
    return list(zip(bounds[:-1], bounds[1:]))


def make_pipeline_grad_fn(mm: MeshManager, fns: PipelineFns, *,
                          engine: str = "afab", vpp: int = 1) -> Callable:
    """grads(params, batch) -> (loss, stats, fp32 gradients in
    ``tree_leaves`` order) of this stage, before the mesh's reductions: the
    batch's accumulation axis is the microbatch axis. ``memory_chunked``
    recombines its passes weighted by their microbatch counts (each pass
    is a mean over its own)."""
    from scaletorch_tpu_torch.trainer.optimizer import tree_leaves

    if engine not in PP_ENGINES:
        raise ValueError(f"pp_engine must be one of {PP_ENGINES}, got "
                         f"{engine!r}")

    def grads_fn(params, batch: Dict[str, Tensor]):
        leaves = tree_leaves(params)
        accum = batch["input_ids"].shape[0]
        passes = _passes(accum, mm.pp, engine)
        grads = loss = stats = None
        for lo, hi in passes:
            sub = {k: v[lo:hi] for k, v in batch.items()}
            l_p, s_p = run_pipeline(params, sub, mm, fns, vpp=vpp,
                                    leaves=leaves)
            g_p = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   if p.grad is None else p.grad.float() for p in leaves]
            for p in leaves:
                p.grad = None
            if len(passes) == 1:
                return l_p, s_p, g_p
            n = hi - lo
            if grads is None:
                grads = [g * n for g in g_p]
                loss, stats = l_p * n, {k: v * n for k, v in s_p.items()}
            else:
                for acc, g in zip(grads, g_p):
                    acc.add_(g * n)
                loss = loss + l_p * n
                stats = {k: stats[k] + v * n for k, v in s_p.items()}
        return (loss / accum, {k: v / accum for k, v in stats.items()},
                [g / accum for g in grads])

    return grads_fn


def make_pipeline_eval_fn(mm: MeshManager, fns: PipelineFns, *,
                          vpp: int = 1) -> Callable:
    """loss(params, batch): one forward pass over the batch's microbatches
    (afab, or interleaved for an interleaved train step), the mean loss."""

    def eval_fn(params, batch: Dict[str, Tensor]) -> Tensor:
        return run_pipeline(params, batch, mm, fns, vpp=vpp)[0]

    return eval_fn
