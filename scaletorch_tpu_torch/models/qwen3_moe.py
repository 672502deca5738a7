"""Qwen3-MoE: the Qwen3 decoder with a sparse top-k expert MLP.

Counterpart of scaletorch_tpu/models/qwen3_moe.py. The parameter layout is the reference's, so a JAX tree carries across with
``models/convert.py``:

  * attention, norm and embedding keys as in ``llama.py`` (layers stacked
    on axis 0 over ALL layers);
  * the MoE keys ``router [Ls, H, E]``, ``expert_gate_proj`` /
    ``expert_up_proj [Ls, E, H, I]`` and ``expert_down_proj [Ls, E, I, H]``
    stacked over the SPARSE layers only, and for interleaved dense/sparse
    configs (``mlp_only_layers`` / ``decoder_sparse_step``) the dense
    SwiGLU keys over the dense layers ``[Ld, ...]``.

A sparse layer routes each batch row as its own group (fp32 router, the
``parallel/expert_parallel.py`` routing), moves the rows into ``[E, G, C,
H]`` capacity slots and runs ``moe_mlp``: the grouped-MLP kernels K5-K7
when ``use_grouped_mlp_kernel`` is set (read once from
``SCALETORCH_TPU_GROUPED_MLP_KERNEL`` when the config is built, default
off, as in the reference), else three batched products over every slot.
The forward returns the coefficient-scaled aux loss summed over the layers
and the layer-mean routing statistics beside the hidden states.

Over a mesh the training forward takes the reference's axes: with
``ep_axis`` each rank holds E/ep experts (``qwen3_moe_param_specs``) and
the slots go through the all-to-all exchange, K5-K7 then running on the
exchanged ``[E/ep, ep·G, C, H]`` slabs with the fill counts exchanged
beside them; with ``tp_axis`` attention runs Megatron-style and each
expert's gate/up are column-parallel and its down row-parallel (under
``sequence_parallel`` the block all-gathers the normed sequence, routes
the whole sequence, and completes the tp-partial expert output with the
reduce-scatter back into its slice).

``Qwen3MoEForCausalLM`` serves: its matmul weights are held in the compute
dtype, the norms and the router in ``param_dtype`` (the router runs in
fp32, as the reference's does). Its weights are filled in place, layer by
layer, from a seeded generator (``init_weights_``), so a full-size model
never needs a second copy on the card.

Over a serving mesh of tp x ep ranks (``mesh``) the module holds this
rank's slices as ``qwen3_moe_param_specs`` cuts them: attention, the
embedding and the head over tp as the dense model's, the experts E/ep
over ep and their intermediate dim I/tp over tp, the router whole. Every
rank of the group holds the same slots and the same hidden state, so the
training path's all-to-all (which assumes different tokens on each ep
rank) would send each row ep times; the serving block instead routes all
rows on every rank with the replicated fp32 router (the same bits on
every rank), keeps the choices of its own E/ep experts in the slots the
whole routing gave them (``local_expert_routing``), runs the grouped MLP
(K5 on the card) over those experts and its I/tp slice, takes the
weighted sum of its partial outputs, and completes every token with ONE
all-reduce over the ep x tp group (``parallel.mesh.EXPERT_AXES``). A
rank's expert work is 1/(ep·tp) of one card's, the capacity is one
card's (dropless decode stays dropless), and a layer issues two
collectives: attention's row-parallel all-reduce over tp (none at tp 1)
and the experts' all-reduce. A step adds the vocab-parallel embedding's
all-reduce and the logits' all-gather over tp. Static shapes only: the
collectives run inside the captured serving steps.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from scaletorch_tpu_torch.env import get_env
from scaletorch_tpu_torch.models import llama as _llama
from scaletorch_tpu_torch.models.layers import (
    get_cos_sin,
    init_generator,
    rms_norm,
)
from scaletorch_tpu_torch.models.qwen3 import Qwen3Config
from scaletorch_tpu_torch.models.registry import get_attention_backend
from scaletorch_tpu_torch.parallel.expert_parallel import (
    combine_routed,
    dispatch_routed,
    exchange_slot_counts,
    expert_capacity,
    local_expert_routing,
    moe_mlp,
    resolve_moe_dispatch,
    route_tokens,
    routed_fill_counts,
)
from scaletorch_tpu_torch.parallel.mesh import (
    EXPERT_AXES,
    all_reduce_,
    axis_group,
)
from scaletorch_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor
Params = Dict[str, Any]

GROUPED_MLP_ENV = "SCALETORCH_TPU_GROUPED_MLP_KERNEL"


def _grouped_mlp_env_default() -> bool:
    """The kernel toggle as the reference reads it: default off."""
    return get_env(GROUPED_MLP_ENV)


@dataclass(frozen=True)
class Qwen3MoEConfig(Qwen3Config):
    num_experts: int = 8
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 768
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.001  # router_aux_loss_coef
    z_loss_coef: float = 0.0
    norm_topk_prob: bool = True
    tie_word_embeddings: bool = False
    # layer i runs a dense SwiGLU MLP when i is in mlp_only_layers or
    # (i + 1) % decoder_sparse_step != 0 (the HF predicate)
    mlp_only_layers: Tuple[int, ...] = ()
    decoder_sparse_step: int = 1
    # token movement: 'index' (scatter/gather), 'einsum' (one-hot), 'auto'
    moe_dispatch: str = "auto"
    # the grouped-MLP kernels; read from the environment once, here
    use_grouped_mlp_kernel: bool = field(
        default_factory=_grouped_mlp_env_default)

    def __post_init__(self) -> None:
        object.__setattr__(self, "mlp_only_layers",
                           tuple(self.mlp_only_layers))
        if self.moe_dispatch not in ("auto", "einsum", "index"):
            raise ValueError(
                f"moe_dispatch must be 'auto', 'einsum' or 'index', got "
                f"{self.moe_dispatch!r}")
        if self.decoder_sparse_step < 1:
            raise ValueError(f"decoder_sparse_step must be >= 1, got "
                             f"{self.decoder_sparse_step}")
        bad = [i for i in self.mlp_only_layers
               if not 0 <= i < self.num_hidden_layers]
        if bad:
            raise ValueError(f"mlp_only_layers indices {bad} out of range for "
                             f"{self.num_hidden_layers} layers")
        if not any(self.sparse_layout()):
            raise ValueError(
                f"no layer is sparse under mlp_only_layers="
                f"{self.mlp_only_layers} / decoder_sparse_step="
                f"{self.decoder_sparse_step}; use the dense Qwen3 family")

    @classmethod
    def from_hf(cls, hf_config, **overrides) -> "Qwen3MoEConfig":
        """Build from a HF Qwen3-MoE ``config.json`` (the parsed dict or a
        config object); training knobs come in ``overrides``."""
        get = _llama.hf_field(hf_config)
        kw = dict(
            num_experts=get("num_experts", 8),
            num_experts_per_tok=get("num_experts_per_tok", 2),
            moe_intermediate_size=get("moe_intermediate_size", 768),
            norm_topk_prob=get("norm_topk_prob", True),
            mlp_only_layers=tuple(get("mlp_only_layers", None) or ()),
            decoder_sparse_step=get("decoder_sparse_step", 1) or 1,
        )
        kw.update(overrides)
        return super().from_hf(hf_config, **kw)

    # ---- the dense/sparse layout ------------------------------------------------
    def layer_is_sparse(self, layer_idx: int) -> bool:
        return (layer_idx not in self.mlp_only_layers
                and self.num_experts > 0
                and (layer_idx + 1) % self.decoder_sparse_step == 0)

    def sparse_layout(self) -> Tuple[bool, ...]:
        return tuple(self.layer_is_sparse(i)
                     for i in range(self.num_hidden_layers))

    @property
    def is_uniform_sparse(self) -> bool:
        return all(self.sparse_layout())

    def resolved_moe_dispatch(self) -> str:
        return resolve_moe_dispatch(self.moe_dispatch, self.num_experts)

    def sparse_layer_ids(self) -> Tuple[int, ...]:
        return tuple(i for i, s in enumerate(self.sparse_layout()) if s)

    def dense_layer_ids(self) -> Tuple[int, ...]:
        return tuple(i for i, s in enumerate(self.sparse_layout()) if not s)

    def moe_segments(self) -> Tuple[Tuple[bool, int, int], ...]:
        """Contiguous (is_sparse, lo, hi) runs of same-kind layers."""
        layout = self.sparse_layout()
        segs = []
        lo = 0
        for i in range(1, len(layout) + 1):
            if i == len(layout) or layout[i] != layout[lo]:
                segs.append((layout[lo], lo, i))
                lo = i
        return tuple(segs)

    def _count(self, experts_per_token: int) -> int:
        h, v = self.hidden_size, self.vocab_size
        n_sparse = sum(self.sparse_layout())
        n_dense = self.num_hidden_layers - n_sparse
        attn = h * self.q_size + 2 * h * self.kv_size + self.q_size * h
        moe = experts_per_token * 3 * h * self.moe_intermediate_size
        router = h * self.num_experts
        norms = 2 * h + (2 * self.actual_head_dim if self.qk_norm else 0)
        head = 0 if self.tie_word_embeddings else v * h
        return (self.num_hidden_layers * (attn + norms)
                + n_sparse * (moe + router)
                + n_dense * 3 * h * self.intermediate_size
                + v * h + h + head)

    def num_params(self) -> int:
        return self._count(self.num_experts)

    def num_active_params(self) -> int:
        """Parameters a token touches: the top-k experts on sparse layers
        (the MFU numerator the reference uses for MoE)."""
        return self._count(self.num_experts_per_tok)


def execution_fields_equal(a: Qwen3MoEConfig, b: Qwen3MoEConfig) -> bool:
    """The two configs describe the same weights: they may differ in how
    they run (the kernel toggle, the movement form), nothing else."""
    keep = dict(use_grouped_mlp_kernel=False, moe_dispatch="auto")
    return dataclasses.replace(a, **keep) == dataclasses.replace(b, **keep)


# ---- parameters ---------------------------------------------------------------
_ATTN_KEYS = ("input_layernorm", "q_proj", "k_proj", "v_proj", "o_proj",
              "post_attention_layernorm", "q_norm", "k_norm")
_MOE_KEYS = ("router", "expert_gate_proj", "expert_up_proj",
             "expert_down_proj")
_DENSE_KEYS = ("gate_proj", "up_proj", "down_proj")


def param_shapes(cfg: Qwen3MoEConfig) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Flat name -> (shape, init) in the reference layout; init is
    'ones' (norms), 'normal' (N(0, 0.02): embedding, router) or
    'uniform' (fan-in uniform over axis -2: projections, experts)."""
    h, e, i = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size
    ls = len(cfg.sparse_layer_ids())
    ld = cfg.num_hidden_layers - ls
    shapes = {}
    for name, (shape, is_norm) in _llama._param_shapes(cfg).items():
        if name.split(".")[-1] in _DENSE_KEYS:
            continue
        init = ("ones" if is_norm else
                "normal" if name == "embed_tokens" else "uniform")
        shapes[name] = (shape, init)
    shapes["layers.router"] = ((ls, h, e), "normal")
    shapes["layers.expert_gate_proj"] = ((ls, e, h, i), "uniform")
    shapes["layers.expert_up_proj"] = ((ls, e, h, i), "uniform")
    shapes["layers.expert_down_proj"] = ((ls, e, i, h), "uniform")
    if ld:
        di = cfg.intermediate_size
        shapes["layers.gate_proj"] = ((ld, h, di), "uniform")
        shapes["layers.up_proj"] = ((ld, h, di), "uniform")
        shapes["layers.down_proj"] = ((ld, di, h), "uniform")
    return shapes


@torch.no_grad()
def _fill_(t: Tensor, init: str, generator: torch.Generator,
           draw_dtype: torch.dtype, full: Optional[Tuple[int, ...]] = None,
           local: Optional[Callable[[Tensor], Tensor]] = None) -> None:
    """Fill ``t`` in place, one leading-axis slice at a time for stacked
    weights, drawing in ``draw_dtype`` and casting into t's dtype. With
    ``full`` (the whole leaf's shape) ``t`` is a rank's part of it: each
    slice is drawn whole and ``local`` cuts the rank's part of the slice
    (given as a stack of one when the leaf is stacked), so every rank
    draws what one card draws."""
    if init == "ones":
        t.fill_(1.0)
        return
    full = tuple(t.shape) if full is None else full
    stacked = len(full) >= 3
    slices = t.unbind(0) if stacked else (t,)
    for part in slices:
        tmp = torch.empty(full[1:] if stacked else full, dtype=draw_dtype,
                          device=t.device)
        if init == "normal":
            tmp.normal_(0.0, 0.02, generator=generator)
        else:
            bound = 1.0 / math.sqrt(full[-2])
            tmp.uniform_(-bound, bound, generator=generator)
        if local is not None:
            tmp = local(tmp[None])[0] if stacked else local(tmp)
        part.copy_(tmp)


def init_params(cfg: Qwen3MoEConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, *,
                requires_grad: bool = False,
                local_slice: Optional[Callable[[str, Tensor], Tensor]] = None
                ) -> Params:
    """Random parameters in the reference layout and distributions, as a
    nested dict of ``param_dtype`` tensors on ``device``: ones for norms,
    N(0, 0.02) for the embedding and the router, fan-in uniform for the
    projections and experts. ``generator`` lives on ``device`` (default:
    a fresh one seeded with 0). ``local_slice(name, leaf)`` keeps this
    rank's part of each leaf as soon as it is drawn (``llama.
    init_params``'s contract: the shards are those of one card's
    parameters)."""
    dev = resolve_device(device)
    generator = init_generator(generator, dev)
    params: Params = {"layers": {}}
    for name, (shape, init) in param_shapes(cfg).items():
        t = torch.empty(shape, dtype=cfg.param_dtype, device=dev)
        _fill_(t, init, generator, cfg.param_dtype)
        if local_slice is not None:
            t = local_slice(name, t)
        t.requires_grad_(requires_grad)
        if name.startswith("layers."):
            params["layers"][name[len("layers."):]] = t
        else:
            params[name] = t
    return params


# ---- the MoE block and the training forward -------------------------------------
def _routed_experts(x: Tensor, layer: Dict[str, Tensor], cfg: Qwen3MoEConfig,
                    with_aux: bool, *, ep_axis: Optional[str] = None,
                    tp_axis: Optional[str] = None,
                    sequence_parallel: bool = False,
                    first_expert: Optional[int] = None,
                    expert_group: Any = None
                    ) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
    """Post-attention MoE sub-block with residual -> (x, the routing's aux
    per group, or None without ``with_aux``): router (fp32) -> route ->
    dispatch (-> exchange) -> experts -> (exchange ->) combine.

    Serving over a mesh (the module docstring): with ``first_expert``,
    ``layer``'s experts are this rank's E/ep, the first at that global
    index, and the rows move by index (``local_expert_routing``); the
    weighted partial outputs are summed over ``expert_group`` (ep x tp)."""
    sp = tp_axis is not None and sequence_parallel
    h = rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
    if sp:
        from scaletorch_tpu_torch.parallel.sequence_parallel import (
            all_gather_sequence,
        )

        # everything past here is tp-partial until the reduce-scatter
        h = all_gather_sequence(h, tp_axis)
    s = h.shape[1]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = torch.matmul(h.float(), layer["router"].float())  # [B, S, E]
    cap = expert_capacity(s, e, k, cfg.capacity_factor)
    mode = cfg.resolved_moe_dispatch() if first_expert is None else "index"
    state, aux = route_tokens(logits, k, cap, mode=mode,
                              normalize_weights=cfg.norm_topk_prob,
                              with_aux=with_aux)
    if first_expert is not None:
        e = layer["expert_gate_proj"].shape[0]
        state = local_expert_routing(state, first_expert, e, cap)
    slots = dispatch_routed(h, state, mode=mode, num_experts=e, capacity=cap,
                            axis=ep_axis)
    kernel = {}
    if cfg.use_grouped_mlp_kernel:
        counts = routed_fill_counts(state, mode=mode, num_experts=e,
                                    capacity=cap)
        kernel = dict(slot_counts=exchange_slot_counts(counts, ep_axis),
                      capacity=cap)
    out = moe_mlp(slots, layer["expert_gate_proj"], layer["expert_up_proj"],
                  layer["expert_down_proj"], tp_axis=tp_axis,
                  compute_dtype=cfg.dtype, reduce="none" if sp else "sum",
                  **kernel)
    y = combine_routed(out, state, mode=mode, num_experts=e, capacity=cap,
                       axis=ep_axis)
    if sp:
        from scaletorch_tpu_torch.parallel.sequence_parallel import (
            reduce_scatter_sequence,
        )

        y = reduce_scatter_sequence(y, tp_axis)
    return x + all_reduce_(y, expert_group).to(x.dtype), aux


def moe_block(x: Tensor, layer: Dict[str, Tensor], cfg: Qwen3MoEConfig, *,
              ep_axis: Optional[str] = None, tp_axis: Optional[str] = None,
              sequence_parallel: bool = False
              ) -> Tuple[Tensor, Tensor, Dict[str, Tensor]]:
    """Post-attention MoE sub-block with residual -> (x, aux_loss, stats):
    router (fp32) -> route -> dispatch -> experts -> combine, over the
    mesh axes given. ``stats`` holds ``moe_dropped_fraction`` and
    ``moe_load_cv`` (the coefficient of variation of the expert load,
    population std as ``jnp.std``)."""
    x, aux = _routed_experts(x, layer, cfg, with_aux=True, ep_axis=ep_axis,
                             tp_axis=tp_axis,
                             sequence_parallel=sequence_parallel)
    aux = {name: v.mean(dim=0) for name, v in aux.items()}  # over groups
    aux_total = (cfg.aux_loss_coef * aux["aux_loss"]
                 + cfg.z_loss_coef * aux["z_loss"])
    if tp_axis is not None and sequence_parallel:
        # under SP the routing's gradients are tp-partials (the
        # reduce-scatter sums them), but every tp rank computes the same
        # aux from the whole logits: its gradient enters as a 1/tp share
        from scaletorch_tpu_torch.parallel.mesh import axis_group, group_size

        share = 1.0 / group_size(axis_group(tp_axis))
        aux_total = aux_total * share + (aux_total * (1.0 - share)).detach()
    load = aux["expert_load"]
    stats = {
        "moe_dropped_fraction": aux["dropped_fraction"],
        "moe_load_cv": load.std(correction=0) / load.mean().clamp_min(1e-9),
    }
    return x, aux_total, stats


def moe_block_serving(x: Tensor, layer: Dict[str, Tensor],
                      cfg: Qwen3MoEConfig, *,
                      first_expert: Optional[int] = None,
                      group: Any = None) -> Tensor:
    """``moe_block``'s x, bit for bit, without the aux loss and the
    routing statistics that only training reads (the reference discards
    them in its cached forward and XLA drops the dead code; here they
    would run, inside the serving graphs too). Over a serving mesh,
    ``first_expert`` and ``group`` as ``_routed_experts`` takes them."""
    return _routed_experts(x, layer, cfg, with_aux=False,
                           first_expert=first_expert, expert_group=group)[0]


def _moe_layer(x, layer, cos, sin, cfg, attn_fn, tp_axis=None, ep_axis=None,
               sequence_parallel=False):
    helpers = _llama.tp_region_helpers(tp_axis, sequence_parallel)
    x = _llama.attention_block(x, layer, cos, sin, cfg, attn_fn, helpers)
    x, aux, stats = moe_block(x, layer, cfg, ep_axis=ep_axis, tp_axis=tp_axis,
                              sequence_parallel=sequence_parallel)
    return x, aux, stats["moe_dropped_fraction"], stats["moe_load_cv"]


def _per_layer(layers: Dict[str, Tensor]) -> List[Dict[str, Tensor]]:
    """The stacked leaves unbound once, so each leaf's gradient is one
    stack of the per-layer gradients."""
    names = list(layers)
    return [dict(zip(names, w))
            for w in zip(*(layers[n].unbind(0) for n in names))]


def moe_decoder_stack(x: Tensor, layers: Dict[str, Tensor], cos: Tensor,
                      sin: Tensor, cfg: Qwen3MoEConfig, attn_fn: Callable, *,
                      tp_axis: Optional[str] = None,
                      ep_axis: Optional[str] = None,
                      sequence_parallel: bool = False,
                      gradient_checkpointing: bool = False,
                      remat_policy: str = "nothing_saveable",
                      active_layers: Optional[int] = None
                      ) -> Tuple[Tensor, Tensor, Dict[str, Tensor]]:
    """Attention + MoE over every layer of a stack -> (hidden, aux loss
    summed over the layers, stats averaged over them). With
    ``gradient_checkpointing`` each layer runs under
    ``torch.utils.checkpoint`` with the policy's ``context_fn``
    (``llama.resolve_remat_policy``): the einsum path's expert ``bmm``s
    are dots, the grouped-MLP kernels K5-K7 are not. ``active_layers`` k
    (an uneven pipeline stage) runs the first k slots only: the aux sums
    over them and the stats are their sum over max(k, 1)."""
    if gradient_checkpointing:
        context_fn = _llama.resolve_remat_policy(remat_policy)
        attn_fn = _llama.remat_attn_fn(attn_fn, remat_policy)
    axes = (tp_axis, ep_axis, sequence_parallel)
    per_layer = _per_layer(layers)
    if active_layers is not None:
        per_layer = per_layer[:active_layers]
    auxes, drops, cvs = [], [], []
    for layer in per_layer:
        if gradient_checkpointing:
            x, aux, drop, cv = _llama.checkpointed(
                _moe_layer, x, layer, cos, sin, cfg, attn_fn, *axes,
                context_fn=context_fn)
        else:
            x, aux, drop, cv = _moe_layer(x, layer, cos, sin, cfg, attn_fn,
                                          *axes)
        auxes.append(aux)
        drops.append(drop)
        cvs.append(cv)
    if active_layers is None:
        stats = {"moe_dropped_fraction": torch.stack(drops).mean(),
                 "moe_load_cv": torch.stack(cvs).mean()}
    else:
        denom = max(active_layers, 1)
        stats = {"moe_dropped_fraction": torch.stack(drops).sum() / denom,
                 "moe_load_cv": torch.stack(cvs).sum() / denom}
    return x, torch.stack(auxes).sum(), stats


def interleaved_decoder_stack(x: Tensor, layers: Dict[str, Tensor],
                              cos: Tensor, sin: Tensor, cfg: Qwen3MoEConfig,
                              attn_fn: Callable, *,
                              tp_axis: Optional[str] = None,
                              ep_axis: Optional[str] = None,
                              sequence_parallel: bool = False,
                              gradient_checkpointing: bool = False,
                              remat_policy: str = "nothing_saveable"
                              ) -> Tuple[Tensor, Tensor, Dict[str, Tensor]]:
    """Mixed dense/sparse decoder: each contiguous same-kind segment
    (``cfg.moe_segments()``) runs over its slice of the stacks; stats are
    averaged over the sparse layers only."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    stats_sum: Dict[str, Tensor] = {}
    n_sparse = d_off = s_off = 0
    mesh = dict(tp_axis=tp_axis, sequence_parallel=sequence_parallel,
                gradient_checkpointing=gradient_checkpointing,
                remat_policy=remat_policy)
    for is_sparse, lo, hi in cfg.moe_segments():
        n = hi - lo
        seg = {k: layers[k][lo:hi] for k in _ATTN_KEYS if k in layers}
        if is_sparse:
            seg.update({k: layers[k][s_off:s_off + n] for k in _MOE_KEYS})
            x, aux, stats = moe_decoder_stack(
                x, seg, cos, sin, cfg, attn_fn, ep_axis=ep_axis, **mesh)
            aux_total = aux_total + aux
            for name, v in stats.items():
                stats_sum[name] = stats_sum.get(name, 0.0) + n * v
            n_sparse += n
            s_off += n
        else:
            seg.update({k: layers[k][d_off:d_off + n] for k in _DENSE_KEYS})
            x = _llama.decoder_stack(x, seg, cos, sin, cfg, attn_fn, **mesh)
            d_off += n
    return x, aux_total, {k: v / n_sparse for k, v in stats_sum.items()}


def forward(params: Params, input_ids: Tensor, cfg: Qwen3MoEConfig, *,
            positions: Optional[Tensor] = None,
            attention_backend: Any = "sdpa",
            gradient_checkpointing: bool = False,
            remat_policy: str = "nothing_saveable",
            tp_axis: Optional[str] = None,
            ep_axis: Optional[str] = None,
            sequence_parallel: bool = False,
            return_hidden: bool = False,
            return_moe_stats: bool = False) -> Any:
    """[B, S] tokens -> logits [B, S, V]; with ``return_hidden`` the final
    hidden states and the aux loss ``(hidden, aux)``; with
    ``return_moe_stats`` the layer-mean routing stats as a third element
    (``(logits, aux, stats)`` without ``return_hidden``). The aux loss is
    coefficient-scaled and summed over the layers: add it to the CE. With
    ``tp_axis`` / ``ep_axis`` the parameters are this rank's shards
    (``qwen3_moe_param_specs``)."""
    x = _llama.embed(params, input_ids, cfg, tp_axis=tp_axis,
                     sequence_parallel=sequence_parallel)
    cos, sin = get_cos_sin(input_ids.shape[1], cfg.actual_head_dim,
                           cfg.rope_theta, positions=positions,
                           device=input_ids.device)
    attn_fn = (attention_backend if callable(attention_backend)
               else get_attention_backend(attention_backend))
    stack = (moe_decoder_stack if cfg.is_uniform_sparse
             else interleaved_decoder_stack)
    x, aux_loss, stats = stack(
        x, params["layers"], cos, sin, cfg, attn_fn, tp_axis=tp_axis,
        ep_axis=ep_axis, sequence_parallel=sequence_parallel,
        gradient_checkpointing=gradient_checkpointing,
        remat_policy=remat_policy)
    x = _llama.final_hidden(params, x, cfg, tp_axis=tp_axis,
                            sequence_parallel=sequence_parallel)
    if return_hidden:
        return (x, aux_loss, stats) if return_moe_stats else (x, aux_loss)
    logits = x @ lm_head_weight(params, cfg)
    return (logits, aux_loss, stats) if return_moe_stats else logits


def lm_head_weight(params: Params, cfg: Qwen3MoEConfig) -> Tensor:
    return _llama.lm_head_weight(params, cfg)


def qwen3_moe_param_specs(cfg: Qwen3MoEConfig) -> Dict[str, object]:
    """The dim of each leaf that splits over tp (None: replicated), in the
    parameter dict's nesting (``tensor_parallel.llama_param_specs``'s
    form): attention, embedding and norms as the dense model's; each
    expert's gate/up split their intermediate dim (column-parallel) and
    its down the input dim (row-parallel); the router is replicated.
    Every expert leaf splits its expert dim (1) over ep
    (``tensor_parallel.shard_dims``)."""
    from scaletorch_tpu_torch.parallel.tensor_parallel import (
        llama_param_specs,
    )

    specs = llama_param_specs(cfg)
    layers = dict(specs["layers"])
    if cfg.is_uniform_sparse:
        for k in _DENSE_KEYS:
            del layers[k]
    layers.update(router=None, expert_gate_proj=3, expert_up_proj=3,
                  expert_down_proj=2)
    specs["layers"] = layers
    return specs


# ---- serving ------------------------------------------------------------------------
def _check_servable(cfg: Qwen3MoEConfig) -> None:
    if not cfg.is_uniform_sparse:
        raise NotImplementedError(
            "forward_cached supports uniform-sparse Qwen3-MoE configs; this "
            f"one interleaves dense layers {cfg.dense_layer_ids()} "
            "(mlp_only_layers/decoder_sparse_step) — serve it with the dense "
            "Qwen3 family or extend the cache to per-kind stacks")


def check_serving_mesh(cfg: Qwen3MoEConfig, mesh: Any) -> None:
    """A Qwen3-MoE serving mesh spans tp and ep (and replicas over dp):
    tp at most the KV heads and dividing them and the experts'
    intermediate dim, ep dividing the experts."""
    if mesh.pp > 1 or mesh.cp > 1:
        raise ValueError(
            f"a Qwen3-MoE serving mesh spans tp, ep and dp, got {mesh!r}")
    if cfg.num_key_value_heads % mesh.tp:
        raise ValueError(
            f"tp={mesh.tp} does not split {cfg.num_key_value_heads} KV heads")
    if cfg.moe_intermediate_size % mesh.tp:
        raise ValueError(
            f"tp={mesh.tp} does not split moe_intermediate_size="
            f"{cfg.moe_intermediate_size}")
    if cfg.num_experts % mesh.ep:
        raise ValueError(
            f"ep={mesh.ep} does not split {cfg.num_experts} experts")


class Qwen3MoEForCausalLM(nn.Module):
    """The uniform-sparse MoE decoder for serving, weights in the
    reference layout (see the module docstring). Built empty on
    ``device`` (None = the CUDA card); fill it with ``init_weights_``,
    ``models.convert.load_numpy_params`` or build it with
    ``from_params``. Weights carry no gradient.

    With ``mesh`` (a ``parallel.mesh.MeshManager`` of tp and ep ranks)
    the module holds this rank's slices, cut as ``models.convert.
    local_shard_fn`` cuts them (``qwen3_moe_param_specs``); its
    ``forward_cached`` runs the tp attention and the sharded MoE block
    (the mesh must be current: ``using_mesh_manager``) and returns the
    full-vocabulary logits on every rank."""

    def __init__(self, cfg: Qwen3MoEConfig, device: DeviceLike = None, *,
                 mesh: Any = None) -> None:
        super().__init__()
        _check_servable(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.tp_size = mesh.tp if mesh is not None else 1
        self.ep_size = mesh.ep if mesh is not None else 1
        self.tp_axis = "tp" if self.tp_size > 1 else None
        # the global index of this rank's first expert
        self.first_expert = 0
        # this rank's part of a full leaf (None: the leaves are whole)
        self._local = None
        if self.tp_size > 1 or self.ep_size > 1:
            from scaletorch_tpu_torch.models.convert import local_shard_fn

            check_serving_mesh(cfg, mesh)
            self._local = local_shard_fn(cfg, mesh, mesh.rank)
            self.first_expert = (mesh.axis_rank("ep") * cfg.num_experts
                                 // self.ep_size)
        self._inits: Dict[str, str] = {}
        self._full: Dict[str, Tuple[int, ...]] = {}
        layers: Dict[str, nn.Parameter] = {}
        for name, (shape, init) in param_shapes(cfg).items():
            self._full[name] = shape
            if self._local is not None:
                shape = tuple(self._local(
                    name, torch.empty(shape, device="meta")).shape)
            full_precision = init == "ones" or name == "layers.router"
            dtype = cfg.param_dtype if full_precision else cfg.dtype
            p = nn.Parameter(torch.empty(shape, dtype=dtype, device=dev),
                             requires_grad=False)
            self._inits[name] = init
            if name.startswith("layers."):
                layers[name[len("layers."):]] = p
            else:
                self.register_parameter(name, p)
        self.layers = nn.ParameterDict(layers)

    @property
    def sharded(self) -> bool:
        return self._local is not None

    @classmethod
    def from_params(cls, params: Params, cfg: Qwen3MoEConfig,
                    device: DeviceLike = None, *,
                    mesh: Any = None) -> "Qwen3MoEForCausalLM":
        """A model holding ``params`` (a nested dict of tensors or numpy
        arrays in the reference layout); with ``mesh``, this rank's slices
        of the full tree."""
        from scaletorch_tpu_torch.models.convert import (
            load_numpy_params,
            shard_numpy_params,
        )

        model = cls(cfg, device=device, mesh=mesh)
        if model.sharded:
            params = shard_numpy_params(params, cfg, mesh, mesh.rank)
        load_numpy_params(model, params)
        return model

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator
                      ) -> "Qwen3MoEForCausalLM":
        """Random weights with ``init_params``' distributions, drawn in
        place one layer slice at a time in ``param_dtype`` and cast into
        each parameter (the draws differ from ``init_params``'). Over a
        mesh every rank draws each full slice in one order and keeps its
        part, so the shards are one card's weights."""
        for name, p in self.named_parameters():
            local = (None if self._local is None else
                     functools.partial(self._local, name))
            _fill_(p, self._inits[name], generator, self.cfg.param_dtype,
                   full=self._full[name], local=local)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def lm_head_weight(self) -> Tensor:
        if self.cfg.tie_word_embeddings:
            return self.embed_tokens.T
        return self.lm_head

    def forward_cached(
        self,
        input_ids: Tensor,
        cache: Tuple[Tensor, Tensor],
        *,
        positions: Tensor,
        write_mask: Optional[Tensor] = None,
        kv_io: Optional[Any] = None,
        last_index: Optional[Tensor] = None,
        cfg: Optional[Qwen3MoEConfig] = None,
    ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
        """[B, S] tokens at absolute ``positions`` [B, S] -> (logits [B, S,
        V], the cache pair updated in place); ``last_index`` as in
        ``LlamaForCausalLM.forward_cached``. ``cfg`` may change how the MoE
        runs (kernel toggle, movement form), never the weights. The MoE
        routes each call's rows alone: with a dropless capacity factor
        (>= E / k) decode matches the full forward exactly."""
        cfg = self.cfg if cfg is None else cfg
        tp = self.tp_axis
        cache_k, cache_v = cache
        if tp is None:
            x = self.embed_tokens[input_ids.long()]
        else:
            from scaletorch_tpu_torch.parallel.tensor_parallel import (
                vocab_parallel_embedding,
            )

            x = vocab_parallel_embedding(input_ids, self.embed_tokens,
                                         axis=tp)
        cos, sin = get_cos_sin(input_ids.shape[1], cfg.actual_head_dim,
                               cfg.rope_theta, positions=positions)
        group = axis_group(EXPERT_AXES) if self.sharded else None
        first = self.first_expert if self.ep_size > 1 else None
        for i, layer in enumerate(_per_layer(dict(self.layers.items()))):
            x = _llama.attention_block_cached(
                x, layer, cache_k[i], cache_v[i], cos, sin, positions, cfg,
                write_mask=write_mask, kv_io=kv_io, tp_axis=tp)
            x = moe_block_serving(x, layer, cfg, first_expert=first,
                                  group=group)
        if last_index is not None:
            rows = torch.arange(x.shape[0], device=x.device)
            x = x[rows, last_index.long()][:, None]
        x = rms_norm(x, self.norm, cfg.rms_norm_eps)
        logits = x @ self.lm_head_weight()
        if tp is not None:
            from scaletorch_tpu_torch.parallel.tensor_parallel import (
                gather_from_tensor_parallel_region,
            )

            logits = gather_from_tensor_parallel_region(logits, tp)
        return logits, (cache_k, cache_v)


def forward_cached(model: Qwen3MoEForCausalLM, input_ids: Tensor,
                   cfg: Qwen3MoEConfig, cache: Tuple[Tensor, Tensor],
                   **kw: Any) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Functional entry with the reference's ``forward_fn`` signature;
    ``params`` is the model. ``cfg`` must describe the model's weights;
    its kernel toggle and movement form are the ones this call runs."""
    _check_servable(cfg)
    if not execution_fields_equal(model.cfg, cfg):
        raise ValueError("the model was built for another config")
    return model.forward_cached(input_ids, cache, cfg=cfg, **kw)
