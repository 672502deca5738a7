"""Llama-family decoder LM: the training forward and the KV-cached forward.

Counterpart of scaletorch_tpu/models/llama.py. The parameter layout is
the reference's, so a JAX parameter tree carries across unchanged
(``models/convert.py``):

  * the same key names, layers stacked along axis 0;
  * projections stored ``[in, out]`` and applied as ``x @ w`` (no
    ``nn.Linear``, whose weight is ``[out, in]``);
  * the tied head is ``embed_tokens.T``.

``LlamaForCausalLM`` holds the matmul and embedding weights already cast
to the compute dtype ``cfg.dtype`` (bit-identical to the JAX package's
per-use ``.astype(cfg.dtype)``) and the norm weights in ``param_dtype``
(``rms_norm`` reads them as fp32). Qwen3 rides the ``qk_norm`` flag.

The layer loop is a Python loop over the stacked weights; the KV cache
(dense ``[L, B, Hkv, S_max, D]`` or the paged pool ``[L, n_pages, Hkv,
page_size, D]``) is updated IN PLACE, the counterpart of the JAX
package's buffer donation.

The training forward (``forward``, ``decoder_stack``, ``attention_block``)
is a set of functions over the parameter dict of ``init_params``: master
leaves in ``param_dtype`` (fp32, or bf16) with ``requires_grad``, cast to
``cfg.dtype`` at each use as the reference's ``w.astype(cdt)``, so the
gradients land on the master leaves (with bf16 masters the casts are
no-ops). Attention goes through the backend registry (``sdpa``,
``flash``, and under context parallelism ``ring``/``ulysses``), or is a
callable. With ``tp_axis`` the leaves are this rank's tensor-parallel
shards (``parallel/tensor_parallel.llama_param_specs``) and the block
runs Megatron-style: the norm's output enters the rank-local region
through ``copy_to_tensor_parallel_region`` (or, with
``sequence_parallel``, the sequence all-gather), q/k/v/gate/up are
column-parallel, o/down row-parallel; under SP the residual stream and
the norms hold a 1/tp sequence slice. Without ``tp_axis`` the
single-device code path is unchanged. Gradient checkpointing runs each layer under
``torch.utils.checkpoint`` with the reference's four policies
(``resolve_remat_policy``): ``nothing_saveable`` recomputes the whole
layer, the others save the outputs of chosen ops
(``create_selective_checkpoint_contexts``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from scaletorch_tpu_torch.models.layers import (
    apply_rotary_pos_emb,
    cached_sdpa_attention,
    get_cos_sin,
    init_generator,
    rms_norm,
    sdpa_attention,
    swiglu,
    write_kv_cache,
)
from scaletorch_tpu_torch.models.registry import (
    get_attention_backend,
    register_attention_backend,
)
from scaletorch_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor
Params = Dict[str, Any]


_MISSING = object()


def hf_field(hf_config) -> Callable[..., Any]:
    """``get(name[, default])`` over a parsed HF ``config.json`` dict or a
    config object; without a default a missing field raises. A
    ``rope_theta`` kept under ``rope_parameters`` is found there."""

    def get(name: str, default: Any = _MISSING) -> Any:
        if isinstance(hf_config, dict):
            src = hf_config
            if name == "rope_theta" and name not in src:
                src = src.get("rope_parameters") or {}
            if name in src:
                return src[name]
        elif hasattr(hf_config, name):
            return getattr(hf_config, name)
        if default is _MISSING:
            raise KeyError(f"HF config has no {name!r}")
        return default

    return get


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 16
    num_key_value_heads: int = 4
    head_dim: Optional[int] = None  # defaults to hidden // heads
    max_position_embeddings: int = 32768
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    qk_norm: bool = False  # Qwen3-style per-head q/k RMSNorm before RoPE
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32

    @property
    def actual_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def q_size(self) -> int:
        return self.num_attention_heads * self.actual_head_dim

    @property
    def kv_size(self) -> int:
        return self.num_key_value_heads * self.actual_head_dim

    @classmethod
    def from_hf(cls, hf_config, **overrides) -> "LlamaConfig":
        """Build from a HF ``config.json``: the parsed dict (the card's
        machine has no ``transformers``) or a config object. Training
        knobs (dtypes, ...) come in ``overrides``."""
        get = hf_field(hf_config)
        kw = dict(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            intermediate_size=get("intermediate_size"),
            num_hidden_layers=get("num_hidden_layers"),
            num_attention_heads=get("num_attention_heads"),
            num_key_value_heads=get("num_key_value_heads",
                                    get("num_attention_heads")),
            head_dim=get("head_dim", None),
            max_position_embeddings=get("max_position_embeddings"),
            rope_theta=get("rope_theta", 10000.0),
            rms_norm_eps=get("rms_norm_eps", 1e-6),
            tie_word_embeddings=get("tie_word_embeddings", False),
        )
        kw.update(overrides)
        return cls(**kw)

    def num_params(self) -> int:
        h, i, l, v = (self.hidden_size, self.intermediate_size,
                      self.num_hidden_layers, self.vocab_size)
        attn = h * self.q_size + 2 * h * self.kv_size + self.q_size * h
        mlp = 3 * h * i
        norms = 2 * h + (2 * self.actual_head_dim if self.qk_norm else 0)
        embed = v * h
        head = 0 if self.tie_word_embeddings else v * h
        return l * (attn + mlp + norms) + embed + h + head


def _param_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[Tuple[int, ...], bool]]:
    """Flat name -> (shape, is_norm) in the reference layout."""
    l, h = cfg.num_hidden_layers, cfg.hidden_size
    i, v, dh = cfg.intermediate_size, cfg.vocab_size, cfg.actual_head_dim
    shapes = {
        "embed_tokens": ((v, h), False),
        "layers.input_layernorm": ((l, h), True),
        "layers.q_proj": ((l, h, cfg.q_size), False),
        "layers.k_proj": ((l, h, cfg.kv_size), False),
        "layers.v_proj": ((l, h, cfg.kv_size), False),
        "layers.o_proj": ((l, cfg.q_size, h), False),
        "layers.post_attention_layernorm": ((l, h), True),
        "layers.gate_proj": ((l, h, i), False),
        "layers.up_proj": ((l, h, i), False),
        "layers.down_proj": ((l, i, h), False),
        "norm": ((h,), True),
    }
    if cfg.qk_norm:
        shapes["layers.q_norm"] = ((l, dh), True)
        shapes["layers.k_norm"] = ((l, dh), True)
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = ((h, v), False)
    return shapes


def init_params(
    cfg: LlamaConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    *,
    requires_grad: bool = False,
    local_slice: Optional[Callable[[str, Tensor], Tensor]] = None,
) -> Params:
    """Random parameters with the reference's distributions, as a nested
    dict of ``param_dtype`` tensors on ``device``: fan-in uniform
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for projections, ones for norms,
    normal(0, 0.02) for the embedding. ``generator`` must live on
    ``device`` (default: a fresh one seeded with 0). ``requires_grad``
    makes the leaves the trainable masters of the training forward.
    ``local_slice(name, leaf)``, applied to each leaf as soon as it is
    drawn, keeps this rank's part of it (``models.convert.
    local_shard_fn``): every rank draws the same full leaves in the same
    order, so the shards are those of one card's parameters. The draws
    are not JAX's threefry draws; parity tests carry JAX parameters
    across with ``models.convert`` instead."""
    dev = resolve_device(device)
    generator = init_generator(generator, dev)
    pd = cfg.param_dtype
    params: Params = {"layers": {}}
    for name, (shape, is_norm) in _param_shapes(cfg).items():
        if is_norm:
            t = torch.ones(shape, dtype=pd, device=dev)
        elif name == "embed_tokens":
            t = torch.empty(shape, dtype=pd, device=dev).normal_(
                0.0, 0.02, generator=generator)
        else:
            bound = 1.0 / math.sqrt(shape[-2])  # fan_in: the [in] axis
            t = torch.empty(shape, dtype=pd, device=dev).uniform_(
                -bound, bound, generator=generator)
        if local_slice is not None:
            t = local_slice(name, t)
        t.requires_grad_(requires_grad)
        if name.startswith("layers."):
            params["layers"][name[len("layers."):]] = t
        else:
            params[name] = t
    return params


# ---- training forward ---------------------------------------------------------
def tp_region_helpers(tp_axis: Optional[str], sequence_parallel: bool
                      ) -> Tuple[Callable, Callable]:
    """(enter_full_seq, row): how a block's normed activation enters the
    rank-local region and how the row-parallel product leaves it; for
    ``tp_axis`` None, the identity and a plain product."""
    if tp_axis is None:
        return (lambda h: h), (lambda h, w: h @ w)
    from scaletorch_tpu_torch.parallel.sequence_parallel import (
        all_gather_sequence,
    )
    from scaletorch_tpu_torch.parallel.tensor_parallel import (
        copy_to_tensor_parallel_region,
        row_parallel_linear,
    )

    def enter_full_seq(h):
        if sequence_parallel:
            return all_gather_sequence(h, tp_axis)
        return copy_to_tensor_parallel_region(h, tp_axis)

    def row(h, w):
        return row_parallel_linear(h, w, axis=tp_axis,
                                   sequence_parallel=sequence_parallel)

    return enter_full_seq, row


def attention_block(
    x: Tensor,
    layer: Dict[str, Tensor],
    cos: Tensor,
    sin: Tensor,
    cfg: LlamaConfig,
    attn_fn: Callable,
    helpers: Optional[Tuple[Callable, Callable]] = None,
) -> Tensor:
    """Pre-norm attention sub-block with residual. x: [B, S, H] in compute
    dtype; ``layer`` holds one layer's fp32 weights; ``helpers`` are
    ``tp_region_helpers``' (default: one device)."""
    cdt = cfg.dtype
    dh = cfg.actual_head_dim
    enter_full_seq, row = helpers or tp_region_helpers(None, False)
    h = enter_full_seq(rms_norm(x, layer["input_layernorm"],
                                cfg.rms_norm_eps))
    b, s, _ = h.shape
    q = (h @ layer["q_proj"].to(cdt)).view(b, s, -1, dh)
    k = (h @ layer["k_proj"].to(cdt)).view(b, s, -1, dh)
    v = (h @ layer["v_proj"].to(cdt)).view(b, s, -1, dh)
    if cfg.qk_norm:
        # Qwen3: RMSNorm over head_dim, per head, before RoPE
        q = rms_norm(q, layer["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, layer["k_norm"], cfg.rms_norm_eps)
    q = q.transpose(1, 2)  # [B, H, S, D]
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    q, k = apply_rotary_pos_emb(q, k, cos, sin)
    attn = attn_fn(q, k, v, causal=True)
    attn = attn.transpose(1, 2).reshape(b, s, -1)
    return x + row(attn, layer["o_proj"].to(cdt))


def _decoder_layer(
    x: Tensor,
    layer: Dict[str, Tensor],
    cos: Tensor,
    sin: Tensor,
    cfg: LlamaConfig,
    attn_fn: Callable,
    tp_axis: Optional[str] = None,
    sequence_parallel: bool = False,
    layer_gather: Optional[Callable] = None,
) -> Tensor:
    """One pre-norm decoder block: attention, then the SwiGLU MLP. With
    ``tp_axis`` the weights are this rank's shards and, under
    ``sequence_parallel``, x is this rank's sequence slice. With
    ``layer_gather`` (FSDP) the weights are shards, gathered here, so a
    recomputed layer gathers them again."""
    if layer_gather is not None:
        layer = layer_gather(layer)
    cdt = cfg.dtype
    helpers = tp_region_helpers(tp_axis, sequence_parallel)
    enter_full_seq, row = helpers
    x = attention_block(x, layer, cos, sin, cfg, attn_fn, helpers)
    h = rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps)
    h = enter_full_seq(h)
    gate = h @ layer["gate_proj"].to(cdt)
    up = h @ layer["up_proj"].to(cdt)
    return x + row(swiglu(gate, up), layer["down_proj"].to(cdt))


def embed(params: Params, input_ids: Tensor, cfg: LlamaConfig, *,
          tp_axis: Optional[str] = None,
          sequence_parallel: bool = False) -> Tensor:
    """Token embedding: [B, S] -> [B, S(/tp under SP), H] in compute
    dtype; with ``tp_axis`` the table is this rank's vocab rows (the
    vocab-parallel lookup, its partial sums completed by the all-reduce
    or, under SP, by the sequence reduce-scatter)."""
    if sequence_parallel and tp_axis is None:
        raise ValueError("sequence_parallel requires tp_axis")
    if tp_axis is None:
        return params["embed_tokens"][input_ids.long()].to(cfg.dtype)
    from scaletorch_tpu_torch.parallel.sequence_parallel import (
        reduce_scatter_sequence,
    )
    from scaletorch_tpu_torch.parallel.tensor_parallel import (
        vocab_parallel_embedding,
    )

    if sequence_parallel:
        partial = vocab_parallel_embedding(
            input_ids, params["embed_tokens"], axis=tp_axis, reduce="none")
        return reduce_scatter_sequence(partial.to(cfg.dtype), tp_axis)
    return vocab_parallel_embedding(
        input_ids, params["embed_tokens"], axis=tp_axis).to(cfg.dtype)


def final_hidden(params: Params, x: Tensor, cfg: LlamaConfig, *,
                 tp_axis: Optional[str] = None,
                 sequence_parallel: bool = False) -> Tensor:
    """The final RMSNorm before the LM head. With ``tp_axis`` the result
    enters the vocab-parallel head's region: the sequence all-gather
    under SP, else ``copy_to_tensor_parallel_region`` (so the head's
    per-shard gradients are summed)."""
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    if tp_axis is None:
        return x
    enter_full_seq, _ = tp_region_helpers(tp_axis, sequence_parallel)
    return enter_full_seq(x)


REMAT_POLICIES = ("nothing_saveable", "dots_saveable",
                  "dots_with_no_batch_dims_saveable", "save_attn")

_aten = torch.ops.aten
# a matrix product without batch dims, as JAX's dot_general lowers one:
# [B, S, H] x [H, N] folds to mm
_NO_BATCH_DOTS = (_aten.mm.default, _aten.addmm.default)
_DOTS = _NO_BATCH_DOTS + (_aten.bmm.default, _aten.baddbmm.default)


@torch.library.custom_op("scaletorch_tpu_torch::attn_out", mutates_args=())
def attn_out(x: Tensor) -> Tensor:
    """A copy of the attention output, named for the ``save_attn`` policy
    (the reference's ``checkpoint_name(attn, "attn_out")``). Used only
    under that policy, for a backend whose own op is not saved."""
    return x.clone()


@attn_out.register_fake
def _attn_out_fake(x: Tensor) -> Tensor:
    return torch.empty_like(x)


attn_out.register_autograd(lambda ctx, grad: grad)


def _saved_ops(name: str) -> Tuple[Any, ...]:
    """The ops whose outputs a policy keeps for the backward."""
    if name == "dots_saveable":
        return _DOTS
    if name == "dots_with_no_batch_dims_saveable":
        return _NO_BATCH_DOTS
    from scaletorch_tpu_torch.ops.flash import FLASH_FORWARD_OP
    from scaletorch_tpu_torch.ops.ring_attention import RING_ATTENTION_OP
    from scaletorch_tpu_torch.ops.ulysses import ULYSSES_ATTENTION_OP

    return (FLASH_FORWARD_OP, RING_ATTENTION_OP, ULYSSES_ATTENTION_OP,
            torch.ops.scaletorch_tpu_torch.attn_out.default)


def resolve_remat_policy(name: str) -> Optional[Callable]:
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a config-level
    gradient-checkpointing policy (reference ``resolve_remat_policy``):

      * ``nothing_saveable``: None, the whole layer is recomputed;
      * ``dots_saveable``: every matrix product's output is saved (``mm``,
        ``addmm``, ``bmm``, ``baddbmm``);
      * ``dots_with_no_batch_dims_saveable``: only ``mm`` and ``addmm``;
      * ``save_attn``: K1's ``(out, lse)`` (the ``flash_forward`` op),
        the context-parallel ring's or Ulysses' whole op (its output and
        residuals: the recomputation re-issues none of its exchanges),
        or the ``attn_out`` copy of another backend's output.

    The cp backends run as one op each (``ops/ring_attention.py``,
    ``ops/ulysses.py``), so a policy never saves a part of their
    exchanges: the dots policies recompute them whole, in order.

    A kernel of the port is never a dot, as a Pallas kernel is not one in
    JAX. An unknown name raises."""
    if name not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {name!r}; have {sorted(REMAT_POLICIES)}")
    if name == "nothing_saveable":
        return None
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
    )

    saved = _saved_ops(name)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def remat_attn_fn(attn_fn: Callable, remat_policy: str) -> Callable:
    """``attn_fn`` with its output passed through ``attn_out`` under
    ``save_attn``, unless the backend saves its own residuals (``flash``:
    K1's op)."""
    if (remat_policy != "save_attn"
            or getattr(attn_fn, "saves_attn_residuals", False)):
        return attn_fn

    def named(q, k, v, **kw):
        return attn_out(attn_fn(q, k, v, **kw))

    return named


def checkpointed(fn: Callable, *args: Any, context_fn: Optional[Callable]):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant), with
    a selective policy's ``context_fn`` when there is one."""
    if context_fn is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)


def decoder_stack(
    x: Tensor,
    layers: Dict[str, Tensor],
    cos: Tensor,
    sin: Tensor,
    cfg: LlamaConfig,
    attn_fn: Callable,
    *,
    tp_axis: Optional[str] = None,
    sequence_parallel: bool = False,
    gradient_checkpointing: bool = False,
    remat_policy: str = "nothing_saveable",
    active_layers: Optional[int] = None,
    layer_gather: Optional[Callable] = None,
) -> Tensor:
    """Run every layer of a stack (leading axis = layer index) over x.

    The stacked leaves are unbound once, so each leaf's gradient is one
    stack of the per-layer gradients. With ``gradient_checkpointing`` each
    layer runs under ``checkpoint(..., use_reentrant=False)`` with the
    policy's ``context_fn``: its input and what the policy saves are
    kept, and the backward recomputes the rest of the layer.

    ``active_layers`` k (an uneven pipeline stage) runs the first k slots
    only: the later ones are identity padding, never run, so their
    parameters get zero gradient. ``layer_gather`` (FSDP's) makes each
    layer's full weights from its shards inside the layer."""
    if gradient_checkpointing:
        context_fn = resolve_remat_policy(remat_policy)
        attn_fn = remat_attn_fn(attn_fn, remat_policy)
    names = list(layers)
    per_layer = zip(*(layers[n].unbind(0) for n in names))
    if active_layers is not None:
        per_layer = list(per_layer)[:active_layers]
    for weights in per_layer:
        layer = dict(zip(names, weights))
        if gradient_checkpointing:
            x = checkpointed(_decoder_layer, x, layer, cos, sin, cfg, attn_fn,
                             tp_axis, sequence_parallel, layer_gather,
                             context_fn=context_fn)
        else:
            x = _decoder_layer(x, layer, cos, sin, cfg, attn_fn,
                               tp_axis, sequence_parallel, layer_gather)
    return x


def forward(
    params: Params,
    input_ids: Tensor,
    cfg: LlamaConfig,
    *,
    positions: Optional[Tensor] = None,
    attention_backend: Any = "sdpa",
    gradient_checkpointing: bool = False,
    remat_policy: str = "nothing_saveable",
    tp_axis: Optional[str] = None,
    sequence_parallel: bool = False,
    return_hidden: bool = False,
    layer_gather: Optional[Callable] = None,
) -> Tensor:
    """Full decoder forward: [B, S] tokens -> logits [B, S, V] in compute
    dtype, or the final hidden states [B, S, H] with ``return_hidden``
    (the caller applies ``lm_head_weight``, e.g. the fused chunked CE).
    ``positions`` [S] overrides 0..S-1 for the RoPE tables (a context-
    parallel rank passes its shard's positions). ``attention_backend``
    is a registered name or the backend itself. With ``tp_axis`` the
    parameters are this rank's shards and the logits are vocab-sharded
    [B, S, V/tp]. ``layer_gather`` (FSDP's ``FsdpGather.layer``): the
    stacked leaves are shards, each layer's gathered inside it."""
    x = embed(params, input_ids, cfg, tp_axis=tp_axis,
              sequence_parallel=sequence_parallel)
    cos, sin = get_cos_sin(input_ids.shape[1], cfg.actual_head_dim,
                           cfg.rope_theta, positions=positions,
                           device=input_ids.device)
    attn_fn = (attention_backend if callable(attention_backend)
               else get_attention_backend(attention_backend))
    x = decoder_stack(x, params["layers"], cos, sin, cfg, attn_fn,
                      tp_axis=tp_axis, sequence_parallel=sequence_parallel,
                      gradient_checkpointing=gradient_checkpointing,
                      remat_policy=remat_policy, layer_gather=layer_gather)
    x = final_hidden(params, x, cfg, tp_axis=tp_axis,
                     sequence_parallel=sequence_parallel)
    if return_hidden:
        return x
    return x @ lm_head_weight(params, cfg)


def lm_head_weight(params: Params, cfg: LlamaConfig) -> Tensor:
    """[H, V] head weight in compute dtype (tied-embedding aware)."""
    if cfg.tie_word_embeddings:
        return params["embed_tokens"].to(cfg.dtype).T
    return params["lm_head"].to(cfg.dtype)


register_attention_backend("sdpa", sdpa_attention)


# ---- KV-cache inference path --------------------------------------------------
def attention_block_cached(
    x: Tensor,
    layer: Dict[str, Tensor],
    cache_k: Tensor,
    cache_v: Tensor,
    cos: Tensor,
    sin: Tensor,
    positions: Tensor,
    cfg: LlamaConfig,
    *,
    write_mask: Optional[Tensor] = None,
    kv_io: Optional[Any] = None,
    tp_axis: Optional[str] = None,
) -> Tensor:
    """Cache-aware pre-norm attention sub-block with residual.

    x: [B, S, H]; cache_k/cache_v: one layer's cache, [B, Hkv, S_max, D]
    (or the ``kv_io`` adapter's layout, e.g. the paged pool), written IN
    PLACE at ``positions`` [B, S]; attention runs q-against-cache with
    the j <= p mask. Returns the block output. With ``tp_axis`` the
    weights and the cache hold this rank's heads (q/k/v column-parallel)
    and ``o_proj`` is row-parallel: one all-reduce.
    """
    enter, row = tp_region_helpers(tp_axis, False)
    dh = cfg.actual_head_dim
    h = enter(rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps))
    b, s, _ = h.shape
    q = (h @ layer["q_proj"]).view(b, s, -1, dh)
    k = (h @ layer["k_proj"]).view(b, s, -1, dh)
    v = (h @ layer["v_proj"]).view(b, s, -1, dh)
    if cfg.qk_norm:
        q = rms_norm(q, layer["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, layer["k_norm"], cfg.rms_norm_eps)
    q = q.transpose(1, 2)  # [B, Hq, S, D]
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    q, k = apply_rotary_pos_emb(q, k, cos, sin)
    if kv_io is None:
        write_kv_cache(cache_k, k, positions[:, 0], write_mask)
        write_kv_cache(cache_v, v, positions[:, 0], write_mask)
        attn = cached_sdpa_attention(q, cache_k, cache_v, positions)
    else:
        kv_io.write(cache_k, k, positions, write_mask)
        kv_io.write(cache_v, v, positions, write_mask)
        attn = kv_io.attend(q, cache_k, cache_v, positions)
    attn = attn.transpose(1, 2).reshape(b, s, -1)
    return x + row(attn, layer["o_proj"])


def mlp_block(x: Tensor, layer: Dict[str, Tensor], cfg: LlamaConfig, *,
              tp_axis: Optional[str] = None) -> Tensor:
    """Dense SwiGLU MLP sub-block with residual; with ``tp_axis`` gate/up
    column-parallel and down row-parallel (one all-reduce)."""
    enter, row = tp_region_helpers(tp_axis, False)
    h = enter(rms_norm(x, layer["post_attention_layernorm"],
                       cfg.rms_norm_eps))
    gate = h @ layer["gate_proj"]
    up = h @ layer["up_proj"]
    return x + row(swiglu(gate, up), layer["down_proj"])


class LlamaForCausalLM(nn.Module):
    """The decoder with weights in the reference layout (see the module
    docstring). Built empty on ``device`` (None = the CUDA card); fill it
    with ``models.convert.load_numpy_params``, build it with
    ``from_params`` or draw it with ``init_weights_``. Weights carry no
    gradient: it serves.

    With ``mesh`` (a ``parallel.mesh.MeshManager`` whose tp axis has size
    > 1) the module holds this rank's tensor-parallel shards, cut as
    training cuts them (``models.convert.local_shard_fn``): q/k/v and
    gate/up by output columns, o/down by input rows, the embedding by
    vocab rows and the untied head by vocab columns; ``forward_cached``
    runs the tp path (the mesh must be current: ``using_mesh_manager``)
    and returns the full-vocabulary logits on every rank."""

    def __init__(self, cfg: LlamaConfig, device: DeviceLike = None, *,
                 mesh: Any = None) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.tp_size = mesh.tp if mesh is not None else 1
        self.tp_axis = "tp" if self.tp_size > 1 else None
        # this rank's part of a full leaf (None: the leaves are whole)
        self._local = None
        if self.tp_axis is not None:
            from scaletorch_tpu_torch.models.convert import local_shard_fn

            self._local = local_shard_fn(cfg, mesh, mesh.rank)
        layers: Dict[str, nn.Parameter] = {}
        for name, (shape, is_norm) in _param_shapes(cfg).items():
            if self._local is not None:
                shape = tuple(self._local(
                    name, torch.empty(shape, device="meta")).shape)
            dtype = cfg.param_dtype if is_norm else cfg.dtype
            p = nn.Parameter(torch.empty(shape, dtype=dtype, device=dev),
                             requires_grad=False)
            if name.startswith("layers."):
                layers[name[len("layers."):]] = p
            else:
                self.register_parameter(name, p)
        if cfg.tie_word_embeddings:
            self.lm_head = None
        self.layers = nn.ParameterDict(layers)

    @classmethod
    def from_params(cls, params: Params, cfg: LlamaConfig,
                    device: DeviceLike = None, *,
                    mesh: Any = None) -> "LlamaForCausalLM":
        """A model holding ``params`` (a nested dict of tensors or numpy
        arrays in the reference layout, e.g. ``init_params``'s output);
        with ``mesh``, this rank's slices of the full tree."""
        from scaletorch_tpu_torch.models.convert import (
            load_numpy_params,
            shard_numpy_params,
        )

        model = cls(cfg, device=device, mesh=mesh)
        if model.tp_axis is not None:
            params = shard_numpy_params(params, cfg, mesh, mesh.rank)
        load_numpy_params(model, params)
        return model

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator
                      ) -> "LlamaForCausalLM":
        """Random weights with ``init_params``' distributions (ones for
        norms, N(0, 0.02) for the embedding, fan-in uniform for the
        projections), drawn on the parameters' device in ``param_dtype``
        one layer slice at a time, in one order whatever the mesh: every
        rank draws the full slices and keeps its part, so the shards are
        one card's weights (the draws differ from ``init_params``')."""
        full = _param_shapes(self.cfg)
        for name, p in self.named_parameters():
            shape, is_norm = full[name]
            if is_norm:
                p.fill_(1.0)
                continue
            stacked = name.startswith("layers.")
            parts = p.unbind(0) if stacked else (p,)
            draw = shape[1:] if stacked else shape
            for part in parts:
                tmp = torch.empty(draw, dtype=self.cfg.param_dtype,
                                  device=p.device)
                if name == "embed_tokens":
                    tmp.normal_(0.0, 0.02, generator=generator)
                else:
                    bound = 1.0 / math.sqrt(shape[-2])
                    tmp.uniform_(-bound, bound, generator=generator)
                if self._local is not None:  # one layer is a stack of one
                    tmp = (self._local(name, tmp[None])[0] if stacked
                           else self._local(name, tmp))
                part.copy_(tmp)
        return self

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def lm_head_weight(self) -> Tensor:
        """[H, V] head weight in compute dtype (tied-embedding aware)."""
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
    ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
        """[B, S] tokens at absolute ``positions`` [B, S] -> (logits
        [B, S, V] in compute dtype, the cache pair updated in place).

        ``last_index`` [B] keeps only row ``last_index[b]`` of each slot
        before the final norm and head -> logits [B, 1, V]: the same
        function at the one row a prefill samples from, without the
        [B, S, V] logits buffer.
        """
        cfg = self.cfg
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
        names = list(self.layers.keys())
        per_layer = zip(*(self.layers[n].unbind(0) for n in names))
        for i, weights in enumerate(per_layer):
            layer = dict(zip(names, weights))
            x = attention_block_cached(
                x, layer, cache_k[i], cache_v[i], cos, sin, positions, cfg,
                write_mask=write_mask, kv_io=kv_io, tp_axis=tp)
            x = mlp_block(x, layer, cfg, tp_axis=tp)
        if last_index is not None:
            rows = torch.arange(x.shape[0], device=x.device)
            x = x[rows, last_index.long()][:, None]
        x = rms_norm(x, self.norm, cfg.rms_norm_eps)
        logits = x @ self.lm_head_weight()
        if tp is not None:
            # the vocab-parallel head's columns, gathered: every rank
            # samples from the same full-vocabulary bits
            from scaletorch_tpu_torch.parallel.tensor_parallel import (
                gather_from_tensor_parallel_region,
            )

            logits = gather_from_tensor_parallel_region(logits, tp)
        return logits, (cache_k, cache_v)


def forward_cached(
    model: LlamaForCausalLM,
    input_ids: Tensor,
    cfg: LlamaConfig,
    cache: Tuple[Tensor, Tensor],
    **kw: Any,
) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Functional entry with the JAX package's ``forward_fn`` signature
    ``(params, tokens, cfg, cache, **kw)``; ``params`` is the model."""
    if model.cfg != cfg:
        raise ValueError("the model was built for another config")
    return model.forward_cached(input_ids, cache, **kw)
