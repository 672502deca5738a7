"""GPT with capacity-routed MoE experts: the minGPT model of the examples.

Counterpart of scaletorch_tpu/models/gpt_moe.py. The parameter layout is
the reference's, so a JAX tree carries across with
``models/convert.gpt_moe_from_jax``:

  * ``wte [V, D]`` (tied with the head), ``wpe [block_size, D]``,
    ``ln_f [D]``;
  * ``layers``, stacked on axis 0: ``ln1``, ``ln2 [L, D]``, ``attn_qkv
    [L, D, 3D]``, ``attn_proj [L, D, D]``, and either the MoE keys
    ``router``, ``router_noise [L, D, E]``, ``expert_fc [L, E, D, 4D]``,
    ``expert_proj [L, E, 4D, D]`` or the dense ``mlp_fc [L, D, 4D]``,
    ``mlp_proj [L, 4D, D]``.

The arithmetic follows the reference's casts: LayerNorm in fp32 with the
population variance, eps 1e-5 and no bias; tanh-approximated GELU (JAX's
default); learned absolute positions (no RoPE); attention through the
plain ``sdpa_attention`` / ``cached_sdpa_attention``. Each batch row is
one routing group whose capacity is ``expert_capacity`` over the row's
whole length, routed and moved by ``parallel/expert_parallel.py``. Noisy
top-k draws one ``torch.randn(logits.shape, generator=g)`` per layer, in
layer order, from the caller's generator.

The functions take the parameter tree (a nested dict of tensors);
``GPTMoEForCausalLM`` holds one as an ``nn.Module`` and is what the
engine's steps call through the functional ``forward_cached``. Built
with a serving ``mesh`` whose tp axis splits, the module holds a rank's
slices (``gpt_moe_param_specs``): q/k/v by heads, the attention output
row-parallel, each expert's fc by columns and proj by rows; the router,
the norms, the positions and the tied head whole. ``forward_cached``
then completes each layer with two all-reduces over tp, one after the
attention's output projection and one after the MoE FFN, so every rank
routes every token alike and returns the full logits. Sampling
(``generate`` with a temperature) draws from a torch generator, so only
greedy continuations equal the reference's token for token.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scaletorch_tpu_torch.models.layers import (
    cached_sdpa_attention,
    init_generator,
    normal_init,
    sdpa_attention,
    write_kv_cache,
)
from scaletorch_tpu_torch.parallel.expert_parallel import (
    combine_routed,
    dispatch_routed,
    expert_capacity,
    resolve_moe_dispatch,
    route_tokens,
)
from scaletorch_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor
Params = Dict[str, Any]


@dataclass(frozen=True)
class GPTMoEConfig:
    """The reference's ``GPTMoEConfig`` knobs."""

    block_size: int = 256
    vocab_size: int = 65
    n_layer: int = 4
    n_head: int = 4
    n_embd: int = 128
    # MoE
    use_moe: bool = True
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 0.001
    router_noise_std: float = 1.0
    norm_topk_prob: bool = True
    moe_dispatch: str = "auto"  # einsum | index; auto = index
    dtype: torch.dtype = torch.float32

    def resolved_moe_dispatch(self) -> str:
        return resolve_moe_dispatch(self.moe_dispatch, self.num_experts)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def param_shapes(cfg: GPTMoEConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat name -> shape of every leaf, in ``init_params``' draw order
    (the norms, all ones, last)."""
    l, d, v, e = cfg.n_layer, cfg.n_embd, cfg.vocab_size, cfg.num_experts
    i = 4 * d
    shapes = {"layers.attn_qkv": (l, d, 3 * d), "layers.attn_proj": (l, d, d)}
    if cfg.use_moe:
        shapes.update({"layers.router": (l, d, e),
                       "layers.router_noise": (l, d, e),
                       "layers.expert_fc": (l, e, d, i),
                       "layers.expert_proj": (l, e, i, d)})
    else:
        shapes.update({"layers.mlp_fc": (l, d, i),
                       "layers.mlp_proj": (l, i, d)})
    shapes.update({"wte": (v, d), "wpe": (cfg.block_size, d),
                   "layers.ln1": (l, d), "layers.ln2": (l, d),
                   "ln_f": (d,)})
    return shapes


def gpt_moe_param_specs(cfg: GPTMoEConfig) -> Dict[str, object]:
    """The dim of each leaf that splits over tp (None: replicated), in the
    parameter dict's nesting (``tensor_parallel.llama_param_specs``' form;
    layers stacked on dim 0). ``attn_qkv``'s columns hold q, k and v one
    after the other, each cut by heads (``models.convert`` takes the
    rank's heads of each of the three, ``TP_FUSED_PARTS``); ``attn_proj``
    splits its input rows (row-parallel); each expert's ``expert_fc``
    splits its columns and ``expert_proj`` its rows (the dense
    ``mlp_fc`` / ``mlp_proj`` alike); the router, its noise projection,
    the norms, ``wpe`` and the tied ``wte`` stay whole."""
    layers: Dict[str, Optional[int]] = {
        "ln1": None, "ln2": None, "attn_qkv": 2, "attn_proj": 1}
    if cfg.use_moe:
        layers.update(router=None, router_noise=None, expert_fc=3,
                      expert_proj=2)
    else:
        layers.update(mlp_fc=2, mlp_proj=1)
    return {"wte": None, "wpe": None, "ln_f": None, "layers": layers}


# flat leaf -> the number of equal blocks along its tp dim that are each
# split over tp (q | k | v of the fused projection)
TP_FUSED_PARTS = {"layers.attn_qkv": 3}


def check_serving_mesh(cfg: GPTMoEConfig, mesh: Any) -> None:
    """A GPT-MoE serving mesh spans tp (and replicas over dp): tp divides
    the heads (and so the width and the experts' 4x inner width); pp, cp
    and ep are refused."""
    if mesh.pp > 1 or mesh.cp > 1 or mesh.ep > 1:
        raise ValueError(
            f"a GPT-MoE serving mesh spans tp and dp only, got {mesh!r}")
    if cfg.n_head % mesh.tp:
        raise ValueError(f"tp={mesh.tp} does not split {cfg.n_head} heads")


def _init_std(name: str, cfg: GPTMoEConfig) -> Optional[float]:
    """N(0, std²) of a leaf; None for the norms (ones)."""
    if name in ("layers.ln1", "layers.ln2", "ln_f"):
        return None
    if name in ("layers.attn_proj", "layers.expert_proj", "layers.mlp_proj"):
        return 0.02 / (2 * cfg.n_layer) ** 0.5
    return 0.02


def _nest(flat: Dict[str, Any]) -> Params:
    tree: Params = {"layers": {}}
    for name, leaf in flat.items():
        if name.startswith("layers."):
            tree["layers"][name[len("layers."):]] = leaf
        else:
            tree[name] = leaf
    return tree


def init_params(generator: Optional[torch.Generator], cfg: GPTMoEConfig,
                *, device: DeviceLike = None) -> Params:
    """Fresh fp32 parameters with the reference's distributions (the draws
    differ from JAX's PRNG) on ``device`` (None: the CUDA card), drawn
    from ``generator`` on its own device (default: a fresh one on
    ``device`` seeded with 0)."""
    dev = resolve_device(device)
    generator = init_generator(generator, dev)
    flat = {}
    for name, shape in param_shapes(cfg).items():
        std = _init_std(name, cfg)
        flat[name] = (torch.ones(shape, device=dev) if std is None else
                      normal_init(generator, shape, std, device=dev))
    return _nest(flat)


def scale_matrices(params: Params, factor: float) -> Params:
    """A copy of a nested tree (tensors or any arrays) with every leaf but
    the LayerNorm gains multiplied by ``factor``. At the init's std of
    0.02 a random GPT answers every prompt with one token; scaled by 10
    its greedy tokens move, which is what a serving check needs."""
    return {k: (scale_matrices(v, factor) if isinstance(v, dict) else
                v if k.startswith("ln") else v * factor)
            for k, v in params.items()}


def _tree(params) -> Params:
    return params.tree() if isinstance(params, GPTMoEForCausalLM) else params


def _layer_norm(x: Tensor, w: Tensor) -> Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return ((x32 - mu) / torch.sqrt(var + 1e-5) * w).to(x.dtype)


def _gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")


def _moe_ffn(h: Tensor, layer: Params, cfg: GPTMoEConfig,
             generator: Optional[torch.Generator], ep_axis: Optional[str],
             with_aux: bool = True) -> Tuple[Tensor, Tensor]:
    """Noisy-top-k routed GELU experts over h [G, S, D] -> (y, the
    coefficient-scaled aux loss). Without ``with_aux`` (serving) the aux
    loss is not computed and is returned as 0; the decisions are the
    same."""
    g, s, d = h.shape
    logits = torch.einsum("gsh,he->gse", h, layer["router"])
    if generator is not None and cfg.router_noise_std > 0:
        # a learned per-token noise scale, softplus'd, times a standard
        # normal draw
        noise_scale = F.softplus(
            torch.einsum("gsh,he->gse", h, layer["router_noise"]))
        noise = torch.randn(logits.shape, generator=generator,
                            device=generator.device).to(logits.device)
        logits = logits + cfg.router_noise_std * noise_scale * noise
    cap = expert_capacity(s, cfg.num_experts, cfg.top_k, cfg.capacity_factor)
    mode = cfg.resolved_moe_dispatch()
    state, aux = route_tokens(logits, cfg.top_k, cap, mode=mode,
                              normalize_weights=cfg.norm_topk_prob,
                              with_aux=with_aux)
    moved = dict(mode=mode, num_experts=cfg.num_experts, capacity=cap,
                 axis=ep_axis)
    slots = dispatch_routed(h, state, **moved)
    act = _gelu(torch.einsum("eth,ehi->eti", slots,
                             layer["expert_fc"].to(h.dtype)))
    out = torch.einsum("eti,eih->eth", act, layer["expert_proj"].to(h.dtype))
    y = combine_routed(out, state, **moved)
    if aux is None:
        return y, h.new_zeros((), dtype=torch.float32)
    aux_loss = (cfg.aux_loss_weight * aux["aux_loss"].mean()
                + cfg.z_loss_weight * aux["z_loss"].mean())
    return y, aux_loss


def _heads(t: Tensor, cfg: GPTMoEConfig) -> Tensor:
    """[B, S, h * head_dim] -> [B, h, S, head_dim] (h: every head, or a tp
    rank's)."""
    b, s, _ = t.shape
    return t.reshape(b, s, -1, cfg.head_dim).transpose(1, 2)


def _tp_sum(x: Tensor, tp_axis: Optional[str]) -> Tensor:
    """A row-parallel product's partial sums added over tp (``x`` itself
    without a tp axis)."""
    if tp_axis is None:
        return x
    from scaletorch_tpu_torch.parallel.mesh import all_reduce_, axis_group

    return all_reduce_(x, axis_group(tp_axis))


def _per_layer(layers: Params):
    names = list(layers)
    return [dict(zip(names, w))
            for w in zip(*(layers[n].unbind(0) for n in names))]


def _mlp(m: Tensor, layer: Params, cfg: GPTMoEConfig,
         generator: Optional[torch.Generator], ep_axis: Optional[str],
         with_aux: bool) -> Tuple[Tensor, Tensor]:
    if cfg.use_moe:
        return _moe_ffn(m, layer, cfg, generator, ep_axis, with_aux)
    cdt = cfg.dtype
    y = _gelu(m @ layer["mlp_fc"].to(cdt)) @ layer["mlp_proj"].to(cdt)
    return y, m.new_zeros((), dtype=torch.float32)


def forward(params, input_ids: Tensor, cfg: GPTMoEConfig, *,
            generator: Optional[torch.Generator] = None,
            ep_axis: Optional[str] = None, return_aux: bool = False):
    """[B, S] -> logits [B, S, V] (and the aux loss summed over the layers
    with ``return_aux``). ``generator`` turns on noisy routing
    (training); without it routing is deterministic (eval)."""
    p = _tree(params)
    b, s = input_ids.shape
    cdt = cfg.dtype
    x = (p["wte"][input_ids.long()] + p["wpe"][:s]).to(cdt)
    aux_total = x.new_zeros((), dtype=torch.float32)
    for layer in _per_layer(p["layers"]):
        a = _layer_norm(x, layer["ln1"])
        q, k, v = (a @ layer["attn_qkv"].to(cdt)).split(cfg.n_embd, dim=-1)
        o = sdpa_attention(_heads(q, cfg), _heads(k, cfg), _heads(v, cfg),
                           causal=True)
        o = o.transpose(1, 2).reshape(b, s, cfg.n_embd)
        x = x + o @ layer["attn_proj"].to(cdt)
        y, aux = _mlp(_layer_norm(x, layer["ln2"]), layer, cfg, generator,
                      ep_axis, with_aux=True)
        x = x + y.to(cdt)
        aux_total = aux_total + aux
    x = _layer_norm(x, p["ln_f"])
    logits = x @ p["wte"].to(cdt).T  # weight tying
    return (logits, aux_total) if return_aux else logits


def init_cache(cfg: GPTMoEConfig, batch: int, dtype: Optional[torch.dtype]
               = None, *, device: DeviceLike = None) -> Tuple[Tensor, Tensor]:
    """Zeroed per-layer cache pair [L, B, n_head, block_size, head_dim]
    (full per-head K/V, no grouping)."""
    shape = (cfg.n_layer, batch, cfg.n_head, cfg.block_size, cfg.head_dim)
    dev = resolve_device(device)
    dt = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


def _forward_cached(p: Params, input_ids: Tensor, cfg: GPTMoEConfig,
                    cache: Tuple[Tensor, Tensor], *, positions: Tensor,
                    write_mask: Optional[Tensor] = None,
                    kv_io: Optional[Any] = None,
                    last_index: Optional[Tensor] = None,
                    tp_axis: Optional[str] = None):
    cache_k, cache_v = cache
    b, s = input_ids.shape
    cdt = cfg.dtype
    width = p["layers"]["attn_proj"].shape[1]  # this rank's heads x head_dim
    # JAX clamps an index past the table; on the card an out-of-range
    # index would fault asynchronously
    pos = positions.long().clamp(0, cfg.block_size - 1)
    x = (p["wte"][input_ids.long()] + p["wpe"][pos]).to(cdt)
    for i, layer in enumerate(_per_layer(p["layers"])):
        a = _layer_norm(x, layer["ln1"])
        q, k, v = (a @ layer["attn_qkv"].to(cdt)).split(width, dim=-1)
        q, k, v = _heads(q, cfg), _heads(k, cfg), _heads(v, cfg)
        if kv_io is None:
            write_kv_cache(cache_k[i], k, positions[:, 0], write_mask)
            write_kv_cache(cache_v[i], v, positions[:, 0], write_mask)
            o = cached_sdpa_attention(q, cache_k[i], cache_v[i], positions)
        else:
            kv_io.write(cache_k[i], k, positions, write_mask)
            kv_io.write(cache_v[i], v, positions, write_mask)
            o = kv_io.attend(q, cache_k[i], cache_v[i], positions)
        o = o.transpose(1, 2).reshape(b, s, width)
        x = x + _tp_sum(o @ layer["attn_proj"].to(cdt), tp_axis)
        y, _ = _mlp(_layer_norm(x, layer["ln2"]), layer, cfg, None, None,
                    with_aux=False)
        x = x + _tp_sum(y, tp_axis).to(cdt)
    if last_index is not None:
        rows = torch.arange(b, device=x.device)
        x = x[rows, last_index.long()][:, None]
    x = _layer_norm(x, p["ln_f"])
    return x @ p["wte"].to(cdt).T, (cache_k, cache_v)


def forward_cached(params, input_ids: Tensor, cfg: GPTMoEConfig,
                   cache: Tuple[Tensor, Tensor], **kw: Any):
    """KV-cached forward with the JAX package's ``forward_fn`` signature
    ``(params, tokens, cfg, cache, **kw)``: [B, S] tokens at absolute
    ``positions`` [B, S] -> (logits [B, S, V], the cache pair updated in
    place). ``params`` is a ``GPTMoEForCausalLM`` or a parameter tree.
    Routing is deterministic (no noise). ``kv_io`` routes the cache
    through the page pool (``inference.kv_cache.PagedKVIO``);
    ``write_mask`` [B] keeps unlisted slots' bytes; ``last_index`` [B]
    keeps only that row of each slot before the final norm and head ->
    logits [B, 1, V]. A module built over a tp mesh runs its slices with
    the mesh current (``parallel.mesh.using_mesh_manager``)."""
    tp_axis = None
    if isinstance(params, GPTMoEForCausalLM):
        if params.cfg != cfg:
            raise ValueError("the model was built for another config")
        tp_axis = params.tp_axis
    with torch.no_grad():
        return _forward_cached(_tree(params), input_ids, cfg, cache,
                               tp_axis=tp_axis, **kw)


def _pick(logits: Tensor, temperature: float,
          generator: Optional[torch.Generator]) -> Tensor:
    if temperature == 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    draw = torch.multinomial(probs.to(generator.device), 1,
                             generator=generator)[:, 0]
    return draw.to(logits.device)


@torch.no_grad()
def generate(params, prompt: Tensor, cfg: GPTMoEConfig, *,
             max_new_tokens: int = 32, temperature: float = 1.0,
             generator: Optional[torch.Generator] = None) -> Tensor:
    """KV-cached continuation of prompt [B, P]: one prefill over the
    prompt, then one-token decode steps against the cache -> [B,
    min(block_size, P + max_new_tokens)]. Greedy when temperature == 0;
    otherwise a categorical draw a step from ``generator`` (default one
    seeded with 0)."""
    b, p = prompt.shape
    dev = prompt.device
    total = min(cfg.block_size, p + max_new_tokens)
    gen = init_generator(generator, dev)
    cache = init_cache(cfg, b, device=dev)
    buf = torch.zeros(b, cfg.block_size, dtype=torch.long, device=dev)
    buf[:, :p] = prompt
    positions = torch.arange(p, device=dev, dtype=torch.int32).expand(b, p)
    logits, cache = forward_cached(params, prompt, cfg, cache,
                                   positions=positions)
    tok = _pick(logits[:, -1, :], temperature, gen)
    if p < total:
        buf[:, p] = tok
    for t in range(p, total - 1):
        # feed the token at position t; its logits pick position t + 1
        logits, cache = forward_cached(
            params, tok[:, None], cfg, cache,
            positions=torch.full((b, 1), t, device=dev, dtype=torch.int32))
        tok = _pick(logits[:, 0, :], temperature, gen)
        buf[:, t + 1] = tok
    return buf[:, :total]


@torch.no_grad()
def generate_recompute(params, prompt: Tensor, cfg: GPTMoEConfig, *,
                       max_new_tokens: int = 32, temperature: float = 1.0,
                       generator: Optional[torch.Generator] = None
                       ) -> Tensor:
    """The cache-less sampler: the full forward over the whole block
    buffer for every emitted token (the A/B baseline of ``generate``)."""
    b, p = prompt.shape
    dev = prompt.device
    total = min(cfg.block_size, p + max_new_tokens)
    gen = init_generator(generator, dev)
    buf = torch.zeros(b, cfg.block_size, dtype=torch.long, device=dev)
    buf[:, :p] = prompt
    # the reference walks t over [1, block_size) and writes only t in
    # [p, total): the other steps leave the buffer as it is
    for t in range(max(p, 1), total):
        logits = forward(params, buf, cfg)  # [B, block, V]
        buf[:, t] = _pick(logits[:, t - 1, :], temperature, gen)
    return buf[:, :total]


def estimate_mfu(cfg: GPTMoEConfig, params, tokens_per_second: float,
                 peak_flops: float) -> float:
    """Model FLOPs utilisation with the reference's formula: 6N + 12·L·h·
    d·T per token, N counting only top_k of num_experts experts."""
    p = _tree(params)
    leaves = list(p["layers"].values()) + [p[k] for k in p if k != "layers"]
    n = sum(t.numel() for t in leaves)
    if cfg.use_moe:
        expert = (p["layers"]["expert_fc"].numel()
                  + p["layers"]["expert_proj"].numel())
        n = n - expert + expert * cfg.top_k // cfg.num_experts
    l, h, q, t = cfg.n_layer, cfg.n_head, cfg.head_dim, cfg.block_size
    flops_per_token = 6 * n + 12 * l * h * q * t
    return flops_per_token * tokens_per_second / peak_flops


class GPTMoEForCausalLM(nn.Module):
    """The parameter tree as an ``nn.Module`` (fp32 leaves; the forward
    casts to ``cfg.dtype`` at each use). Built empty on ``device`` (None:
    the CUDA card); fill it with ``init_weights_``, ``from_params`` or
    ``models.convert.load_numpy_params``. Its weights carry a gradient
    only with ``requires_grad``. With ``mesh`` (a serving
    ``parallel.mesh.MeshManager`` whose tp axis splits) it holds this
    rank's slices of ``gpt_moe_param_specs``, cut by
    ``models.convert.local_shard_fn``."""

    def __init__(self, cfg: GPTMoEConfig, device: DeviceLike = None, *,
                 requires_grad: bool = False, mesh: Any = None) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.tp_size = mesh.tp if mesh is not None else 1
        self.tp_axis = "tp" if self.tp_size > 1 else None
        self._mesh = mesh if self.tp_axis is not None else None
        local = None
        if self._mesh is not None:
            from scaletorch_tpu_torch.models.convert import local_shard_fn

            check_serving_mesh(cfg, mesh)
            local = local_shard_fn(cfg, mesh, mesh.rank)
        layers = {}
        for name, shape in param_shapes(cfg).items():
            if local is not None:
                shape = tuple(local(name, torch.empty(shape,
                                                      device="meta")).shape)
            p = nn.Parameter(torch.empty(shape, device=dev),
                             requires_grad=requires_grad)
            if name.startswith("layers."):
                layers[name[len("layers."):]] = p
            else:
                self.register_parameter(name, p)
        self.layers = nn.ParameterDict(layers)

    @classmethod
    def from_params(cls, params: Params, cfg: GPTMoEConfig,
                    device: DeviceLike = None, **kw) -> "GPTMoEForCausalLM":
        """A model holding ``params`` (nested tensors or numpy arrays in the
        reference layout; with ``mesh``, this rank's slices of them)."""
        model = cls(cfg, device=device, **kw)
        model._load_full(params)
        return model

    @torch.no_grad()
    def init_weights_(self, generator: Optional[torch.Generator] = None
                      ) -> "GPTMoEForCausalLM":
        """The parameters of ``init_params(generator, cfg)`` on the
        parameters' device (over a mesh, every rank draws the full tree
        and keeps its slices: the shards are one card's weights)."""
        self._load_full(init_params(generator, self.cfg, device=self.device))
        return self

    def _load_full(self, params: Params) -> None:
        from scaletorch_tpu_torch.models.convert import (
            load_numpy_params,
            shard_numpy_params,
        )

        if self._mesh is not None:
            params = shard_numpy_params(params, self.cfg, self._mesh,
                                        self._mesh.rank)
        load_numpy_params(self, params)

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def tree(self) -> Params:
        """The parameters as the functions' nested dict (no copies)."""
        return {"wte": self.wte, "wpe": self.wpe, "ln_f": self.ln_f,
                "layers": dict(self.layers.items())}

    def forward(self, input_ids: Tensor, **kw):
        return forward(self.tree(), input_ids, self.cfg, **kw)


class GPTMoE:
    """The reference's thin veneer: ``init`` draws a tree, a call runs
    ``forward``."""

    config_cls = GPTMoEConfig

    def __init__(self, config: GPTMoEConfig):
        self.config = config

    def init(self, generator: Optional[torch.Generator] = None, *,
             device: DeviceLike = None) -> Params:
        return init_params(generator, self.config, device=device)

    def __call__(self, params, input_ids: Tensor, **kw):
        return forward(params, input_ids, self.config, **kw)
