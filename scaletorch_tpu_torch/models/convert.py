"""Carry a parameter tree in the reference layout into and out of the port.

The JAX package's parameters are a nested dict (``embed_tokens``,
``layers.{...}`` stacked on axis 0, ``norm``, optional ``lm_head``);
``jax.tree.map(np.asarray, params)`` gives it as numpy arrays, which is
what the parity tests hand over. ``load_numpy_params`` fills a serving
``LlamaForCausalLM`` or ``Qwen3MoEForCausalLM`` (the MoE keys ``router``
and ``expert_{gate,up,down}_proj`` stacked over the sparse layers, each
cast to its parameter's dtype: the router stays fp32, the experts take
the compute dtype); ``params_from_numpy`` builds the training
parameter dict (fp32 leaves with ``requires_grad``) and
``params_to_numpy`` turns it back. Torch tensors in the same layout
(``llama.init_params``) load the same way. ``opt_state_from_jax`` carries
an optax optimizer state (as numpy arrays) into the port's state dict of
the same optimizer, so both sides can start from one mid-run state.
``gpt_moe_from_jax``, ``lenet_from_jax`` and ``attention_from_jax`` carry
the model zoo's trees (LeNet's from NHWC to NCHW).

``shard_numpy_params`` turns a full tree into one rank's shards over the
mesh (``parallel/tensor_parallel.shard_dims``: the stacked layer axis over
pp, after the pipeline's padding or interleave; the expert axis over ep;
each leaf's tp dim), ``local_shard_fn`` does the same leaf by leaf as
``init_params`` draws them, and ``gather_params`` is the inverse over
every rank's shards. Every rank cuts its part from the one-card tree, so
the shards are one card's parameters and parity needs no exchange.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from scaletorch_tpu_torch.utils.device import DeviceLike, resolve_device


def flatten_params(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> ``{"layers.q_proj": leaf, ...}``."""
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten_params(value, prefix=f"{name}."))
        else:
            flat[name] = value
    return flat


def _as_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.array(leaf)  # a writable copy
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: widen exactly
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr)


@torch.no_grad()
def load_numpy_params(model: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Copy ``tree`` into ``model``'s parameters in place, casting each
    leaf to the parameter's dtype (round to nearest even, as
    ``astype`` rounds) and moving it to the parameter's device. The key
    sets and shapes must match exactly."""
    flat = flatten_params(tree)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(flat))
    unexpected = sorted(set(flat) - set(own))
    if missing or unexpected:
        raise KeyError(
            f"parameter tree does not match the model: missing {missing}, "
            f"unexpected {unexpected}")
    for name, leaf in flat.items():
        src = _as_tensor(leaf)
        dst = own[name]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(
                f"{name}: shape {tuple(src.shape)} != model's "
                f"{tuple(dst.shape)}")
        dst.copy_(src.to(device=dst.device).to(dst.dtype))
    return model


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The training parameter dict of a nested numpy (or tensor) tree, in
    the same layout: leaves in ``dtype`` (default fp32, the master
    copy) on ``device`` (None = the CUDA card), with ``requires_grad``."""
    dev = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = params_from_numpy(value, dev, dtype)
        else:
            t = _as_tensor(value).to(device=dev, dtype=dtype).clone()
            out[key] = t.requires_grad_(True)
    return out


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The parameter dict as a nested dict of float32 numpy arrays: a
    snapshot, never a view of the (in-place updated) parameters."""
    return {key: (params_to_numpy(value) if isinstance(value, dict)
                  else value.detach().to("cpu", torch.float32,
                                         copy=True).numpy())
            for key, value in params.items()}


def _torch_dtype(leaf: Any) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    name = np.asarray(leaf).dtype.name
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float64": torch.float64}.get(name, torch.float32)


def _state_tree(tree: Any, dev: torch.device) -> Any:
    """A state tree (nested dicts of arrays) as tensors of the same
    dtypes on ``dev``, bit for bit."""
    if isinstance(tree, dict):
        return {k: _state_tree(v, dev) for k, v in tree.items()}
    return _as_tensor(tree).to(device=dev, dtype=_torch_dtype(tree)).clone()


def _components(state: Any) -> List[Any]:
    """The named states of an optax chain (a tuple of named tuples, or
    one named tuple), in chain order."""
    if hasattr(state, "_fields"):
        return [state]
    if isinstance(state, (tuple, list)):
        return [c for part in state for c in _components(part)]
    return []


def opt_state_from_jax(state: Any, device: DeviceLike = None
                       ) -> Dict[str, Any]:
    """The port's optimizer state of an optax state whose leaves are numpy
    arrays (``jax.tree.map(np.asarray, state)``), dtypes kept bit for
    bit, on ``device`` (None = the CUDA card):

      * ``ScaleByAdamState`` (adam, adamw, and lamb's chain) ->
        ``{"count", "mu", "nu"}``;
      * ``TraceState`` with the schedule's ``ScaleByScheduleState`` (sgd)
        -> ``{"count", "trace"}``;
      * the reference's ``ShardedFactoredState`` (keepdims layout) ->
        ``{"count", "v_row", "v_col", "v"}``.

    The counts become int64 CPU tensors. Another state raises."""
    dev = resolve_device(device)
    parts = _components(state)
    by_field = {f: part for part in parts for f in part._fields}

    def count(part) -> torch.Tensor:
        return torch.tensor(int(np.asarray(part.count)), dtype=torch.int64)

    if "mu" in by_field and "nu" in by_field:
        adam = by_field["mu"]
        return {"count": count(adam), "mu": _state_tree(adam.mu, dev),
                "nu": _state_tree(adam.nu, dev)}
    if "trace" in by_field and "count" in by_field:
        return {"count": count(by_field["count"]),
                "trace": _state_tree(by_field["trace"].trace, dev)}
    if "v_row" in by_field:
        fac = by_field["v_row"]
        return {"count": count(fac),
                **{k: _state_tree(getattr(fac, k), dev)
                   for k in ("v_row", "v_col", "v")}}
    names = [type(p).__name__ for p in parts]
    raise ValueError(f"no port optimizer keeps the state {names}")


# ---- shards over the mesh ------------------------------------------------------
def _split_dims(cfg) -> Dict[str, Dict[str, int]]:
    from scaletorch_tpu_torch.parallel.tensor_parallel import shard_dims

    return shard_dims(cfg)


def _slice(leaf: Any, dim: int, n: int, i: int) -> Any:
    size = leaf.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split over "
                         f"{n} ranks")
    width = size // n
    index = [slice(None)] * leaf.ndim
    index[dim] = slice(i * width, (i + 1) * width)
    return leaf[tuple(index)]


# the order a leaf is cut in: the pp split of the stacked layer axis (after
# the layout's padding or interleave), the ep split of the expert axis, tp
_SPLIT_AXES = ("pp", "ep", "tp")


def _local(name: str, leaf: Any, dims: Dict[str, int], mm, coords,
           layout: Optional[Callable[[Any], Any]]) -> Any:
    if layout is not None and name.startswith("layers."):
        leaf = layout(leaf)
    for axis in _SPLIT_AXES:
        n = mm.axis_size(axis)
        if axis in dims and n > 1:
            leaf = _slice(leaf, dims[axis], n, getattr(coords, axis))
    return leaf


def shard_numpy_params(params: Dict[str, Any], cfg, mm, rank: int, *,
                       layout: Optional[Callable[[Any], Any]] = None
                       ) -> Dict[str, Any]:
    """Global rank ``rank``'s shards of the full tree ``params`` (nested
    numpy arrays or tensors in the reference layout) on the mesh ``mm``:
    each stacked layer leaf re-blocked by ``layout`` (``pipeline_parallel.
    stage_layer_layout``: uneven padding or the interleave order) and cut
    to its pp coordinate's block, each expert leaf to its ep coordinate's
    experts, each tp-split leaf to its tp slice; the others whole. Slices
    are copies."""
    dims = _split_dims(cfg)
    coords = mm.coords(rank)

    def walk(tree, prefix=""):
        out = {}
        for key, value in tree.items():
            name = f"{prefix}{key}"
            if isinstance(value, dict):
                out[key] = walk(value, f"{name}.")
            else:
                part = _local(name, value, dims[name], mm, coords, layout)
                out[key] = (part.clone() if isinstance(part, torch.Tensor)
                            else np.array(part))
        return out

    return walk(params)


def local_shard_fn(cfg, mm, rank: int, *,
                   layout: Optional[Callable[[Any], Any]] = None
                   ) -> Callable[[str, torch.Tensor], torch.Tensor]:
    """``fn(flat_name, leaf) -> shard`` for ``init_params``' ``local_slice``
    (``llama`` or ``qwen3_moe``): rank ``rank``'s part, as
    ``shard_numpy_params`` cuts it, as a tensor of its own (the full leaf
    can be freed)."""
    dims = _split_dims(cfg)
    coords = mm.coords(rank)

    def fn(name: str, leaf: torch.Tensor) -> torch.Tensor:
        part = _local(name, leaf, dims[name], mm, coords, layout)
        return part if part is leaf else part.contiguous().clone()

    return fn


def gather_params(shards: Sequence[Dict[str, Any]], cfg, mm, *,
                  unlayout: Optional[Callable[[Any], Any]] = None
                  ) -> Dict[str, Any]:
    """The full tree from every global rank's shards (``shards[r]``,
    numpy arrays): each leaf concatenated over the pp, ep and tp ranks of
    the first (dp, cp) coordinate along the dims it splits over, the
    stacked layer leaves then put back in model order by ``unlayout``
    (the inverse of the layout they were cut in)."""
    from scaletorch_tpu_torch.parallel.mesh import MeshCoords

    dims = _split_dims(cfg)

    def full(name: str, trees) -> np.ndarray:
        d = dims[name]
        split = [a for a in _SPLIT_AXES if a in d and mm.axis_size(a) > 1]

        def build(coords: Dict[str, int], axes):
            if not axes:
                rank = mm.rank_of(MeshCoords(dp=0, cp=0, **{
                    a: coords.get(a, 0) for a in ("pp", "ep", "tp")}))
                return np.asarray(trees[rank])
            axis, rest = axes[0], axes[1:]
            return np.concatenate(
                [build({**coords, axis: i}, rest)
                 for i in range(mm.axis_size(axis))], axis=d[axis])

        leaf = build({}, split)
        if unlayout is not None and name.startswith("layers."):
            leaf = unlayout(leaf)
        return leaf

    def walk(trees, prefix=""):
        out = {}
        for key, value in trees[0].items():
            name = f"{prefix}{key}"
            if isinstance(value, dict):
                out[key] = walk([t[key] for t in trees], f"{name}.")
            else:
                out[key] = full(name, [t[key] for t in trees])
        return out

    return walk(list(shards))


# ---- the model zoo: GPT-MoE, LeNet, the attention variants ---------------------
def gpt_moe_from_jax(tree: Dict[str, Any], cfg, device: DeviceLike = None,
                     *, requires_grad: bool = False):
    """A ``GPTMoEForCausalLM`` holding the JAX package's GPT-MoE tree (as
    numpy arrays): the layouts are the same, leaf for leaf."""
    from scaletorch_tpu_torch.models.gpt_moe import GPTMoEForCausalLM

    return GPTMoEForCausalLM.from_params(tree, cfg, device=device,
                                         requires_grad=requires_grad)


def lenet_from_jax(tree: Dict[str, Any], device: DeviceLike = None, *,
                   requires_grad: bool = False) -> Dict[str, torch.Tensor]:
    """The port's LeNet parameters (NCHW) of the JAX package's (NHWC): the
    convs HWIO -> OIHW, and ``fc1``'s rows reordered from NHWC's (H, W, C)
    flatten to NCHW's (C, H, W), so both compute the same logits."""
    dev = resolve_device(device)
    out = {}
    for name, leaf in tree.items():
        t = _as_tensor(leaf).float()
        if name.startswith("conv"):
            t = t.permute(3, 2, 0, 1)
        elif name == "fc1":
            c = 16
            hw = int(round((t.shape[0] // c) ** 0.5))
            t = t.reshape(hw, hw, c, -1).permute(2, 0, 1, 3).reshape(
                t.shape[0], -1)
        out[name] = t.contiguous().to(dev).requires_grad_(requires_grad)
    return out


def attention_from_jax(tree: Dict[str, Any], device: DeviceLike = None
                       ) -> Dict[str, torch.Tensor]:
    """An attention variant's parameters (``[in, out]`` projections in both
    packages) as tensors on ``device``."""
    dev = resolve_device(device)
    return {name: _as_tensor(leaf).to(dev) for name, leaf in tree.items()}
