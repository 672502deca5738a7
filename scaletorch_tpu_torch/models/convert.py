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
(``llama.init_params``) load the same way.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

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
