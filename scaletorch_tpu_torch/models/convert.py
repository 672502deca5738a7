"""Carry a parameter tree in the reference layout into a port model.

The JAX package's parameters are a nested dict (``embed_tokens``,
``layers.{...}`` stacked on axis 0, ``norm``, optional ``lm_head``);
``jax.tree.map(np.asarray, params)`` gives it as numpy arrays, which is
what the parity tests hand to ``load_numpy_params``. Torch tensors in
the same layout (``llama.init_params``) load the same way.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn


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
