"""Attention backend registry (counterpart of scaletorch_tpu/models/registry.py).

``register_attention_backend`` / ``get_attention_backend`` and the same
resolution order for ``"auto"``: context parallel forces ``ring``, the
``FLASH_ATTEN`` toggle (default on) selects ``flash`` unless
``SCALETORCH_TPU_DISABLE_PALLAS`` is set, otherwise ``sdpa``; the
variables are read through the env registry (``scaletorch_tpu_torch/
env.py``), with the reference's defaults.

A backend is ``fn(q, k, v, *, causal, scale=None) -> out`` with q/k/v
``[batch, heads, seq, head_dim]``; KV heads may be fewer than query heads
(GQA), and each backend handles that itself.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from scaletorch_tpu_torch.env import get_env

_BACKENDS: Dict[str, Callable] = {}


def _toggle(name: str) -> bool:
    return get_env(name)


def register_attention_backend(name: str, fn: Optional[Callable] = None):
    """Register an attention implementation. Usable as a decorator."""

    def _register(f: Callable) -> Callable:
        _BACKENDS[name] = f
        return f

    if fn is not None:
        return _register(fn)
    return _register


def get_attention_backend(name: str) -> Callable:
    if name not in _BACKENDS:
        raise KeyError(
            f"attention backend {name!r} not registered; have "
            f"{sorted(_BACKENDS)}")
    return _BACKENDS[name]


def resolve_attention_backend(requested: str = "auto",
                              context_parallel: bool = False) -> str:
    """CP -> ring, FLASH_ATTEN -> flash, else sdpa; an explicit name is
    returned as it is."""
    if requested != "auto":
        return requested
    if context_parallel or _toggle("CONTEXT_PARALLEL"):
        return "ring"
    if _toggle("FLASH_ATTEN") and not _toggle("SCALETORCH_TPU_DISABLE_PALLAS"):
        return "flash"
    return "sdpa"
