"""The ``flash`` attention backend (counterpart of
scaletorch_tpu/ops/flash_attention.py).

On a CUDA tensor it runs the hand-written kernels K1-K3 through
``ops/flash.flash_attention`` (forward and custom backward), or raises: no
fallback hides a failed build or launch. On a CPU tensor the same op
computes the kernels' plain versions. ``flash_jax`` is not ported: it
wraps JAX's own library kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from scaletorch_tpu_torch.models.registry import register_attention_backend
from scaletorch_tpu_torch.ops import flash as _flash


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """[B, Hq, S, D] x [B, Hkv, S, D]^2 -> [B, Hq, S, D]. Looked up at
    call time: ``ops/flash`` imports ``models``, which imports this module,
    so ``ops/flash`` may still be half-initialised here."""
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale)


# K1's own op holds (out, lse): the save_attn policy saves it, no copy
flash_attention.saves_attn_residuals = True
register_attention_backend("flash", flash_attention)
