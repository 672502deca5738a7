"""The ``flash`` and ``flash_jax`` attention backends (counterpart of
scaletorch_tpu/ops/flash_attention.py).

``flash`` on a CUDA tensor runs the hand-written kernels K1-K3 through
``ops/flash.flash_attention`` (forward and custom backward), or raises: no
fallback hides a failed build or launch. On a CPU tensor the same op
computes the kernels' plain versions. A backend asked for by name is that
backend: the reference's ``SCALETORCH_TPU_DISABLE_PALLAS`` A/B gate acts
where the reference's acts for the default, in ``resolve_attention_backend``
(``"auto"`` resolves to ``sdpa`` when it is set). Its
``SCALETORCH_TPU_FORCE_PALLAS`` overrides TPU detection, which the port
does not have: it is not ported.

``flash_jax`` is the A/B partner the reference registers under that name
(JAX's own library kernel there): the ``sdpa`` backend, which expands the
K/V heads to the query heads as the reference expands them, behind the
reference's head-count check. It is a yardstick of the kernels, not a port
of a kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from scaletorch_tpu_torch.models.layers import sdpa_attention
from scaletorch_tpu_torch.models.registry import register_attention_backend
from scaletorch_tpu_torch.ops import flash as _flash


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """[B, Hq, S, D] x [B, Hkv, S, D]^2 -> [B, Hq, S, D]. Looked up at
    call time: ``ops/flash`` imports ``models``, which imports this module,
    so ``ops/flash`` may still be half-initialised here."""
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale)


def flash_attention_jax(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The ``flash_jax`` A/B partner: the ``sdpa`` backend (K/V expanded
    to ``[B, Hq, S, D]``), refusing a head count that does not divide."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"flash_attention_jax: query heads {q.shape[1]} must be a "
            f"multiple of key/value heads {k.shape[1]}")
    return sdpa_attention(q, k, v, causal=causal, scale=scale)


# K1's own op holds (out, lse): the save_attn policy saves it, no copy
flash_attention.saves_attn_residuals = True
register_attention_backend("flash", flash_attention)
register_attention_backend("flash_jax", flash_attention_jax)
