"""MHA / MQA / GQA / MLA (counterpart of
scaletorch_tpu/models/attention/variants.py).

One parameterised implementation: MHA and MQA are GQA with kv_heads =
heads and 1; MLA puts low-rank q / kv down-up projections in front, and
its inference cache keeps only the kv latent ``[B, S_max, kv_rank]``
(R floats a token instead of 2·H·D), re-expanding K and V from it at
every step. Weights are ``[in, out]``, applied as ``x @ w``, as the
reference lays them out.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from scaletorch_tpu_torch.models.attention.base import (
    AttentionConfig,
    AttentionVariant,
)
from scaletorch_tpu_torch.models.layers import (
    cached_sdpa_attention,
    fan_in_uniform,
    repeat_kv,
    sdpa_attention,
)
from scaletorch_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def _split_heads(t: Tensor, heads: int, dh: int) -> Tensor:
    b, s, _ = t.shape
    return t.reshape(b, s, heads, dh).transpose(1, 2)


def _merge_heads(o: Tensor) -> Tensor:
    b, h, s, dh = o.shape
    return o.transpose(1, 2).reshape(b, s, h * dh)


def _gqa_init(generator: torch.Generator, device: torch.device,
              cfg: AttentionConfig, kv_heads: int) -> Params:
    d, dh, nh = cfg.embed_dim, cfg.actual_head_dim, cfg.num_heads

    def draw(shape, fan_in):
        return fan_in_uniform(generator, shape, fan_in, cfg.dtype,
                              device=device)

    return {
        "q_proj": draw((d, nh * dh), d),
        "k_proj": draw((d, kv_heads * dh), d),
        "v_proj": draw((d, kv_heads * dh), d),
        "o_proj": draw((nh * dh, d), nh * dh),
    }


def _gqa_apply(params: Params, x: Tensor, cfg: AttentionConfig,
               kv_heads: int, *, causal: bool = True) -> Tensor:
    nh, dh = cfg.num_heads, cfg.actual_head_dim
    q = _split_heads(x @ params["q_proj"], nh, dh)
    k = _split_heads(x @ params["k_proj"], kv_heads, dh)
    v = _split_heads(x @ params["v_proj"], kv_heads, dh)
    k = repeat_kv(k, nh // kv_heads)
    v = repeat_kv(v, nh // kv_heads)
    o = sdpa_attention(q, k, v, causal=causal)
    return _merge_heads(o) @ params["o_proj"]


class MultiHeadAttention(AttentionVariant):
    """Per-head K/V."""

    def _draw(self, generator, device):
        return _gqa_init(generator, device, self.cfg, self.cfg.num_heads)

    def __call__(self, params, x, *, causal: bool = True):
        return _gqa_apply(params, x, self.cfg, self.cfg.num_heads,
                          causal=causal)


class MultiQueryAttention(AttentionVariant):
    """One K/V head shared by every query head."""

    def _draw(self, generator, device):
        return _gqa_init(generator, device, self.cfg, 1)

    def __call__(self, params, x, *, causal: bool = True):
        return _gqa_apply(params, x, self.cfg, 1, causal=causal)


class GroupQueryAttention(AttentionVariant):
    """``num_kv_heads`` K/V heads, each shared by a group of query heads."""

    def _draw(self, generator, device):
        return _gqa_init(generator, device, self.cfg,
                         self.cfg.actual_num_kv_heads)

    def __call__(self, params, x, *, causal: bool = True):
        return _gqa_apply(params, x, self.cfg, self.cfg.actual_num_kv_heads,
                          causal=causal)


class MultiHeadLatentAttention(AttentionVariant):
    """Low-rank latent projections: x -> a small latent -> per-head q / k /
    v. At inference the cache holds only the kv latent (``init_cache``,
    ``prefill``, ``decode``); ``inference.kv_cache.MLACache`` wraps it."""

    def _draw(self, generator, device):
        cfg = self.cfg
        d, dh, nh = cfg.embed_dim, cfg.actual_head_dim, cfg.num_heads
        kr = cfg.kv_lora_rank

        def draw(shape, fan_in):
            return fan_in_uniform(generator, shape, fan_in, cfg.dtype,
                                  device=device)

        params: Params = {
            "kv_down": draw((d, kr), d),
            "k_up": draw((kr, nh * dh), kr),
            "v_up": draw((kr, nh * dh), kr),
            "o_proj": draw((nh * dh, d), nh * dh),
        }
        if cfg.q_lora_rank:
            qr = cfg.q_lora_rank
            params["q_down"] = draw((d, qr), d)
            params["q_up"] = draw((qr, nh * dh), qr)
        else:
            params["q_proj"] = draw((d, nh * dh), d)
        return params

    def _query(self, params: Params, x: Tensor) -> Tensor:
        if "q_down" in params:
            return (x @ params["q_down"]) @ params["q_up"]
        return x @ params["q_proj"]

    def __call__(self, params, x, *, causal: bool = True):
        nh, dh = self.cfg.num_heads, self.cfg.actual_head_dim
        latent = x @ params["kv_down"]  # [B, S, kv_rank]: what a cache keeps
        q = _split_heads(self._query(params, x), nh, dh)
        k = _split_heads(latent @ params["k_up"], nh, dh)
        v = _split_heads(latent @ params["v_up"], nh, dh)
        o = sdpa_attention(q, k, v, causal=causal)
        return _merge_heads(o) @ params["o_proj"]

    # ---- the latent-only KV cache ------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   dtype: Optional[torch.dtype] = None, *,
                   device: DeviceLike = None) -> Tensor:
        """Zeroed latent cache [B, S_max, kv_rank] on ``device`` (None:
        the CUDA card)."""
        return torch.zeros(batch, max_seq, self.cfg.kv_lora_rank,
                           dtype=dtype or self.cfg.dtype,
                           device=resolve_device(device))

    def _attend_cache(self, params: Params, q: Tensor, latent_cache: Tensor,
                      q_positions: Tensor) -> Tensor:
        """q [B, S, nh·dh] against K/V re-expanded from the whole cached
        latent [B, S_max, R], keys j <= the query's position."""
        nh, dh = self.cfg.num_heads, self.cfg.actual_head_dim
        k = _split_heads(latent_cache @ params["k_up"], nh, dh)
        v = _split_heads(latent_cache @ params["v_up"], nh, dh)
        o = cached_sdpa_attention(_split_heads(q, nh, dh), k, v, q_positions)
        return _merge_heads(o) @ params["o_proj"]

    def prefill(self, params: Params, x: Tensor,
                cache: Tensor) -> Tuple[Tensor, Tensor]:
        """A whole prompt x [B, P, E]: writes its latents at [0, P) of the
        cache (in place) -> (out [B, P, E], cache); ``out`` equals the
        full forward to float tolerance."""
        b, p, _ = x.shape
        cache[:, :p] = (x @ params["kv_down"]).to(cache.dtype)
        positions = torch.arange(p, device=x.device).expand(b, p)
        return self._attend_cache(params, self._query(params, x), cache,
                                  positions), cache

    def decode(self, params: Params, x_t: Tensor, cache: Tensor,
               positions: Tensor) -> Tuple[Tensor, Tensor]:
        """One step: x_t [B, 1, E] at absolute ``positions`` [B]; writes the
        token's latent there (in place) and attends the cached latents
        [0, p] -> (out [B, 1, E], cache)."""
        rows = torch.arange(x_t.shape[0], device=x_t.device)
        pos = positions.long().clamp(0, cache.shape[1] - 1)
        cache[rows, pos] = (x_t[:, 0] @ params["kv_down"]).to(cache.dtype)
        return self._attend_cache(params, self._query(params, x_t), cache,
                                  positions.long()[:, None]), cache
