"""The engine steps: full-prompt prefill and one-token decode (PyTorch port).

Counterpart of scaletorch_tpu/inference/decode.py. PyTorch runs eagerly,
so a step is a plain Python callable over static-shape buffers: the
prompt buffer is always ``[B, P]``, the decode batch always ``[B]``, and
admissions change data, never shapes. The KV buffers are updated IN
PLACE (the counterpart of the JAX package's cache donation): a step
returns the same cache tensors it was given.

Host data (tokens, positions, masks, request seeds) comes in as numpy
arrays and goes to the device in one packed upload per step; the
request seeds stay on the host, where sampling seeds its generators.

  * prefill(model, tokens [B, P], lengths [B], write_mask [B], cache,
    seeds [B]) -> (first [B], last_logits [B, V] f32, finite [B], cache)
  * decode(model, tokens [B], positions [B], active [B], cache, seeds)
    -> (next [B], logits [B, V] f32, finite [B], cache)
  * the paged twins take ``tail_lens``/``starts`` (prefill) and the page
    tables (both) and route the cache through ``PagedKVIO``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from scaletorch_tpu_torch.inference.kv_cache import (
    KVCache,
    PagedKVCache,
    PagedKVIO,
    ceil_div,
    init_kv_cache,
    init_paged_kv_cache,
)
from scaletorch_tpu_torch.inference.sampling import (
    SamplingParams,
    finite_mask,
    sample,
)

Tensor = torch.Tensor


def resolve_forward_cached(cfg) -> Callable:
    """The cached forward for a model config: ``Qwen3MoEConfig`` has the
    MoE one; every other ``LlamaConfig`` (Llama, Qwen3) shares the Llama
    one."""
    from scaletorch_tpu_torch.models import llama, qwen3_moe

    if isinstance(cfg, qwen3_moe.Qwen3MoEConfig):
        return qwen3_moe.forward_cached
    if isinstance(cfg, llama.LlamaConfig):
        return llama.forward_cached
    raise TypeError(
        f"no cache-aware forward known for config {type(cfg).__name__} "
        "(the PyTorch port serves the Llama family and Qwen3-MoE)"
    )


def _upload(device: torch.device, *rows: np.ndarray) -> Tensor:
    """Stack equal-length host rows as int32 and move them in one copy."""
    packed = np.stack([np.asarray(r, dtype=np.int32) for r in rows])
    return torch.from_numpy(packed).to(device)


def make_prefill_step(cfg, sampling: SamplingParams, *,
                      forward_fn: Optional[Callable] = None) -> Callable:
    """Dense prefill: the causal forward over the whole ``[B, P]`` buffer
    (positions [0, P) for every slot), writing cache [0, P) for the
    ``write_mask`` slots only; each slot's first token samples from the
    logits at ``lengths - 1``."""
    fwd = forward_fn or resolve_forward_cached(cfg)

    def prefill(model, tokens, lengths, write_mask, cache, seeds):
        dev = cache[0].device
        b, p = tokens.shape
        lengths = np.asarray(lengths)
        tok = torch.from_numpy(np.asarray(tokens, np.int32)).to(dev)
        meta = _upload(dev, lengths, write_mask)
        positions = torch.arange(p, device=dev, dtype=torch.int32).expand(b, p)
        logits, new_cache = fwd(
            model, tok, cfg, tuple(cache), positions=positions,
            write_mask=meta[1].bool(), last_index=meta[0] - 1)
        last = logits[:, 0, :]
        first = sample(last, seeds, lengths - 1, sampling)
        return first, last.float(), finite_mask(last), KVCache(*new_cache)

    return prefill


def make_decode_step(cfg, sampling: SamplingParams, *,
                     forward_fn: Optional[Callable] = None) -> Callable:
    """Dense one-token decode: each slot's current token at its absolute
    position, K/V appended for ACTIVE slots only, next token sampled with
    the slot's (seed, position)."""
    fwd = forward_fn or resolve_forward_cached(cfg)

    def decode(model, tokens, positions, active, cache, seeds):
        dev = cache[0].device
        meta = _upload(dev, tokens, positions, active)
        logits, new_cache = fwd(
            model, meta[0][:, None], cfg, tuple(cache),
            positions=meta[1][:, None], write_mask=meta[2].bool())
        step_logits = logits[:, 0, :]
        nxt = sample(step_logits, seeds, positions, sampling)
        return (nxt, step_logits.float(), finite_mask(step_logits),
                KVCache(*new_cache))

    return decode


def make_fill_slots_step() -> Callable:
    """In-place masked fill over axis 1 of every cache buffer (the SLOT
    axis dense, the PAGE axis paged): ``fill_slots(cache, mask [n] bool,
    value)`` sets the masked lines to ``value`` and leaves every other
    byte untouched. Quarantine clears a poisoned slot's lines with it."""

    def fill_slots(cache, mask, value: float):
        m = torch.from_numpy(np.asarray(mask, bool)).to(cache[0].device)
        for buf in cache:
            buf.masked_fill_(m.view((1, -1) + (1,) * (buf.ndim - 2)), value)
        return cache

    return fill_slots


def make_paged_prefill_step(cfg, sampling: SamplingParams, *,
                            page_size: int,
                            seq_limit: Optional[int] = None,
                            forward_fn: Optional[Callable] = None
                            ) -> Callable:
    """Paged prefill: each admitted slot prefills only its prompt TAIL,
    at rows [0, tail_len) of the buffer and absolute positions ``starts +
    row`` (``starts`` is the page-aligned radix prefix hit, 0 without
    one); the tail reads the shared prefix pages straight from the pool.
    Prefill always takes the gather path (S > 1)."""
    fwd = forward_fn or resolve_forward_cached(cfg)

    def prefill(model, tokens, tail_lens, starts, write_mask, page_tables,
                pool, seeds):
        dev = pool[0].device
        b, p = tokens.shape
        tail_lens, starts = np.asarray(tail_lens), np.asarray(starts)
        tok = torch.from_numpy(np.asarray(tokens, np.int32)).to(dev)
        meta = _upload(dev, tail_lens, starts, write_mask)
        positions = meta[1][:, None] + torch.arange(
            p, device=dev, dtype=torch.int32)
        kv_io = PagedKVIO(page_tables, page_size, seq_limit=seq_limit)
        logits, new_pool = fwd(
            model, tok, cfg, tuple(pool), positions=positions,
            write_mask=meta[2].bool(), kv_io=kv_io, last_index=meta[0] - 1)
        last = logits[:, 0, :]
        first = sample(last, seeds, starts + tail_lens - 1, sampling)
        return first, last.float(), finite_mask(last), PagedKVCache(*new_pool)

    return prefill


def make_paged_decode_step(cfg, sampling: SamplingParams, *,
                           page_size: int,
                           seq_limit: Optional[int] = None,
                           forward_fn: Optional[Callable] = None,
                           kernel: Optional[bool] = None) -> Callable:
    """Paged one-token decode: the K/V append is a scatter into each
    slot's current page, attention reads through its page table — the
    CUDA paged-decode kernel on the card (``kernel=None``), the gather
    path on the CPU or with ``kernel=False``."""
    fwd = forward_fn or resolve_forward_cached(cfg)

    def decode(model, tokens, positions, active, page_tables, pool, seeds):
        dev = pool[0].device
        meta = _upload(dev, tokens, positions, active)
        kv_io = PagedKVIO(page_tables, page_size, seq_limit=seq_limit,
                          kernel=kernel)
        logits, new_pool = fwd(
            model, meta[0][:, None], cfg, tuple(pool),
            positions=meta[1][:, None], write_mask=meta[2].bool(),
            kv_io=kv_io)
        step_logits = logits[:, 0, :]
        nxt = sample(step_logits, seeds, positions, sampling)
        return (nxt, step_logits.float(), finite_mask(step_logits),
                PagedKVCache(*new_pool))

    return decode


def teacher_forced_decode(
    model,
    cfg,
    tokens: Tensor,
    *,
    max_seq: Optional[int] = None,
    prefill_len: int = 1,
    forward_fn: Optional[Callable] = None,
    dtype: Optional[torch.dtype] = None,
) -> Tensor:
    """Prefill the first ``prefill_len`` tokens, then decode the rest one
    at a time with the GROUND-TRUTH token at each step. Returns [B, S, V]
    logits, position-aligned with a full-sequence forward."""
    fwd = forward_fn or resolve_forward_cached(cfg)
    b, s = tokens.shape
    dev = tokens.device
    cache = init_kv_cache(cfg, b, max_seq or s, dtype=dtype or cfg.dtype,
                          device=dev)
    p = prefill_len
    positions = torch.arange(p, device=dev, dtype=torch.int32).expand(b, p)
    logits_p, cache = fwd(model, tokens[:, :p], cfg, tuple(cache),
                          positions=positions)
    chunks = [logits_p]
    for t in range(p, s):
        logits_t, cache = fwd(
            model, tokens[:, t:t + 1], cfg, tuple(cache),
            positions=torch.full((b, 1), t, device=dev, dtype=torch.int32))
        chunks.append(logits_t)
    return torch.cat(chunks, dim=1)


def teacher_forced_decode_paged(
    model,
    cfg,
    tokens: Tensor,
    *,
    page_size: int,
    max_seq: Optional[int] = None,
    prefill_len: int = 1,
    forward_fn: Optional[Callable] = None,
    dtype: Optional[torch.dtype] = None,
    kernel: Optional[bool] = None,
) -> Tensor:
    """Paged twin of ``teacher_forced_decode`` through an identity page
    table (slot ``b`` owns pages ``b*max_pages+1 ..``; page 0 is TRASH).
    ``kernel`` goes to the decode steps' dispatcher."""
    fwd = forward_fn or resolve_forward_cached(cfg)
    b, s = tokens.shape
    dev = tokens.device
    s_max = max_seq or s
    max_pages = ceil_div(s_max, page_size)
    pool = init_paged_kv_cache(cfg, b * max_pages + 1, page_size,
                               dtype=dtype or cfg.dtype, device=dev)
    tables = (torch.arange(b * max_pages, dtype=torch.int32, device=dev)
              + 1).view(b, max_pages)
    p = prefill_len
    prefill_io = PagedKVIO(tables, page_size, seq_limit=s_max)
    decode_io = PagedKVIO(tables, page_size, seq_limit=s_max, kernel=kernel)
    positions = torch.arange(p, device=dev, dtype=torch.int32).expand(b, p)
    logits_p, pool = fwd(model, tokens[:, :p], cfg, tuple(pool),
                         positions=positions, kv_io=prefill_io)
    chunks = [logits_p]
    for t in range(p, s):
        logits_t, pool = fwd(
            model, tokens[:, t:t + 1], cfg, tuple(pool),
            positions=torch.full((b, 1), t, device=dev, dtype=torch.int32),
            kv_io=decode_io)
        chunks.append(logits_t)
    return torch.cat(chunks, dim=1)
