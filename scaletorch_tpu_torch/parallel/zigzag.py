"""Zigzag (load-balanced) context-parallel sequence layout — host side.

A copy of scaletorch_tpu/parallel/zigzag.py (pure numpy; the port
imports nothing of the JAX package). The per-rank slicing of the
permuted batch is ``parallel/spmd.local_batch``.

Contiguous CP sharding leaves the causal ring imbalanced: rank r does
r+1 attention blocks while all ranks tick in lockstep, so the ring's
wall-clock is rank cp-1's (the reference inherits the same skew from its
causal skip, context_parallel.py:154-171). The zigzag layout splits the
sequence into 2·cp stripes and gives rank r stripes r and 2cp-1-r, so
every rank's causal work is exactly two stripe-pairs per ring step —
perfectly balanced (the zhuzilin/ring-flash-attention zigzag scheme).

This module is the HOST half: a pure permutation of the global token
order such that the step's contiguous cp sequence slices hand each rank
its stripe pair. Absolute position_ids are
permuted identically, so RoPE, the shifted-target loss, and every other
position-aware consumer are layout-transparent; only ring attention's
masking schedule needs to know (ops/ring_attention.py layout='zigzag').
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict

import numpy as np


@lru_cache(maxsize=32)
def _order_cached(seq_len: int, cp: int) -> np.ndarray:
    if seq_len % (2 * cp):
        raise ValueError(
            f"zigzag needs seq_len % (2*cp) == 0, got seq {seq_len}, cp {cp}"
        )
    stripe = seq_len // (2 * cp)
    parts = []
    for r in range(cp):
        parts.append(np.arange(r * stripe, (r + 1) * stripe))
        parts.append(np.arange((2 * cp - 1 - r) * stripe,
                               (2 * cp - r) * stripe))
    out = np.concatenate(parts)
    out.setflags(write=False)  # cached and shared: callers must not mutate
    return out


def zigzag_order(seq_len: int, cp: int) -> np.ndarray:
    """new_index -> old_index map: position i of the permuted sequence
    holds original token order[i]. Rank r's contiguous slice of the
    permuted sequence is [stripe_r, stripe_{2cp-1-r}]. Memoized (the
    trainer permutes every step batch on the host hot path); the returned
    array is read-only."""
    return _order_cached(seq_len, cp)


def zigzag_restore(seq_len: int, cp: int) -> np.ndarray:
    """Inverse map: scatter a zigzag-ordered sequence back to the
    original order (for decoding / exporting activations)."""
    order = zigzag_order(seq_len, cp)
    inv = np.empty_like(order)
    inv[order] = np.arange(seq_len)
    return inv


def zigzag_batch(batch: Dict[str, np.ndarray], cp: int) -> Dict[str, np.ndarray]:
    """Permute every per-token field of a step batch along its sequence
    (last) axis into zigzag order. Identity at cp == 1.

    Every field must share one sequence length (anchored on ``input_ids``
    when present): a non-per-token field whose last axis merely happens to
    divide 2*cp would otherwise be permuted silently wrong.
    """
    if cp == 1:
        return batch
    anchor = batch.get("input_ids")
    seq_len = (anchor.shape[-1] if anchor is not None
               else next(iter(batch.values())).shape[-1])
    order = zigzag_order(seq_len, cp)
    out = {}
    for name, arr in batch.items():
        if arr.shape[-1] != seq_len:
            raise ValueError(
                f"zigzag_batch: field '{name}' has last axis {arr.shape[-1]}"
                f" != sequence length {seq_len}; only per-token fields can"
                " ride the zigzag permutation — drop or reshape it first"
            )
        out[name] = np.ascontiguousarray(np.take(arr, order, axis=-1))
    return out
