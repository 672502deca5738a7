"""Vocab-parallel cross entropy, single-device form (counterpart of
scaletorch_tpu/parallel/tensor_parallel.py:149-251 with ``axis=None``).

``fused_vocab_parallel_cross_entropy`` applies the LM head and the loss
one sequence chunk at a time; each chunk runs under
``torch.utils.checkpoint`` so its logits are recomputed in the backward
and the full ``[B, S, V]`` logits never exist (at chunk 1024 and vocab
151936 one chunk's fp32 logits are 622 MB; the whole 8192-token
sequence's would be 5 GB). Tensor-parallel shards (``axis`` set) are a
later slice and raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor


def _single_device(axis: Optional[str]) -> None:
    if axis is not None:
        raise NotImplementedError(
            f"axis={axis!r}: tensor-parallel losses are not ported yet; the "
            "port trains on one device (axis=None)")


def _vocab_parallel_token_stats(
    logits_local: Tensor,
    targets: Tensor,
    axis: Optional[str],
    ignore_index: int,
) -> Tuple[Tensor, Tensor]:
    """(nll_sum, token_count), fp32: logsumexp with a gradient-free max
    shift, and the gold logit."""
    _single_device(axis)
    logits32 = logits_local.float()
    shift = logits32.amax(dim=-1).detach()
    sumexp = torch.exp(logits32 - shift[..., None]).sum(dim=-1)
    logz = shift + torch.log(sumexp)
    mask = targets != ignore_index
    safe_t = torch.where(mask, targets, 0).long()
    gold = torch.gather(logits32, -1, safe_t[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum().float()


def vocab_parallel_cross_entropy(
    logits_local: Tensor,
    targets: Tensor,
    *,
    axis: Optional[str] = None,
    ignore_index: int = -100,
) -> Tensor:
    """Token-mean cross entropy over [..., V] logits."""
    nll_sum, count = _vocab_parallel_token_stats(
        logits_local, targets, axis, ignore_index)
    return nll_sum / count.clamp_min(1.0)


def fused_vocab_parallel_cross_entropy(
    hidden: Tensor,
    head_local: Tensor,
    targets: Tensor,
    *,
    axis: Optional[str] = None,
    chunk_size: int = 1024,
    ignore_index: int = -100,
) -> Tensor:
    """LM-head matmul + cross entropy fused over sequence chunks.

    hidden: [B, S, H]; head_local: [H, V]; targets: [B, S]. The last chunk
    may be shorter. Each chunk's logits are recomputed in the backward,
    so only the [B, C, H] hidden chunk is kept per chunk."""
    _single_device(axis)
    s = hidden.shape[1]
    chunk = min(chunk_size, s)

    def chunk_stats(x_chunk, head, t_chunk):
        return _vocab_parallel_token_stats(x_chunk @ head, t_chunk, axis,
                                           ignore_index)

    if chunk >= s:
        nll_sum, count = chunk_stats(hidden, head_local, targets)
        return nll_sum / count.clamp_min(1.0)
    nll_sum = count = None
    for c0 in range(0, s, chunk):
        n, m = checkpoint(chunk_stats, hidden[:, c0:c0 + chunk], head_local,
                          targets[:, c0:c0 + chunk], use_reentrant=False)
        nll_sum = n if nll_sum is None else nll_sum + n
        count = m if count is None else count + m
    return nll_sum / count.clamp_min(1.0)
