"""Token sampling: greedy / temperature / top-k / top-p (PyTorch port).

Greedy is exact: ``torch.argmax`` returns the first maximum, as
``jnp.argmax`` does. A sampled token is drawn as the reference draws it
(``jax.random.categorical``: a Gumbel-max over the filtered, scaled
logits), from noise that is a function of (request seed, position,
vocab index) alone: a counter-based hash computed on the logits' device
with integer tensor ops. So a request's stream does not depend on the
slot it landed in or on what its neighbours sample, and the draw runs
inside a captured CUDA graph. JAX's threefry bits are not reproduced.

Filter order follows the HF convention: temperature first, then top-k,
then top-p on the already-scaled distribution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Union

import torch

Tensor = torch.Tensor

_NEG_INF = torch.finfo(torch.float32).min
# The hash keeps its state in the low 32 bits of int64 tensors: every
# value stays in [0, 2^32), so torch's arithmetic ``>>`` shifts in zeros,
# and each multiplier is below 2^31, so no product reaches 2^63.
_M32 = 0xFFFFFFFF
_MUL1, _MUL2 = 0x21F0AAAD, 0x735A2D97  # lowbias32's (hash-prospector)
_GOLDEN = 0x9E3779B9


@dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 -> greedy argmax (top_k/top_p ignored);
    top_k == 0 and top_p == 1.0 disable their filters."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self) -> None:
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0


def _filter_top_k(logits: Tensor, k: int) -> Tensor:
    """Keep the k highest logits, mask the rest."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _NEG_INF, logits)


def _filter_top_p(logits: Tensor, p: float) -> Tensor:
    """Nucleus filter: keep the smallest prefix of the sorted distribution
    whose cumulative probability reaches ``p`` (the top token always
    survives)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    cutoff = torch.where(keep, sorted_logits, torch.inf).amin(
        dim=-1, keepdim=True)
    return torch.where(logits < cutoff, _NEG_INF, logits)


def _filtered_logits(logits: Tensor, params: SamplingParams) -> Tensor:
    """Temperature, then top-k, then top-p, in fp32; the filtered-out
    entries hold ``_NEG_INF``."""
    scaled = logits.float() / params.temperature
    scaled = _filter_top_k(scaled, params.top_k)
    return _filter_top_p(scaled, params.top_p)


def _filtered_probs(logits: Tensor, params: SamplingParams) -> Tensor:
    return torch.softmax(_filtered_logits(logits, params), dim=-1)


def _mix32(x: Tensor) -> Tensor:
    """lowbias32 over int64 tensors holding values in [0, 2^32): a
    bijection of the 32-bit state with full avalanche."""
    x = x ^ (x >> 16)
    x = (x * _MUL1) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & _M32
    return x ^ (x >> 15)


def uniform_noise(seeds: Tensor, positions: Tensor, vocab: int) -> Tensor:
    """[B, vocab] fp32 uniforms in (0, 1), a function of each row's
    (seed, position) and the vocab index alone.

    Each row's two 32-bit keys come from the 64-bit seed and the
    position through ``_mix32``; each entry mixes its vocab index with
    both keys in turn, so two rows are never shifted copies of each
    other."""
    s = seeds.long()
    k1 = _mix32((s & _M32) ^ _GOLDEN)
    k1 = _mix32(k1 ^ ((s >> 32) & _M32))
    k1 = _mix32(k1 ^ (positions.long() & _M32))
    k2 = _mix32(k1 ^ _GOLDEN)
    idx = torch.arange(vocab, dtype=torch.long, device=s.device)
    h = _mix32(_mix32(idx[None, :] ^ k1[:, None]) ^ k2[:, None])
    return unit_interval(h)


def unit_interval(h: Tensor) -> Tensor:
    """32-bit hashes (int64 tensors in [0, 2^32)) -> fp32 in (0, 1): the
    top 23 bits ``k`` give ``(k + 0.5) / 2^23``, exact in fp32, from
    2^-24 to 1 - 2^-24, so ``-log(-log u)`` is finite."""
    return ((h >> 9).float() + 0.5) * 2.0 ** -23


def sample(logits: Tensor, seeds: Union[Tensor, Sequence[int]],
           positions: Union[Tensor, Sequence[int]],
           params: SamplingParams) -> Tensor:
    """[B, V] logits -> [B] int64 tokens. ``seeds``/``positions`` [B] are
    each row's (request seed, position); greedy ignores them. A sampled
    row takes ``argmax(filtered + g)`` with Gumbel noise ``g = -log(-log
    u)``, ``u = uniform_noise(...)``: a draw from the filtered
    distribution (the Gumbel-max identity), computed on the logits'
    device without a host read. A filtered-out entry (``_NEG_INF``) stays
    below every kept one, whatever its noise."""
    if params.greedy:
        return torch.argmax(logits, dim=-1)
    dev = logits.device
    seeds = torch.as_tensor(seeds, dtype=torch.long, device=dev)
    positions = torch.as_tensor(positions, dtype=torch.long, device=dev)
    u = uniform_noise(seeds, positions, logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(_filtered_logits(logits, params) + gumbel, dim=-1)


def finite_mask(logits: Tensor) -> Tensor:
    """[..., V] logits -> [...] bool: True where every entry is finite
    (the engine quarantines a False slot instead of emitting)."""
    return torch.isfinite(logits).all(dim=-1)
