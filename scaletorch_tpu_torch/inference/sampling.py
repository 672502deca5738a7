"""Token sampling: greedy / temperature / top-k / top-p (PyTorch port).

Greedy is exact: ``torch.argmax`` returns the first maximum, as
``jnp.argmax`` does. Sampled paths cannot reproduce JAX's threefry
``fold_in`` keys; instead every token draws from a ``torch.Generator``
seeded by (request seed, position), so a request's stream does not
depend on the slot it landed in or on what its neighbours sample.

Filter order follows the HF convention: temperature first, then top-k,
then top-p on the already-scaled distribution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

Tensor = torch.Tensor

_NEG_INF = torch.finfo(torch.float32).min
_MASK64 = (1 << 64) - 1


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


def position_seed(seed: int, position: int) -> int:
    """A 63-bit generator seed for one (request seed, position) pair
    (splitmix64 finalizer over the pair)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(position) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def _filtered_probs(logits: Tensor, params: SamplingParams) -> Tensor:
    scaled = logits.float() / params.temperature
    scaled = _filter_top_k(scaled, params.top_k)
    scaled = _filter_top_p(scaled, params.top_p)
    return torch.softmax(scaled, dim=-1)


def sample(logits: Tensor, seeds: Sequence[int], positions: Sequence[int],
           params: SamplingParams) -> Tensor:
    """[B, V] logits -> [B] int64 tokens. ``seeds``/``positions`` are the
    host-side (request seed, position) of each row; greedy ignores them."""
    if params.greedy:
        return torch.argmax(logits, dim=-1)
    probs = _filtered_probs(logits, params)
    seeds = np.asarray(seeds).tolist()
    positions = np.asarray(positions).tolist()
    out = torch.empty(logits.shape[0], dtype=torch.long, device=logits.device)
    for b in range(logits.shape[0]):
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(position_seed(seeds[b], positions[b]))
        out[b] = torch.multinomial(probs[b], 1, generator=gen)[0]
    return out


def finite_mask(logits: Tensor) -> Tensor:
    """[..., V] logits -> [...] bool: True where every entry is finite
    (the engine quarantines a False slot instead of emitting)."""
    return torch.isfinite(logits).all(dim=-1)
