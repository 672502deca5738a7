"""The shared config and scaffold of the attention-variant library
(counterpart of scaletorch_tpu/models/attention/base.py): the config
carries the head bookkeeping and its validation, each variant supplies
its draw (``_draw``, behind ``init``) and ``__call__``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from scaletorch_tpu_torch.models.layers import init_generator
from scaletorch_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class AttentionConfig:
    embed_dim: int = 256
    num_heads: int = 8
    num_kv_heads: Optional[int] = None  # GQA groups; 1 = MQA; None = MHA
    head_dim: Optional[int] = None
    # MLA latent ranks (q / kv down-up projections)
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 64
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.embed_dim % self.num_heads != 0:
            raise ValueError(
                f"embed_dim {self.embed_dim} not divisible by num_heads "
                f"{self.num_heads}")
        kv = self.num_kv_heads
        if kv is not None and self.num_heads % kv != 0:
            raise ValueError(
                f"num_heads {self.num_heads} not divisible by num_kv_heads "
                f"{kv}")

    @property
    def actual_head_dim(self) -> int:
        return self.head_dim or self.embed_dim // self.num_heads

    @property
    def actual_num_kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


class AttentionVariant:
    """The veneer every variant shares."""

    def __init__(self, cfg: AttentionConfig):
        self.cfg = cfg

    def init(self, generator: Optional[torch.Generator] = None, *,
             device: DeviceLike = None):
        """Fresh parameters on ``device`` (None: the CUDA card), drawn
        from ``generator`` (default: a fresh one on ``device`` seeded
        with 0)."""
        dev = resolve_device(device)
        return self._draw(init_generator(generator, dev), dev)

    def _draw(self, generator: torch.Generator, device: torch.device):
        raise NotImplementedError

    def __call__(self, params, x: torch.Tensor, *, causal: bool = True):
        raise NotImplementedError
