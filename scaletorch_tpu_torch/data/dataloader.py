"""The synthetic token stream (a copy of
scaletorch_tpu/data/dataloader.SyntheticDataLoader) and the move of a
batch to the device.

The stream draws from ``np.random.default_rng(seed)`` exactly as the
reference does, so the same seed gives byte-identical batches:
``input_ids``/``target_ids`` [accum, dp * micro_bs, seq] int32 (targets
are the inputs shifted by one) and ``position_ids`` [accum, seq].
``MicroBatchDataLoader`` over a real tokenized dataset is still to port
(ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from scaletorch_tpu_torch.utils.device import DeviceLike, resolve_device

Batch = Dict[str, np.ndarray]


class SyntheticDataLoader:
    """On-host random token stream with the reference's batch contract."""

    def __init__(
        self,
        vocab_size: int,
        sequence_length: int,
        micro_batch_size: int,
        gradient_accumulation_steps: int,
        data_parallel_size: int = 1,
        seed: int = 0,
    ) -> None:
        self.vocab_size = vocab_size
        self.seq_len = sequence_length
        self.micro_batch_size = micro_batch_size
        self.grad_accum = gradient_accumulation_steps
        self.dp = data_parallel_size
        self.global_batch_size = micro_batch_size * data_parallel_size
        self.rng = np.random.default_rng(seed)

    @property
    def tokens_per_step(self) -> int:
        return self.grad_accum * self.global_batch_size * self.seq_len

    def __iter__(self) -> Iterator[Batch]:
        while True:
            toks = self.rng.integers(
                0,
                self.vocab_size,
                size=(self.grad_accum, self.global_batch_size,
                      self.seq_len + 1),
                dtype=np.int32,
            )
            yield {
                "input_ids": toks[:, :, :-1],
                "target_ids": toks[:, :, 1:],
                "position_ids": np.broadcast_to(
                    np.arange(self.seq_len, dtype=np.int32),
                    (self.grad_accum, self.seq_len),
                ).copy(),
            }


def device_batch(batch: Batch, device: DeviceLike = None
                 ) -> Dict[str, torch.Tensor]:
    """The host batch on ``device`` (None = the CUDA card) in ONE upload:
    every array is packed into one int32 buffer (pinned on a CUDA host),
    copied once, and split into views on the device."""
    dev = resolve_device(device)
    arrays = {k: np.ascontiguousarray(v, dtype=np.int32)
              for k, v in batch.items()}
    packed = torch.from_numpy(
        np.concatenate([a.reshape(-1) for a in arrays.values()]))
    if dev.type == "cuda":
        packed = packed.pin_memory().to(dev, non_blocking=True)
    out, offset = {}, 0
    for key, a in arrays.items():
        out[key] = packed[offset:offset + a.size].view(a.shape)
        offset += a.size
    return out
