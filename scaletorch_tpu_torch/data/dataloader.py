"""Micro-batch data loading (counterpart of
scaletorch_tpu/data/dataloader.py): ``MicroBatchDataLoader`` over a
tokenized ``[N, seq_len + 1]`` array, ``remap_loader_position``, the
synthetic token stream, and the move of a batch to the device.

Both loaders yield the reference's batch contract: ``input_ids`` /
``target_ids`` [accum, dp * micro_bs, seq] int32 (targets are the inputs
shifted by one) and ``position_ids`` [accum, seq], absolute. Batches stay
numpy on the host; ``device_batch`` moves one to the card in a single
upload. The synthetic stream draws from ``np.random.default_rng(seed)``
and the real-data loader orders each epoch by
``np.random.default_rng(seed + epoch)``, exactly as the reference does,
so the same seed gives byte-identical batches.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from scaletorch_tpu_torch.resilience import retry_with_backoff
from scaletorch_tpu_torch.utils.device import DeviceLike, resolve_device
from scaletorch_tpu_torch.utils.logger import get_logger

Batch = Dict[str, np.ndarray]


def remap_loader_position(position: int, *, old_samples_per_step: int,
                          new_samples_per_step: int) -> int:
    """Translate a checkpointed ``loader_position`` (optimizer steps
    consumed) to another step size (samples per step). The consumed
    region is ``position * old_samples_per_step`` sequences of the
    step-size-independent epoch order; the new position is that region
    over the new step size, rounded UP, so a partly covered step batch
    counts as consumed and is never trained on twice."""
    if old_samples_per_step <= 0 or new_samples_per_step <= 0:
        raise ValueError(
            "samples_per_step must be positive, got "
            f"{old_samples_per_step} -> {new_samples_per_step}")
    if position < 0:
        raise ValueError(f"loader position must be >= 0, got {position}")
    samples = position * old_samples_per_step
    new_position = -(-samples // new_samples_per_step)  # ceil division
    skipped = new_position * new_samples_per_step - samples
    if skipped:
        get_logger().warning(
            f"loader remap: {position} steps x {old_samples_per_step} "
            f"samples does not divide by the new step size "
            f"{new_samples_per_step}; rounding up to step {new_position} "
            f"retires {skipped} extra sample(s) (< 1 step batch) rather "
            "than training on a consumed batch twice")
    return new_position


class MicroBatchDataLoader:
    """Per-optimizer-step batches from a ``[N, seq_len + 1]`` token array.

    Each step-batch read runs under ``retry_with_backoff``
    (``read_retries`` / ``retry_base_delay``); a region that stays
    unreadable is skipped and logged, at most ``max_skipped_batches``
    times (0 = no limit). ``position`` counts the step batches consumed
    and advances BEFORE each yield and across skipped regions, so the
    trainer's checkpointed ``loader_position`` never counts a batch twice
    and a restart walks the same stream with the same regions retired.
    ``fault_injector`` (optional) is any object whose
    ``take_bad_read(position)`` returns True to make that read fail."""

    def __init__(
        self,
        tokens: np.ndarray,
        micro_batch_size: int,
        gradient_accumulation_steps: int,
        data_parallel_size: int = 1,
        seed: int = 42,
        read_retries: int = 2,
        retry_base_delay: float = 0.05,
        max_skipped_batches: int = 16,
        fault_injector: Optional[Any] = None,
    ) -> None:
        if tokens.ndim != 2:
            raise ValueError(
                f"tokens must be [N, seq_len+1], got {tokens.shape}")
        self.tokens = tokens
        self.seq_len = tokens.shape[1] - 1
        self.micro_batch_size = micro_batch_size
        self.grad_accum = gradient_accumulation_steps
        self.dp = data_parallel_size
        self.global_batch_size = micro_batch_size * data_parallel_size
        self.samples_per_step = self.global_batch_size * self.grad_accum
        self.seed = seed
        # a whole step batch is the unit: an epoch's ragged tail is dropped
        if len(tokens) < self.samples_per_step:
            raise ValueError(
                f"dataset has {len(tokens)} sequences < "
                f"{self.samples_per_step} needed per step")
        self.epoch = 0
        self._step_offset = 0  # step batches consumed in this epoch
        self.position = 0      # step batches consumed in all
        self.read_retries = read_retries
        self.retry_base_delay = retry_base_delay
        self.max_skipped_batches = max_skipped_batches
        self.skipped_positions: list = []
        self._injector = fault_injector

    @property
    def tokens_per_step(self) -> int:
        return self.samples_per_step * self.seq_len

    def steps_per_epoch(self) -> int:
        return len(self.tokens) // self.samples_per_step

    def _epoch_order(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + self.epoch)
        return rng.permutation(len(self.tokens))

    def set_data_parallel_size(self, data_parallel_size: int) -> None:
        """Adopt a new dp degree in place (an elastic remesh). Only the
        step geometry changes (global batch, samples per step); the epoch
        permutation does not depend on dp, so the caller re-seats
        ``position`` with ``remap_loader_position`` and ``set_state`` and
        drops any live iterator."""
        if data_parallel_size < 1:
            raise ValueError(
                f"data_parallel_size must be >= 1, got {data_parallel_size}"
            )
        self.dp = data_parallel_size
        self.global_batch_size = self.micro_batch_size * data_parallel_size
        self.samples_per_step = self.global_batch_size * self.grad_accum
        if len(self.tokens) < self.samples_per_step:
            raise ValueError(
                f"dataset has {len(self.tokens)} sequences < "
                f"{self.samples_per_step} needed per step after the dp "
                "change"
            )

    def set_state(self, steps_consumed: int) -> None:
        """Fast-forward to just after ``steps_consumed`` step batches.
        Index-only: no data is read. A live iterator predates the new
        state: drop it and iterate again."""
        spe = self.steps_per_epoch()
        self.epoch = steps_consumed // spe
        self._step_offset = steps_consumed % spe
        self.position = steps_consumed

    def _read_step(self, order: np.ndarray, i: int) -> Optional[Batch]:
        """One step-batch read under retry-with-backoff; None when the
        region stayed unreadable and was skipped."""
        position = self.position

        def read() -> Batch:
            if (self._injector is not None
                    and self._injector.take_bad_read(position)):
                raise OSError(f"injected corrupt batch read at stream "
                              f"position {position}")
            idx = order[i * self.samples_per_step:
                        (i + 1) * self.samples_per_step]
            return self._collate(self.tokens[idx])

        try:
            return retry_with_backoff(
                read, retries=self.read_retries,
                base_delay=self.retry_base_delay, retriable=(OSError,),
                describe=f"batch read (stream position {position})")
        except OSError as exc:
            self.skipped_positions.append(position)
            if (self.max_skipped_batches > 0
                    and len(self.skipped_positions)
                    > self.max_skipped_batches):
                raise RuntimeError(
                    f"{len(self.skipped_positions)} unreadable step "
                    f"batches exceed max_skipped_batches="
                    f"{self.max_skipped_batches}: the data source is "
                    "broken, not flaky") from exc
            get_logger().error(
                f"batch read at stream position {position} unreadable "
                f"after {self.read_retries + 1} attempts ({exc!r}): "
                "skipping the region (it stays retired on restart through "
                "loader_position)")
            return None

    def __iter__(self) -> Iterator[Batch]:
        """Step batches without end, epoch after epoch. The position
        advances before each yield (and before a skip), so an exception
        between fetch and step never counts a batch twice."""
        while True:
            order = self._epoch_order()
            spe = self.steps_per_epoch()
            while self._step_offset < spe:
                i = self._step_offset
                batch = self._read_step(order, i)
                self._step_offset = i + 1
                self.position += 1
                if batch is None:
                    continue
                yield batch
            self.epoch += 1
            self._step_offset = 0

    def _collate(self, chunk: np.ndarray) -> Batch:
        a, g, s = self.grad_accum, self.global_batch_size, self.seq_len
        return {
            "input_ids": np.ascontiguousarray(
                chunk[:, :-1].reshape(a, g, s), dtype=np.int32),
            "target_ids": np.ascontiguousarray(
                chunk[:, 1:].reshape(a, g, s), dtype=np.int32),
            "position_ids": np.broadcast_to(
                np.arange(s, dtype=np.int32), (a, s)).copy(),
        }


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

    def set_data_parallel_size(self, data_parallel_size: int) -> None:
        """An elastic remesh's new dp degree (the synthetic stream has no
        position to re-seat)."""
        if data_parallel_size < 1:
            raise ValueError(
                f"data_parallel_size must be >= 1, got {data_parallel_size}"
            )
        self.dp = data_parallel_size
        self.global_batch_size = self.micro_batch_size * data_parallel_size

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
