"""Character-level dataset of the minGPT example (the port's own copy of
examples/mingpt/char_dataset.py, which it must not import).

Role parity with reference examples/torch_examples/minigpt/char_dataset.py
(CharDataset: read text, build stoi/itos, serve block_size+1 windows,
train/test split) in numpy — no torch Dataset machinery needed because the
training loop batches windows directly.

Hermetic default: with no --data_path the corpus is the Zen of Python
repeated (stdlib ``this``), so the example runs and visibly learns in
zero-egress environments; point --data_path at tiny-shakespeare (or any
text file) for the real thing.
"""

from __future__ import annotations

import codecs
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def default_corpus(repeats: int = 64) -> str:
    import this as zen  # noqa: PLC0415 — stdlib easter egg IS the corpus

    text = codecs.decode(zen.s, "rot13")
    return text * repeats


@dataclass
class CharDataset:
    """Fixed-window char-LM dataset over one text blob."""

    text: str
    block_size: int
    train_split: float = 0.9

    def __post_init__(self) -> None:
        chars = sorted(set(self.text))
        self.vocab_size = len(chars)
        self.stoi = {ch: i for i, ch in enumerate(chars)}
        self.itos = {i: ch for i, ch in enumerate(chars)}
        data = np.asarray([self.stoi[c] for c in self.text], np.int32)
        n_train = int(len(data) * self.train_split)
        self.train_data, self.test_data = data[:n_train], data[n_train:]

    def encode(self, s: str) -> np.ndarray:
        return np.asarray([self.stoi[c] for c in s], np.int32)

    def decode(self, ids) -> str:
        return "".join(self.itos[int(i)] for i in np.asarray(ids).ravel())

    def batches(self, split: str, batch_size: int, rng: np.random.Generator):
        """Infinite stream of (x [B, block], y [B, block]) windows."""
        data = self.train_data if split == "train" else self.test_data
        high = len(data) - self.block_size - 1
        assert high > 0, "corpus shorter than block_size"
        while True:
            starts = rng.integers(0, high, batch_size)
            x = np.stack([data[s:s + self.block_size] for s in starts])
            y = np.stack([data[s + 1:s + 1 + self.block_size] for s in starts])
            yield x, y


def load_dataset(
    data_path: Optional[str], block_size: int, train_split: float = 0.9
) -> Tuple[CharDataset, str]:
    if data_path:
        with open(data_path, encoding="utf-8") as f:
            return (CharDataset(f.read(), block_size, train_split),
                    data_path)
    return CharDataset(default_corpus(), block_size, train_split), "zen-of-python"
