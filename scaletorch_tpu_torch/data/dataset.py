"""Dataset tokenization (counterpart of scaletorch_tpu/data/dataset.py):
the strategy registry, the default ``concat_chunk`` strategy, and
``DatasetProcessor``.

``concat_chunk`` concatenates every document's tokens (each followed by
``eos``) and cuts the stream into ``seq_len + 1`` chunks, dropping the
ragged tail; each chunk gives ``seq_len`` inputs and their shifted
targets.

The reference loads through HF ``datasets``; the port reads a local
``.json`` / ``.jsonl`` file with the standard library and maps the
strategy the way ``datasets.Dataset.map(batched=True)`` does: batches of
``MAP_BATCH_SIZE`` rows, and, with ``num_proc`` over more than
``MAP_BATCH_SIZE`` rows, contiguous shards mapped one after the other
(the same chunks the reference's worker processes produce, in the same
order). Nothing is fetched from a hub: a name that is not a local file
raises. A tokenizer given by name is built with ``transformers``, which
is imported only then.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List

import numpy as np

from scaletorch_tpu_torch.resilience import retry_with_backoff

_STRATEGIES: Dict[str, Callable] = {}

# datasets.Dataset.map's default batch_size
MAP_BATCH_SIZE = 1000

Columns = Dict[str, List[Any]]


def register_tokenize_strategy(name: str, fn: Callable = None):
    """Register ``strategy(examples, tokenizer, seq_len, text_key) ->
    {"input_ids": [[seq_len + 1 tokens], ...]}`` over a batch of rows
    given as columns."""

    def _register(f):
        _STRATEGIES[name] = f
        return f

    if fn is not None:
        return _register(fn)
    return _register


@register_tokenize_strategy("concat_chunk")
def concat_chunk(examples, tokenizer, seq_len: int, text_key: str = "text"):
    """Every document's tokens (+ eos) concatenated and cut into
    ``seq_len + 1`` chunks; the ragged tail is dropped."""
    eos = tokenizer.eos_token_id
    stream: List[int] = []
    for text in examples[text_key]:
        toks = tokenizer(text, add_special_tokens=False)["input_ids"]
        stream.extend(toks)
        if eos is not None:
            stream.append(eos)
    chunk = seq_len + 1
    n = (len(stream) // chunk) * chunk
    return {"input_ids": [stream[i:i + chunk] for i in range(0, n, chunk)]}


def get_tokenize_strategy(name: str) -> Callable:
    if name not in _STRATEGIES:
        raise KeyError(f"unknown tokenize strategy {name!r}; have "
                       f"{sorted(_STRATEGIES)}")
    return _STRATEGIES[name]


def read_json_rows(path: str) -> Columns:
    """The rows of a local ``.json`` / ``.jsonl`` file as columns (a key
    missing from a row reads None). A ``.json`` file may hold a list of
    objects, an object of columns, or one object per line; a ``.jsonl``
    file holds one object per line and is read a line at a time."""
    if path.endswith(".json"):
        with open(path, encoding="utf-8") as f:
            try:
                data = json.load(f)
            except json.JSONDecodeError:
                data = None  # one object per line
        if isinstance(data, dict):
            return {k: list(v) for k, v in data.items()}
        if isinstance(data, list):
            return _columns(data)
    with open(path, encoding="utf-8") as f:
        return _columns(json.loads(line) for line in f if line.strip())


def _columns(rows) -> Columns:
    columns: Columns = {}
    n = 0
    for row in rows:
        for key in row:
            if key not in columns:
                columns[key] = [None] * n
        for key, values in columns.items():
            values.append(row.get(key))
        n += 1
    return columns


def _num_rows(columns: Columns) -> int:
    return len(next(iter(columns.values()))) if columns else 0


def _contiguous_shards(n: int, num_shards: int):
    """(start, end) of each contiguous shard, as ``Dataset.shard(...,
    contiguous=True)`` cuts them."""
    div, mod = divmod(n, num_shards)
    for i in range(num_shards):
        start = div * i + min(i, mod)
        yield start, start + div + (1 if i < mod else 0)


class DatasetProcessor:
    """Tokenizer + local dataset loading + strategy-driven tokenization."""

    def __init__(
        self,
        tokenizer_name_or_path,
        sequence_length: int,
        tokenize_strategy: str = "concat_chunk",
        text_key: str = "text",
        num_proc: int = 4,
        load_retries: int = 2,
        load_retry_base_delay: float = 1.0,
    ) -> None:
        if isinstance(tokenizer_name_or_path, str):
            from transformers import AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(
                tokenizer_name_or_path)
        else:
            # an already-constructed tokenizer object (offline / custom)
            self.tokenizer = tokenizer_name_or_path
        self.sequence_length = sequence_length
        self.strategy = get_tokenize_strategy(tokenize_strategy)
        self.text_key = text_key
        self.num_proc = num_proc
        self.load_retries = load_retries
        self.load_retry_base_delay = load_retry_base_delay

    def load(self, dataset_name: str, split: str = "train") -> Columns:
        """The rows of a local ``.json`` / ``.jsonl`` file (one split: the
        file is the split), read under retry-with-backoff."""
        if not (os.path.isfile(dataset_name)
                and dataset_name.endswith((".json", ".jsonl"))):
            raise FileNotFoundError(
                f"dataset {dataset_name!r} is not a local .json/.jsonl "
                "file; the port reads local files only (no hub download): "
                "write the corpus to a local file and pass its path")
        return retry_with_backoff(
            lambda: read_json_rows(dataset_name),
            retries=self.load_retries,
            base_delay=self.load_retry_base_delay,
            retriable=(OSError,),
            describe=f"dataset load ({dataset_name})",
        )

    def tokenize(self, columns: Columns) -> Dict[str, np.ndarray]:
        """Map the strategy over the rows in batches, dropping the raw
        columns: ``{"input_ids": [N, seq_len + 1] int32}``, each batch's
        chunks packed as they come, so the host holds 4 bytes a token.
        One process does it all."""
        n = _num_rows(columns)
        shards = [(0, n)]
        if self.num_proc and self.num_proc > 1 and n > MAP_BATCH_SIZE:
            shards = list(_contiguous_shards(n, min(self.num_proc, n)))
        chunk = self.sequence_length + 1
        blocks = [np.zeros((0, chunk), np.int32)]
        for lo, hi in shards:
            for start in range(lo, hi, MAP_BATCH_SIZE):
                stop = min(start + MAP_BATCH_SIZE, hi)
                batch = {k: v[start:stop] for k, v in columns.items()}
                mapped = self.strategy(batch, self.tokenizer,
                                       self.sequence_length, self.text_key)
                blocks.append(np.asarray(mapped["input_ids"], np.int32)
                              .reshape(-1, chunk))
        return {"input_ids": np.concatenate(blocks)}

    def process(self, dataset_name: str,
                split: str = "train") -> Dict[str, np.ndarray]:
        return self.tokenize(self.load(dataset_name, split))


def chunks_to_array(dataset) -> np.ndarray:
    """Tokenized dataset -> [N, seq_len + 1] int32 array."""
    return np.asarray(dataset["input_ids"], dtype=np.int32)
