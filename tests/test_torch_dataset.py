"""PyTorch port, the data pipeline against the JAX package's: the same
documents through the port's ``concat_chunk`` and ``DatasetProcessor``
(a local ``.jsonl`` read with the standard library) and through the
reference's (HF ``datasets``) give the same chunks bit for bit, in one
map batch, across several and across ``num_proc`` shards;
``MicroBatchDataLoader`` yields byte-identical batches over more than
one epoch, after ``set_state`` and across an unreadable region (the same
skipped positions); ``remap_loader_position`` agrees over a grid. Every
comparison is exact (tolerance 0)."""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from scaletorch_tpu.data import dataloader as jdl
from scaletorch_tpu.data import dataset as jds
from scaletorch_tpu_torch.data import dataloader as tdl
from scaletorch_tpu_torch.data import dataset as tds

ROOT = Path(__file__).resolve().parents[1]


class WordTokenizer:
    """A deterministic offline tokenizer: words hashed into 2..98."""

    eos_token_id = 1

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": [
            int.from_bytes(hashlib.sha256(w.encode()).digest()[:4],
                           "little") % 97 + 2 for w in text.split()]}


# The reference's DatasetProcessor maps through HF datasets, which forks
# worker processes for more than 1000 rows; a fork of this process (JAX
# running, multithreaded) can deadlock, so the reference side of those
# cases runs in a fresh interpreter (this file loaded there for its
# tokenizer), as the reference's own determinism test runs it.
REFERENCE_PROCESS = """
import importlib.util
import sys

import numpy as np

from scaletorch_tpu.data import dataset as jds

here, path, num_proc, out = sys.argv[1:]
spec = importlib.util.spec_from_file_location("dataset_parity", here)
test = importlib.util.module_from_spec(spec)
spec.loader.exec_module(test)
proc = jds.DatasetProcessor(test.WordTokenizer(), 16, num_proc=int(num_proc))
np.save(out, jds.chunks_to_array(proc.process(path)))
"""


def reference_chunks(path, num_proc, tmp_path):
    out = str(tmp_path / "reference.npy")
    res = subprocess.run(
        [sys.executable, "-c", REFERENCE_PROCESS, __file__, path,
         str(num_proc), out],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return np.load(out)


class NoEosTokenizer(WordTokenizer):
    eos_token_id = None


def write_corpus(path, n_docs, seed=0, fmt="jsonl"):
    rng = np.random.default_rng(seed)
    rows = [{"text": " ".join(f"w{rng.integers(0, 500)}"
                              for _ in range(int(rng.integers(3, 40)))),
             "id": i} for i in range(n_docs)]
    with open(path, "w") as f:
        if fmt == "jsonl":
            f.writelines(json.dumps(r) + "\n" for r in rows)
        else:
            json.dump(rows, f)
    return rows


@pytest.mark.parametrize("tok", [WordTokenizer(), NoEosTokenizer()],
                         ids=["eos", "no-eos"])
@pytest.mark.parametrize("seq", [4, 7, 16])
def test_concat_chunk_equals_the_reference(tok, seq):
    rng = np.random.default_rng(seq)
    texts = [" ".join(f"w{rng.integers(0, 50)}" for _ in range(k))
             for k in rng.integers(0, 12, size=25)]
    ours = tds.concat_chunk({"text": texts}, tok, seq)
    theirs = jds.concat_chunk({"text": texts}, tok, seq)
    assert ours == theirs
    assert all(len(c) == seq + 1 for c in ours["input_ids"])
    assert tds.get_tokenize_strategy("concat_chunk") is tds.concat_chunk
    with pytest.raises(KeyError, match="unknown"):
        tds.get_tokenize_strategy("nope")


@pytest.mark.parametrize("n_docs,num_proc,fmt", [
    (40, 4, "jsonl"),     # one map batch
    (40, 4, "json"),      # a .json list of rows
    (2500, 1, "jsonl"),   # three map batches, each with its ragged tail
    (2500, 2, "jsonl"),   # two contiguous shards of two batches each
])
def test_processor_equals_the_reference(tmp_path, n_docs, num_proc, fmt):
    path = str(tmp_path / f"corpus.{fmt}")
    rows = write_corpus(path, n_docs, fmt=fmt)
    tok = WordTokenizer()
    ours = tds.DatasetProcessor(tok, 16, num_proc=num_proc)
    loaded = ours.load(path)
    assert loaded["text"] == [r["text"] for r in rows]
    assert loaded["id"] == [r["id"] for r in rows]
    a = tds.chunks_to_array(ours.process(path))
    b = reference_chunks(path, num_proc, tmp_path)
    assert a.dtype == b.dtype == np.int32 and a.shape == b.shape
    assert a.shape[0] > 0 and a.tobytes() == b.tobytes()


def test_rows_with_missing_keys_read_as_the_reference(tmp_path):
    # streamed a line at a time: a key a row lacks reads None, a key that
    # first appears late is None in the rows before it; blank lines skip
    path = tmp_path / "rows.jsonl"
    path.write_text('{"text": "a b", "id": 1}\n\n{"id": 2}\n'
                    '{"text": "c", "id": 3, "lang": "en"}\n')
    ours = tds.DatasetProcessor(WordTokenizer(), 8).load(str(path))
    theirs = jds.DatasetProcessor(WordTokenizer(), 8).load(str(path))
    assert ours == theirs.to_dict()
    assert list(ours) == ["text", "id", "lang"]


def test_processor_reads_local_files_only(tmp_path):
    proc = tds.DatasetProcessor(WordTokenizer(), 8)
    with pytest.raises(FileNotFoundError, match="local"):
        proc.load("HuggingFaceFW/fineweb")
    with pytest.raises(FileNotFoundError, match="local"):
        proc.load(str(tmp_path))  # a directory


def make_tokens(n, seq, seed=0):
    return np.random.default_rng(seed).integers(
        0, 1000, size=(n, seq + 1), dtype=np.int32)


def assert_same(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
        assert a[key].tobytes() == b[key].tobytes(), key


KW = dict(micro_batch_size=2, gradient_accumulation_steps=2, seed=7)


# 5 steps an epoch: 21 sequences drop one, 20 drop none
@pytest.mark.parametrize("n_seq", [21, 20])
def test_loader_batches_equal_over_epochs(n_seq):
    tokens = make_tokens(n_seq, 8)
    ours = tdl.MicroBatchDataLoader(tokens, **KW)
    theirs = jdl.MicroBatchDataLoader(tokens, **KW)
    assert ours.tokens_per_step == theirs.tokens_per_step == 4 * 8
    assert ours.steps_per_epoch() == theirs.steps_per_epoch() == 5
    it_a, it_b = iter(ours), iter(theirs)
    for _ in range(12):  # into the third epoch
        assert_same(next(it_a), next(it_b))
        assert (ours.position, ours.epoch) == (theirs.position, theirs.epoch)


@pytest.mark.parametrize("k", [0, 1, 4, 5, 6, 11])
def test_set_state_continues_the_reference_stream(k):
    tokens = make_tokens(20, 8, seed=1)  # 5 steps an epoch
    stream = iter(jdl.MicroBatchDataLoader(tokens, **KW))
    batches = [next(stream) for _ in range(k + 3)]
    ours = tdl.MicroBatchDataLoader(tokens, **KW)
    ours.set_state(k)
    assert ours.position == k
    it = iter(ours)
    for want in batches[k:]:
        assert_same(next(it), want)


class BadReads:
    """Every read of the listed stream positions fails."""

    def __init__(self, bad):
        self.bad = set(bad)

    def take_bad_read(self, position):
        return position in self.bad


def test_unreadable_region_is_skipped_as_the_reference_skips_it():
    tokens = make_tokens(24, 8, seed=2)  # 6 steps an epoch
    kw = dict(KW, read_retries=1, retry_base_delay=0.0)
    ours = tdl.MicroBatchDataLoader(tokens, fault_injector=BadReads({1, 7}),
                                    **kw)
    theirs = jdl.MicroBatchDataLoader(tokens,
                                      fault_injector=BadReads({1, 7}), **kw)
    it_a, it_b = iter(ours), iter(theirs)
    for _ in range(9):
        assert_same(next(it_a), next(it_b))
        assert ours.position == theirs.position
    assert ours.skipped_positions == theirs.skipped_positions == [1, 7]
    bounded = tdl.MicroBatchDataLoader(
        tokens, fault_injector=BadReads({0, 1}), max_skipped_batches=1, **kw)
    with pytest.raises(RuntimeError, match="max_skipped_batches"):
        next(iter(bounded))


def test_loader_refusals_match_the_reference():
    for cls in (tdl.MicroBatchDataLoader, jdl.MicroBatchDataLoader):
        with pytest.raises(ValueError, match="needed per step"):
            cls(make_tokens(3, 8), **KW)
        with pytest.raises(ValueError, match="seq_len"):
            cls(np.zeros((8,), np.int32), **KW)


@pytest.mark.parametrize("old", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("new", [1, 2, 3, 4, 8])
def test_remap_loader_position_equals_the_reference(old, new):
    for position in range(0, 13):
        kw = dict(old_samples_per_step=old, new_samples_per_step=new)
        assert (tdl.remap_loader_position(position, **kw)
                == jdl.remap_loader_position(position, **kw))


def test_remap_loader_position_refusals():
    for fn in (tdl.remap_loader_position, jdl.remap_loader_position):
        with pytest.raises(ValueError, match="positive"):
            fn(1, old_samples_per_step=0, new_samples_per_step=2)
        with pytest.raises(ValueError, match=">= 0"):
            fn(-1, old_samples_per_step=2, new_samples_per_step=2)
