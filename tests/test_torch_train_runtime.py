"""PyTorch port, the training runtime on the CPU: data from a local
``.jsonl``, a fixed held-out eval set, checkpoint and resume, and
Hugging Face weights, through ``Trainer(cfg)`` and ``python -m
scaletorch_tpu_torch.train``.

* 4 straight steps equal 2 steps + save + a fresh ``Trainer`` with
  ``resume="must"`` + 2 steps, bit for bit in fp32 (losses, val losses,
  learning rates, parameters, AdamW's moments and ``count``), with
  synchronous and asynchronous saves.
* The port's ``Trainer`` and the JAX package's, both loading one
  reference-written HF checkpoint and reading one ``.jsonl``, give the
  same losses, learning rates and ``evaluate()`` within 1e-5 (fp32).
* The eval set stays fixed across calls and grows from one iterator.
* The config validation (``resume``, its alias, the retry counts)
  matches the reference's.
* The command line trains from a file with a tokenizer ``transformers``
  loads from disk, saves, resumes, and exports HF weights.
* ``to_readable_format``, the monitor and the system info (logged by a
  ``verbose`` Trainer).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from scaletorch_tpu import config as jconfig
from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.models import qwen3 as jqwen3
from scaletorch_tpu.utils import hf_interop as jhf
from scaletorch_tpu.utils import misc as jmisc
from scaletorch_tpu_torch import config as tconfig
from scaletorch_tpu_torch import train as ttrain
from scaletorch_tpu_torch.models import qwen3 as tqwen3
from scaletorch_tpu_torch.trainer.optimizer import tree_leaves
from scaletorch_tpu_torch.trainer.trainer import Trainer
from scaletorch_tpu_torch.utils import device as tdevice
from scaletorch_tpu_torch.utils import env_info, hf_interop, monitor
from scaletorch_tpu_torch.utils import misc as tmisc
from scaletorch_tpu_torch.utils.logger import get_logger
from tests.test_torch_one_thread import one_torch_thread  # noqa: F401


ARCH = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, max_position_embeddings=128,
            tie_word_embeddings=True, rope_theta=10000.0)
LOSS_TOL = 1e-5


class ByteTokenizer:
    """Bytes shifted past the eos id: ids 2..127."""

    eos_token_id = 1

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": [b % 126 + 2 for b in text.encode()]}


def write_jsonl(path, n_docs, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n_docs):
            words = ["".join(chr(97 + int(c))
                             for c in rng.integers(0, 26, rng.integers(1, 9)))
                     for _ in range(int(rng.integers(4, 20)))]
            f.write(json.dumps({"text": " ".join(words)}) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return (write_jsonl(root / "train.jsonl", 80, 0),
            write_jsonl(root / "val.jsonl", 30, 1))


def runtime_cfg(corpus, **kw):
    train, val = corpus
    base = dict(model_type="qwen3", **ARCH, sequence_length=16,
                micro_batch_size=2, gradient_accumulation_steps=2,
                dtype="float32", total_train_steps=4, warmup_steps=1,
                dataset_name=train, eval_dataset_name=val,
                eval_frequency=2, eval_steps=2, save_frequency=2,
                keep_n_checkpoints=1, log_frequency=1)
    return tconfig.ScaleTorchTPUArguments(**{**base, **kw})


def records(trainer, steps):
    by_step = {r["step"]: r for r in trainer.history}
    return [(by_step[s]["loss"], by_step[s]["lr"], by_step[s]["grad_norm"],
             by_step[s].get("val_loss")) for s in steps]


def state_bits(trainer):
    return [t.detach().clone() for t in
            tree_leaves(trainer.params) + tree_leaves(trainer.opt_state)]


@pytest.mark.parametrize("async_save", [False, True])
def test_resume_is_bit_exact(tmp_path, corpus, async_save):
    straight = Trainer(runtime_cfg(corpus, checkpoint_dir=str(tmp_path / "a"),
                                   async_checkpointing=async_save),
                       device="cpu", tokenizer=ByteTokenizer())
    straight.train()
    assert straight.global_step == 4 and straight.loader.position == 4
    cfg = runtime_cfg(corpus, checkpoint_dir=str(tmp_path / "b"),
                      async_checkpointing=async_save)
    first = Trainer(cfg, device="cpu", tokenizer=ByteTokenizer())
    first.train(num_steps=2)
    assert first.checkpoint_manager.all_steps() == [2]
    assert records(first, [1, 2]) == records(straight, [1, 2])
    first.close()
    del first
    resumed = Trainer(dataclasses.replace(cfg, resume="must"), device="cpu",
                      tokenizer=ByteTokenizer())
    assert resumed.global_step == 2 and resumed.loader.position == 2
    assert int(resumed.opt_state["count"]) == 2
    assert resumed.tokens_seen == 2 * 4 * 16
    resumed.train()
    assert resumed.global_step == 4 and int(resumed.opt_state["count"]) == 4
    # losses, learning rates, grad norms and val losses of steps 3-4
    assert records(resumed, [3, 4]) == records(straight, [3, 4])
    assert records(resumed, [4])[0][3] is not None
    for a, b in zip(state_bits(resumed), state_bits(straight)):
        assert torch.equal(a, b)
    assert resumed.checkpoint_manager.all_steps() == [4]  # keep_n 1


def test_resume_auto_without_a_checkpoint_starts_fresh(tmp_path, corpus):
    trainer = Trainer(runtime_cfg(corpus, checkpoint_dir=str(tmp_path),
                                  resume="auto"),
                      device="cpu", tokenizer=ByteTokenizer())
    assert trainer.global_step == 0
    with pytest.raises(FileNotFoundError, match="resume must"):
        Trainer(runtime_cfg(corpus, checkpoint_dir=str(tmp_path),
                            resume="must"),
                device="cpu", tokenizer=ByteTokenizer())


def test_eval_set_stays_fixed(corpus):
    trainer = Trainer(runtime_cfg(corpus, eval_steps=2), device="cpu",
                      tokenizer=ByteTokenizer())
    first = trainer.evaluate()
    cached = list(trainer._eval_batches)
    assert trainer.evaluate() == first
    trainer.evaluate(4)  # extends the set from the same iterator
    assert len(trainer._eval_batches) == 4
    assert all(a is b for a, b in zip(cached, trainer._eval_batches))
    assert trainer.evaluate(2) == first
    synthetic = Trainer(runtime_cfg(corpus, synthetic_data=True,
                                    eval_dataset_name=None), device="cpu")
    assert synthetic.evaluate() == synthetic.evaluate()
    no_eval_set = Trainer(runtime_cfg(corpus, eval_dataset_name=None),
                          device="cpu", tokenizer=ByteTokenizer())
    assert no_eval_set.evaluate() is None


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("hf")
    jcfg = jqwen3.Qwen3Config(**ARCH, dtype=jnp.float32)
    jhf.save_hf_params(str(path), jllama.init_params(jax.random.PRNGKey(7),
                                                     jcfg), jcfg)
    transformers.Qwen3Config(**ARCH).save_pretrained(str(path))
    return str(path)


def test_trainer_matches_the_reference_trainer(corpus, reference_checkpoint,
                                               monkeypatch):
    from scaletorch_tpu.trainer.trainer import Trainer as JTrainer

    kw = dict(model_type="qwen3", model_name_or_path=reference_checkpoint,
              load_pretrained_weights=True, dataset_name=corpus[0],
              eval_dataset_name=corpus[1], eval_frequency=2, eval_steps=2,
              sequence_length=16, gradient_accumulation_steps=2,
              dtype="float32", total_train_steps=3, warmup_steps=1,
              max_grad_norm=1.0, log_frequency=1)
    # one card's micro-batch of 8 rows is the reference's 8 virtual
    # devices (the JAX platform these tests run on) at 1 row each
    ours = Trainer(tconfig.ScaleTorchTPUArguments(**kw, micro_batch_size=8),
                   device="cpu", tokenizer=ByteTokenizer())
    # the reference builds its tokenizer by name: hand it the same one
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda *a, **k: ByteTokenizer())
    dp = len(jax.devices())
    theirs = JTrainer(jconfig.ScaleTorchTPUArguments(
        **kw, micro_batch_size=8 // dp, data_parallel_size=dp))
    assert ours.num_params == theirs.metrics.num_params
    ours.train()
    theirs.train()
    a, b = ours.history, theirs.metrics.history
    assert [r["step"] for r in a] == [r["step"] for r in b] == [1, 2, 3]
    for ra, rb in zip(a, b):
        # the reference's schedule runs in fp32, the port's in Python floats
        assert ra["lr"] == pytest.approx(rb["lr"], rel=1e-6)
        assert abs(ra["loss"] - rb["loss"]) <= LOSS_TOL
        assert abs(ra["grad_norm"] - rb["grad_norm"]) <= LOSS_TOL
    assert abs(ours.evaluate() - theirs.evaluate()) <= LOSS_TOL
    assert abs(ours.evaluate(3) - theirs.evaluate(3)) <= LOSS_TOL


def test_pretrained_weights_load_into_the_trainer(reference_checkpoint,
                                                  corpus):
    cfg = tconfig.ScaleTorchTPUArguments(
        model_type="qwen3", model_name_or_path=reference_checkpoint,
        load_pretrained_weights=True, synthetic_data=True, dtype="float32",
        sequence_length=16)
    trainer = Trainer(cfg, device="cpu")
    assert trainer.model_cfg.num_hidden_layers == ARCH["num_hidden_layers"]
    want = hf_interop.load_hf_params(reference_checkpoint, trainer.model_cfg,
                                     device="cpu")
    for a, b in zip(tree_leaves(trainer.params), tree_leaves(want)):
        assert a.requires_grad and torch.equal(a.detach(), b)
    with pytest.raises(ValueError, match="model_name_or_path"):
        Trainer(dataclasses.replace(cfg, model_name_or_path=None),
                device="cpu")
    with pytest.raises(ValueError, match="tokenizer"):
        Trainer(runtime_cfg(corpus), device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(resume="must"), "checkpoint_dir"),
    (dict(resume="sometimes"), "resume"),
    (dict(checkpoint_retries=-1), "checkpoint_retries"),
    (dict(data_read_retries=-1), "data_read_retries"),
    (dict(data_max_skipped_batches=-1), "data_max_skipped_batches"),
])
def test_config_validation_matches_the_reference(kw, match):
    for cls in (tconfig.ScaleTorchTPUArguments,
                jconfig.ScaleTorchTPUArguments):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


@pytest.mark.parametrize("kw", [
    dict(resume_from_checkpoint=True),
    dict(resume_from_checkpoint=True, resume="must", checkpoint_dir="/x"),
    dict(resume="auto"),
    dict(),
])
def test_resume_alias_matches_the_reference(kw):
    ours = tconfig.ScaleTorchTPUArguments(**kw)
    theirs = jconfig.ScaleTorchTPUArguments(**kw)
    assert ours.resume == theirs.resume


def letter_tokenizer(path):
    """A letter-level tokenizer saved where ``AutoTokenizer`` loads it."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"[UNK]": 0, "</s>": 1}
    for i in range(26):  # one id per letter; a space is [UNK]
        vocab[chr(97 + i)] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Split("", "isolated")
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="[UNK]", eos_token="</s>")
    fast.save_pretrained(str(path))
    return str(path)


def test_train_cli_trains_from_a_file_and_resumes(tmp_path, corpus):
    tok = letter_tokenizer(tmp_path / "tok")
    ckpt, logs = str(tmp_path / "ckpt"), str(tmp_path / "logs")
    args = ["--device", "cpu", "--tokenizer_name_or_path", tok,
            "--dataset_name", corpus[0], "--eval_dataset_name", corpus[1],
            "--eval_frequency", "2", "--eval_steps", "1",
            "--checkpoint_dir", ckpt, "--save_frequency", "2",
            "--async_checkpointing", "false", "--resume", "auto",
            "--performance_log_dir", logs, "--dtype", "float32",
            "--sequence_length", "16", "--micro_batch_size", "2"]
    for key, value in ARCH.items():
        args += [f"--{key}", str(value)]
    args += ["--model_type", "qwen3"]
    assert ttrain.main(args + ["--total_train_steps", "2"]) == 0
    assert os.listdir(ckpt) == ["2"]
    export = str(tmp_path / "export")
    assert ttrain.main(args + ["--total_train_steps", "4",
                               "--export_hf_dir", export]) == 0
    assert sorted(os.listdir(ckpt)) == ["2", "4"]
    cfg = tqwen3.Qwen3Config.from_hf(hf_interop.read_hf_config(export),
                                     dtype=torch.float32)
    assert all(getattr(cfg, k) == v for k, v in ARCH.items())
    assert set(hf_interop.load_hf_params(export, cfg, device="cpu")) == {
        "embed_tokens", "layers", "norm"}
    with open(os.path.join(logs, "performance_log_step4.json")) as f:
        log = json.load(f)
    steps = [r["step"] for r in log["records"]]
    assert steps == [3, 4] and "val_loss" in log["records"][-1]
    assert all(np.isfinite(r["loss"]) for r in log["records"])


@pytest.mark.parametrize("num", [0, 5, 999, 1000, 12345, 6.7e6, 8.9e9,
                                 1.2e12, -45678])
def test_to_readable_format_matches_the_reference(num):
    assert tmisc.to_readable_format(num) == jmisc.to_readable_format(num)


def test_monitor_and_system_info_on_the_cpu():
    assert tdevice.device_memory_stats("cpu") == {
        "bytes_in_use": 0.0, "peak_bytes_in_use": 0.0, "bytes_limit": 0.0}
    mon = monitor.SystemMonitor(max_records=2)
    for step in range(3):
        rec = mon.sample(step, counters={"update_skipped": 0.0})
        assert rec["step"] == step and rec["process_rss_gb"] > 0
        assert "device_mem_gb" not in rec  # no card: left out
    assert [r["step"] for r in mon.tail()] == [1, 2]
    assert mon.summary()["max_process_rss_gb"] > 0
    info = env_info.log_system_info(get_logger())
    assert info["Python Version"] and info["PyTorch Version"]
    assert info["Device Type"].startswith("CPU")
    cfg = tconfig.ScaleTorchTPUArguments(
        model_type="qwen3", **ARCH, synthetic_data=True, verbose=True,
        sequence_length=16)
    assert Trainer(cfg, device="cpu").global_step == 0
