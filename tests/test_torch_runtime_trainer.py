"""PyTorch port, the training runtime's drills through ``Trainer`` on the
CPU, against the JAX package's ``Trainer`` (fp32, one reference-written
HF checkpoint, one ``.jsonl``; the port's micro-batch 8 is the
reference's 8 virtual devices at 1 row each, as in
``test_torch_train_runtime.py``).

* ``ft_nan_at_step`` under ``divergence_policy="rollback"``: the same
  logged steps, losses within ``LOSS_TOL``, the same counters, the same
  final loader position and skew; every parameter and state tensor keeps
  its storage through the in-place restore.
* ``ft_sigterm_at_step``: both return early with ``preempted`` and
  ``emergency_checkpoint_saved`` set at the same step, the checkpoint is
  the latest on disk, and the resumed runs' losses agree.
* The port alone: a corrupt batch is skipped and counted under the
  skip budget, failed saves are retried, an ``abort`` writes a crash
  report and the CLI exits 42, a SIGTERM drill through the CLI exits 0
  and says the checkpoint is on disk, an injected hang fires the
  trainer's watchdog (a recording exit, 43), a telemetry run leaves a
  trace with one phase of each kind a step, one JSONL record a step, a
  profiler window and a SIGUSR1 snapshot.
"""

import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import transformers

from scaletorch_tpu import config as jconfig
from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.models import qwen3 as jqwen3
from scaletorch_tpu.utils import hf_interop as jhf
from scaletorch_tpu_torch import config as tconfig
from scaletorch_tpu_torch import resilience_distributed as tdist
from scaletorch_tpu_torch import train as ttrain
from scaletorch_tpu_torch.telemetry import load_trace, read_jsonl
from scaletorch_tpu_torch.trainer.optimizer import tree_leaves
from scaletorch_tpu_torch.trainer.trainer import Trainer
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
    return write_jsonl(tmp_path_factory.mktemp("corpus") / "train.jsonl",
                       80, 0)


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("hf")
    jcfg = jqwen3.Qwen3Config(**ARCH, dtype=jnp.float32)
    jhf.save_hf_params(str(path), jllama.init_params(jax.random.PRNGKey(7),
                                                     jcfg), jcfg)
    transformers.Qwen3Config(**ARCH).save_pretrained(str(path))
    return str(path)


def both_trainers(corpus, checkpoint, tmp_path, monkeypatch, **kw):
    from scaletorch_tpu.trainer.trainer import Trainer as JTrainer

    base = dict(model_type="qwen3", model_name_or_path=checkpoint,
                load_pretrained_weights=True, dataset_name=corpus,
                sequence_length=16, dtype="float32", total_train_steps=6,
                warmup_steps=1, log_frequency=1, save_frequency=2,
                async_checkpointing=False, checkpoint_retry_base_delay=0.01,
                **kw)
    ours = Trainer(tconfig.ScaleTorchTPUArguments(
        **base, micro_batch_size=8, checkpoint_dir=str(tmp_path / "ours"),
        crash_report_dir=str(tmp_path / "ours_crash")),
        device="cpu", tokenizer=ByteTokenizer())
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda *a, **k: ByteTokenizer())
    dp = len(jax.devices())
    theirs = JTrainer(jconfig.ScaleTorchTPUArguments(
        **base, micro_batch_size=8 // dp, data_parallel_size=dp,
        checkpoint_dir=str(tmp_path / "theirs"),
        crash_report_dir=str(tmp_path / "theirs_crash")))
    return ours, theirs


def assert_histories_agree(ours, theirs):
    a, b = ours.history, theirs.metrics.history
    assert [r["step"] for r in a] == [r["step"] for r in b]
    for ra, rb in zip(a, b):
        assert ra["lr"] == pytest.approx(rb["lr"], rel=1e-6)
        assert abs(ra["loss"] - rb["loss"]) <= LOSS_TOL


def storages(trainer):
    return [t.data_ptr() for t in
            tree_leaves(trainer.params) + tree_leaves(trainer.opt_state)]


def test_rollback_matches_the_reference_trainer(corpus, reference_checkpoint,
                                                tmp_path, monkeypatch):
    ours, theirs = both_trainers(corpus, reference_checkpoint, tmp_path,
                                 monkeypatch, ft_nan_at_step=5,
                                 divergence_policy="rollback")
    before = storages(ours)
    ours.train()
    theirs.train()
    assert ours.global_step == theirs.global_step == 6
    assert_histories_agree(ours, theirs)
    assert [r["step"] for r in ours.history] == [1, 2, 3, 4, 5, 6]
    assert ours.resilience.counters() == theirs.resilience.counters()
    assert ours.resilience.counters()["rollbacks"] == 1.0
    assert ours.resilience.counters()["nonfinite_losses"] == 1.0
    assert ours.loader.position == theirs.loader.position == 7
    assert ours._loader_skew == theirs._loader_skew == 1
    assert storages(ours) == before
    assert all(np.isfinite(r["loss"]) for r in ours.history)
    ours.close()
    theirs.close()


def test_sigterm_matches_the_reference_trainer(corpus, reference_checkpoint,
                                               tmp_path, monkeypatch):
    ours, theirs = both_trainers(corpus, reference_checkpoint, tmp_path,
                                 monkeypatch, ft_sigterm_at_step=3)
    prev = signal.getsignal(signal.SIGTERM)
    ours.train()
    theirs.train()
    assert signal.getsignal(signal.SIGTERM) is prev
    for t in (ours, theirs):
        assert t.preempted and t.emergency_checkpoint_saved
        assert t.global_step == 3
        assert t.checkpoint_manager.latest_step() == 3
    assert set(ours.emergency_timing) == {"drain_s", "blocking_s", "write_s",
                                          "total_s"}
    assert_histories_agree(ours, theirs)
    ours.close()
    theirs.close()
    # the restarted jobs continue to the same absolute target
    cfg = dataclasses.replace(ours.cfg, ft_sigterm_at_step=0, resume="must")
    resumed = Trainer(cfg, device="cpu", tokenizer=ByteTokenizer())
    assert resumed.global_step == 3
    resumed.train()
    jresumed = type(theirs)(dataclasses.replace(theirs.cfg,
                                                ft_sigterm_at_step=0))
    assert jresumed.load_checkpoint(required=True)
    jresumed.train()
    assert resumed.global_step == jresumed.global_step == 6
    assert_histories_agree(resumed, jresumed)
    resumed.close()
    jresumed.close()


def port_cfg(corpus, tmp_path, **kw):
    base = dict(model_type="qwen3", **ARCH, dataset_name=corpus,
                sequence_length=16, micro_batch_size=2, dtype="float32",
                total_train_steps=4, log_frequency=1,
                async_checkpointing=False, checkpoint_retry_base_delay=0.01,
                data_retry_base_delay=0.001,
                crash_report_dir=str(tmp_path / "crash"))
    return tconfig.ScaleTorchTPUArguments(**{**base, **kw})


def test_bad_batch_and_failed_saves_are_survived(corpus, tmp_path):
    t = Trainer(port_cfg(corpus, tmp_path, ft_bad_batch_at_step=2,
                         ft_fail_saves=1, checkpoint_dir=str(tmp_path / "c"),
                         save_frequency=2, checkpoint_retries=2),
                device="cpu", tokenizer=ByteTokenizer())
    t.train()
    assert t.global_step == 4 and t.loader.skipped_positions == [2]
    # the stream is one region ahead of the step, and the step-4
    # checkpoint keeps it so
    assert t.loader.position == 5 and t._saved_loader_position == 5
    assert t.checkpoint_manager.all_steps() == [2, 4]
    assert t.resilience.injector.fail_saves == 0  # consumed, then retried
    t.close()


def test_abort_writes_a_crash_report_and_exits_42(corpus, tmp_path):
    args = ["--device", "cpu", "--dataset_name", corpus,
            "--tokenizer_name_or_path", "unused", "--model_type", "qwen3",
            "--sequence_length", "16", "--dtype", "float32",
            "--total_train_steps", "3", "--ft_nan_at_step", "2",
            "--divergence_policy", "abort",
            "--crash_report_dir", str(tmp_path / "crash")]
    for key, value in ARCH.items():
        args += [f"--{key}", str(value)]
    import scaletorch_tpu_torch.trainer.trainer as trainer_mod

    real = trainer_mod.Trainer

    class WithTokenizer(real):
        def __init__(self, cfg, device=None):
            super().__init__(cfg, device=device, tokenizer=ByteTokenizer())

    trainer_mod.Trainer = WithTokenizer
    try:
        assert ttrain.main(args) == tdist.DIVERGED_EXIT_CODE
        sig = ["--checkpoint_dir", str(tmp_path / "ck"),
               "--ft_sigterm_at_step", "2", "--ft_nan_at_step", "0"]
        assert ttrain.main(args + sig) == 0
    finally:
        trainer_mod.Trainer = real
    with open(tmp_path / "crash" / "crash_report_step2.json") as f:
        report = json.load(f)
    assert "divergence_policy='abort'" in report["reason"]
    assert report["counters"]["nonfinite_losses"] == 1.0
    assert report["config_fingerprint"]["divergence_policy"] == "abort"
    assert os.listdir(tmp_path / "ck") == ["2"]


def test_injected_hang_fires_the_trainers_watchdog(corpus, tmp_path,
                                                   monkeypatch):
    exits = []
    t = Trainer(port_cfg(corpus, tmp_path, ft_hang_at_step=2,
                         ft_hang_seconds=2.0, total_train_steps=3),
                device="cpu", tokenizer=ByteTokenizer())
    t._watchdog_exit = exits.append
    # warm before the watchdog is armed, and a timeout of 1 s: a loaded
    # machine has stretched a step of this model past 0.5 s
    t.train(num_steps=1)
    monkeypatch.setenv("SCALETORCH_TPU_FT_HANG_TIMEOUT", "1.0")
    t.train()
    assert exits == [tdist.WATCHDOG_EXIT_CODE] and t.global_step == 3
    assert os.listdir(tmp_path / "crash") == ["crash_report_step2.json"]
    with open(tmp_path / "crash" / "crash_report_step2.json") as f:
        report = json.load(f)
    assert "hang watchdog" in report["reason"]
    assert "maybe_hang" in report["thread_stacks"]["MainThread"]
    assert report["monitor_records"] and report["config_fingerprint"]


def test_telemetry_run_leaves_its_artifacts(corpus, tmp_path):
    tel = tmp_path / "tel"
    t = Trainer(port_cfg(corpus, tmp_path, telemetry_dir=str(tel),
                         profile_steps="2:3", total_train_steps=4),
                device="cpu", tokenizer=ByteTokenizer())
    t.train()
    signal.raise_signal(signal.SIGUSR1)  # the handler is armed until close
    t.close()
    events = load_trace(str(tel / "trace_proc0.trace.json"))
    for phase in ("step_boundary", "data_fetch", "step_dispatch"):
        assert [e["args"]["step"] for e in events
                if e["name"] == phase] == [0, 1, 2, 3]
    recs = read_jsonl(str(tel / "events_proc0.jsonl"))
    assert [r["step"] for r in recs if r["kind"] == "train_step"] == [
        1, 2, 3, 4]
    cap, = t.telemetry.profiler.captures
    assert (cap["start_step"], cap["stop_step"]) == (2, 3)
    assert os.path.exists(os.path.join(cap["dir"], "trace.json"))
    with open(tel / "live_snapshot_1.json") as f:
        snap = json.load(f)
    assert snap["step"] == 4 and snap["span_tail"]
    assert [r["step"] for r in snap["monitor_records"]] == [1, 2, 3, 4]
