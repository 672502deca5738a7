"""PyTorch port, the training loop and its pieces: ``Trainer(device="cpu")``
takes steps; the synthetic loader's batches are byte-equal to the JAX
package's; the config dataclasses keep the reference's field names and
defaults, and ``parse_args`` is plain argparse (no ``transformers``);
``make_bench_args``, MFU accounting, the peak-flops lookup and the
parameter carry-over agree with the JAX package; the entry points refuse
to run without a card unless the CPU is asked for by name.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from scaletorch_tpu import benchmark as jbench
from scaletorch_tpu import config as jconfig
from scaletorch_tpu.data.dataloader import SyntheticDataLoader as JLoader
from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.utils import misc as jmisc
from scaletorch_tpu_torch import benchmark as tbench
from scaletorch_tpu_torch import config as tconfig
from scaletorch_tpu_torch import train as ttrain
from scaletorch_tpu_torch.data.dataloader import (
    SyntheticDataLoader,
    device_batch,
)
from scaletorch_tpu_torch.models import params_from_numpy, params_to_numpy
from scaletorch_tpu_torch.trainer.trainer import Trainer
from scaletorch_tpu_torch.utils import device as tdevice
from scaletorch_tpu_torch.utils import misc as tmisc

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(model_type="qwen3", hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, vocab_size=128, max_position_embeddings=128,
            tie_word_embeddings=True, sequence_length=32,
            micro_batch_size=2, total_train_steps=3, warmup_steps=1,
            dtype="float32", synthetic_data=True)


def tiny_cfg(**kw):
    return tconfig.ScaleTorchTPUArguments(**{**TINY, **kw})


def test_trainer_takes_three_steps_on_the_cpu():
    trainer = Trainer(tiny_cfg(), device="cpu")
    assert trainer.device.type == "cpu" and trainer.attention_backend == "flash"
    last = trainer.train()
    assert trainer.global_step == 3
    assert trainer.tokens_seen == 3 * 2 * 32
    assert len(trainer.history) == 3 and last is trainer.history[-1]
    for i, rec in enumerate(trainer.history):
        assert rec["step"] == i + 1 and np.isfinite(rec["loss"])
        assert rec["update_skipped"] == 0.0 and rec["tokens_per_second"] > 0
        assert rec["lr"] == pytest.approx(trainer.schedule(i))
        assert "mfu" not in rec  # no card, no peak
    # ~ln(vocab) at initialisation
    assert trainer.history[0]["loss"] == pytest.approx(np.log(128), rel=0.1)
    assert int(trainer.opt_state["count"]) == 3
    m = trainer.step()  # one more, past total_train_steps
    assert trainer.global_step == 4 and np.isfinite(float(m["loss"]))


def test_trainer_accumulates_microbatches():
    trainer = Trainer(tiny_cfg(gradient_accumulation_steps=2), device="cpu")
    m = trainer.step()
    assert trainer.tokens_seen == 2 * 2 * 32 and np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("accum,mbs", [(1, 1), (2, 3)])
def test_synthetic_batches_are_byte_equal(accum, mbs):
    kw = dict(vocab_size=1000, sequence_length=16, micro_batch_size=mbs,
              gradient_accumulation_steps=accum, seed=42)
    ours, theirs = iter(SyntheticDataLoader(**kw)), iter(JLoader(**kw))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes()
    assert SyntheticDataLoader(**kw).tokens_per_step == \
        JLoader(**kw).tokens_per_step


def test_device_batch_is_one_upload():
    batch = next(iter(SyntheticDataLoader(50, 8, 2, 2, seed=0)))
    out = device_batch(batch, "cpu")
    ptrs = {t.untyped_storage().data_ptr() for t in out.values()}
    assert len(ptrs) == 1  # views into one packed buffer
    for key, value in batch.items():
        assert out[key].dtype == torch.int32
        np.testing.assert_array_equal(out[key].numpy(), value)


PORT_CLASSES = ("DataArguments", "ModelArguments", "LrSchedulerArguments",
                "OptimizerArguments", "TrainingArguments",
                "CheckpointArguments", "LoggingArguments")


@pytest.mark.parametrize("name", PORT_CLASSES)
def test_config_fields_keep_the_reference_names_and_defaults(name):
    ours = {f.name: f for f in dataclasses.fields(getattr(tconfig, name))}
    theirs = {f.name: f for f in dataclasses.fields(getattr(jconfig, name))}
    assert set(ours) <= set(theirs), set(ours) - set(theirs)
    for key, f in ours.items():
        assert f.default == theirs[key].default, key
    if name in ("LrSchedulerArguments", "OptimizerArguments",
                "TrainingArguments", "CheckpointArguments"):
        assert list(ours) == list(theirs)  # ported whole, in order


def test_composed_config_defaults_match():
    ours = tconfig.ScaleTorchTPUArguments()
    theirs = jconfig.ScaleTorchTPUArguments()
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


def test_parse_args_runs_without_transformers():
    code = (
        "import sys\n"
        "sys.modules['transformers'] = None  # any import of it fails\n"
        "from scaletorch_tpu_torch.config import parse_args\n"
        "cfg = parse_args(['--hidden_size', '32', '--gradient_checkpointing',"
        " '--tie_word_embeddings', 'false', '--learning_rate', '1e-3',"
        " '--head_dim', '16'])\n"
        "assert cfg.hidden_size == 32 and cfg.gradient_checkpointing is True\n"
        "assert cfg.tie_word_embeddings is False and cfg.head_dim == 16\n"
        "assert cfg.learning_rate == 1e-3 and cfg.global_batch_size == 1\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_config_validation():
    with pytest.raises(ValueError, match="global_batch_size"):
        tiny_cfg(global_batch_size=3)
    with pytest.raises(ValueError, match="dtype"):
        tiny_cfg(dtype="float16")
    with pytest.raises(ValueError, match="param_dtype"):
        tiny_cfg(param_dtype="float16")
    # eval and a run without synthetic_data are ported: with no
    # dataset_name the loader is the synthetic stream, as the reference's
    trainer = Trainer(tiny_cfg(eval_frequency=1, synthetic_data=False),
                      device="cpu")
    assert isinstance(trainer.loader, SyntheticDataLoader)
    assert np.isfinite(trainer.evaluate())
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tiny_cfg(resume="must")
    with pytest.raises(ValueError, match="resume"):
        tiny_cfg(resume="sometimes")
    with pytest.raises(NotImplementedError, match="in place"):
        Trainer(tiny_cfg(donate_params=False), device="cpu")


def test_make_bench_args_matches_the_reference():
    ours = tbench.make_bench_args("qwen3-0.6b", seq=8192, gc=True)
    theirs = jbench.make_bench_args("qwen3-0.6b", seq=8192, gc=True)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.num_hidden_layers == 28 and ours.vocab_size == 151936


def test_benchmark_config_on_the_cpu():
    calls = []
    res = tbench.benchmark_config(tiny_cfg(), warmup=1, steps=2,
                                  device="cpu",
                                  before_window=lambda: calls.append(1))
    assert calls == [1]
    assert res["tokens_per_second"] > 0 and np.isfinite(res["loss"])
    assert res["mfu"] is None and res["memory_gb"] is None
    assert res["device"] == "cpu" and res["num_chips"] == 1
    assert len(res["warmup_losses"]) == 1 and len(res["losses"]) == 2
    assert res["loss"] == res["losses"][-1]
    assert res["update_skipped"] == [0.0, 0.0]
    assert all(np.isfinite(res["grad_norms"]))
    assert res["trainer"].global_step == 3


def test_train_entry_point_on_the_cpu():
    args = ["--device", "cpu"]
    for key, value in {**TINY, "total_train_steps": 2}.items():
        args += [f"--{key}", str(value)]
    assert ttrain.main(args) == 0


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the error path is for hosts without")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(tiny_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbench.benchmark_config(tiny_cfg(), warmup=0, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_batch(next(iter(SyntheticDataLoader(10, 4, 1, 1))))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(2, np.float32)})


@pytest.mark.parametrize("seq", [1024, 8192])
def test_mfu_accounting_matches_the_reference(seq):
    args = (7005.8, 596_049_920, 28, 16, 128, seq)
    assert tmisc.get_flops_per_token(*args[1:]) == \
        jmisc.get_flops_per_token(*args[1:])
    assert tmisc.get_mfu(*args, peak_flops=989.5e12) == pytest.approx(
        jmisc.get_mfu(*args, peak_flops=989.5e12), rel=1e-12)


def test_peak_flops_lookup():
    assert tdevice.get_theoretical_flops("NVIDIA H100 80GB HBM3") == 989.5e12
    assert tdevice.get_theoretical_flops("NVIDIA H100 SXM5") == 989.5e12
    with pytest.raises(KeyError, match="no peak"):
        tdevice.get_theoretical_flops("NVIDIA A10")


def test_num_params_and_carry_over_round_trip():
    jcfg = jllama.LlamaConfig(vocab_size=64, hidden_size=32,
                              intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=4, num_key_value_heads=2,
                              head_dim=8, qk_norm=True)
    tree = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(1),
                                                       jcfg))
    params = params_from_numpy(tree, "cpu")
    assert tmisc.get_num_params(params) == jmisc.get_num_params(tree)
    for leaf in jax.tree.leaves(params):
        assert leaf.dtype == torch.float32 and leaf.requires_grad
        assert leaf.is_leaf
    back = params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        params["norm"].add_(1.0)  # the numpy copy is a snapshot
    assert not np.array_equal(params["norm"].detach().numpy(), back["norm"])


@pytest.mark.parametrize("optimizer", ["adamw", "adam", "sgd", "lamb",
                                       "adafactor"])
def test_trainer_keeps_bf16_masters_and_state(optimizer):
    """``param_dtype="bfloat16"``: the parameters and every float state
    leaf are bf16 (the reference's optax states take the parameters'
    dtype), and the trainer takes finite steps with each optimizer."""
    trainer = Trainer(tiny_cfg(param_dtype="bfloat16",
                               optimizer_name=optimizer,
                               gradient_checkpointing=True,
                               remat_policy="save_attn"), device="cpu")
    assert trainer.model_cfg.param_dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 and p.requires_grad
               for p in jax.tree.leaves(trainer.params))
    state = {k: v for k, v in trainer.opt_state.items() if k != "count"}
    assert state and all(t.dtype == torch.bfloat16
                         for t in jax.tree.leaves(state))
    record = trainer.train(num_steps=2)
    assert np.isfinite(record["loss"]) and record["update_skipped"] == 0.0
    assert int(trainer.opt_state["count"]) == 2


def test_single_chip_rows_are_the_reference_table():
    """The port's copy of ``bench.py``'s ``SINGLE_CHIP_ROWS`` (model and
    run shape; the published NPU numbers are left out), and each row's
    config equal to the reference's ``make_bench_args`` of that row."""
    import bench

    theirs = {label: (model, shape)
              for label, (model, shape, *_) in bench.SINGLE_CHIP_ROWS.items()}
    assert tbench.SINGLE_CHIP_ROWS == theirs
    assert tbench.HEADLINE == bench.HEADLINE
    for label, (model, shape) in theirs.items():
        ours = tbench.bench_row_args(label)
        ref = jbench.make_bench_args(model, **shape)
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(ref, f.name), (label,
                                                                   f.name)
    four_b = tbench.bench_row_args("qwen3-4b_seq2048_bs1_gc")
    assert (four_b.optimizer_name, four_b.param_dtype) == ("adafactor",
                                                          "bfloat16")
