"""PyTorch port, the training entry point over a mesh on the CPU:
``torch.distributed.run --nproc-per-node 2 -m scaletorch_tpu_torch.train
--device cpu --tensor_parallel_size 2 --sequence_parallel true`` (gloo)
against the JAX package's ``Trainer`` at ``dp4 x tp2`` with SP on the 8
virtual devices.

Both load one HF checkpoint written by the JAX package and train on the
synthetic stream of one seed; the global batch is 4 rows on both sides
(the port's micro-batch 4 at dp 1, the reference's 1 row on each of dp
4). The rank-0 metrics JSON of the port gives each step's loss and
learning rate, the reference's metrics history its own. The run's
rendezvous is ``torchrun --standalone`` (a free local port) and every
wait is bounded: the launcher is killed with its ranks after
``TIMEOUT_S``. The ``Trainer``'s wiring (init order, logs on rank 0
only, the cp backend's errors) is checked in the same process.

Tolerance, fp32: losses within 1e-5 (``LOSS_TOL`` of
``tests/test_torch_runtime_trainer.py``), learning rates rtol 1e-6.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import transformers

from scaletorch_tpu import config as jconfig
from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.models import qwen3 as jqwen3
from scaletorch_tpu.utils import hf_interop as jhf
from scaletorch_tpu_torch import config as tconfig

ROOT = Path(__file__).resolve().parents[1]
ARCH = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, max_position_embeddings=128,
            tie_word_embeddings=True, rope_theta=10000.0)
STEPS, LOSS_TOL, TIMEOUT_S = 3, 1e-5, 240
COMMON = dict(model_type="qwen3", load_pretrained_weights=True,
              synthetic_data=True, sequence_length=16, dtype="float32",
              total_train_steps=STEPS, warmup_steps=1, log_frequency=1,
              tensor_parallel_size=2, sequence_parallel=True)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("hf")
    jcfg = jqwen3.Qwen3Config(**ARCH, dtype=jnp.float32)
    jhf.save_hf_params(str(path), jllama.init_params(jax.random.PRNGKey(5),
                                                     jcfg), jcfg)
    transformers.Qwen3Config(**ARCH).save_pretrained(str(path))
    return str(path)


def run_cli(args, timeout=TIMEOUT_S):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(name, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "scaletorch_tpu_torch.train",
         *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"torchrun took over {timeout} s\n{out[-4000:]}")
    return proc.returncode, out


def test_torchrun_trains_like_the_reference_trainer(checkpoint, tmp_path):
    from scaletorch_tpu.trainer.trainer import Trainer as JTrainer

    logs = tmp_path / "logs"
    args = ["--device", "cpu", "--model_name_or_path", checkpoint,
            "--micro_batch_size", "4", "--performance_log_dir", str(logs)]
    for key, value in COMMON.items():
        args += [f"--{key}", str(value)]
    for key, value in ARCH.items():
        args += [f"--{key}", str(value)]
    rc, out = run_cli(args)
    assert rc == 0, out[-4000:]
    # logs come from rank 0 only; the JSON too (rank 0 also logs the
    # coordinated run's straggler line, "step 1 | host step-time ...")
    assert out.count("step      1 | loss") == 1, out[-4000:]
    assert out.count("step      1 | host step-time") == 1, out[-4000:]
    assert os.listdir(logs) == [f"performance_log_step{STEPS}.json"]
    with open(logs / f"performance_log_step{STEPS}.json") as f:
        ours = json.load(f)["records"]
    theirs = JTrainer(jconfig.ScaleTorchTPUArguments(
        **COMMON, model_name_or_path=checkpoint, micro_batch_size=1,
        data_parallel_size=len(jax.devices()) // 2))
    theirs.train()
    ref = theirs.metrics.history
    assert [r["step"] for r in ours] == [r["step"] for r in ref] == [1, 2, 3]
    for a, b in zip(ours, ref):
        assert abs(a["loss"] - b["loss"]) <= LOSS_TOL
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
        assert a["update_skipped"] == 0.0


def test_mesh_configs_are_validated_as_the_reference_validates_them():
    bad = [dict(sequence_parallel=True),
           dict(context_parallel_size=2, sequence_length=7),
           dict(context_parallel_size=4, cp_layout="zigzag",
                attention_backend="ring", sequence_length=12),
           dict(tensor_parallel_size=4, sequence_parallel=True,
                sequence_length=6),
           dict(global_batch_size=3, data_parallel_size=2),
           dict(num_microbatches=2), dict(cp_layout="stripes"),
           dict(data_parallel_size=0)]
    for kw in bad:
        with pytest.raises(ValueError):
            jconfig.ScaleTorchTPUArguments(**kw)
        with pytest.raises(ValueError):
            tconfig.ScaleTorchTPUArguments(**kw)
    ok = dict(data_parallel_size=2, tensor_parallel_size=2,
              context_parallel_size=2, sequence_length=64,
              micro_batch_size=2, gradient_accumulation_steps=2)
    a, b = jconfig.ScaleTorchTPUArguments(**ok), tconfig.ScaleTorchTPUArguments(
        **ok)
    assert a.mesh_kwargs() == b.mesh_kwargs()
    assert (a.world_size, a.global_batch_size, a.num_microbatches) == (
        b.world_size, b.global_batch_size, b.num_microbatches)
    with pytest.raises(ValueError, match="device count"):
        b.validate_world_size(4)
    b.validate_world_size(8)
    # the paths of ROADMAP Queue 1 item 6b (pipeline and expert
    # parallelism, the int8 wire, MoE over processes) are accepted as the
    # reference accepts them
    for kw in (dict(pipeline_parallel_size=2, pp_engine="interleaved",
                    pp_virtual_stages=2, gradient_accumulation_steps=4),
               dict(expert_parallel_size=2, micro_batch_size=2),
               dict(grad_allreduce_dtype="int8", data_parallel_size=2),
               dict(model_type="qwen3_moe", data_parallel_size=2)):
        a = jconfig.ScaleTorchTPUArguments(**kw)
        b = tconfig.ScaleTorchTPUArguments(**kw)
        assert a.mesh_kwargs() == b.mesh_kwargs()
        assert (a.world_size, a.global_batch_size, a.num_microbatches,
                a.pp_engine) == (b.world_size, b.global_batch_size,
                                 b.num_microbatches, b.pp_engine)
    with pytest.warns(RuntimeWarning, match="memory_chunked"):
        b = tconfig.ScaleTorchTPUArguments(pipeline_parallel_size=2,
                                           pp_engine="1f1b")
    assert b.pp_engine == "memory_chunked"


def test_trainer_guards_over_two_gloo_processes(tmp_path):
    from tests.torch_dist_harness import run_ranks

    base = dict(model_type="qwen3", **ARCH, synthetic_data=True,
                sequence_length=16, dtype="float32", checkpoint_dir=str(
                    tmp_path / "ckpt"))
    refused = {
        # a full-sequence backend on cp shards
        "cp_sdpa": dict(context_parallel_size=2, attention_backend="sdpa"),
        # the zigzag stripes, checked once 'auto' settled on the ring
        "zigzag_seq": dict(context_parallel_size=2, sequence_length=18),
        # the mesh must be the world
        "mesh_not_world": dict(tensor_parallel_size=4),
    }
    # Adafactor over tp shards builds and steps (its statistics reduce
    # over the split dims)
    built = {"adafactor_tp": dict(tensor_parallel_size=2,
                                  optimizer_name="adafactor")}
    res = run_ranks(tmp_path, 2, "trainer_guards",
                    {"base": base, "refused": refused, "built": built})
    for rank, out in enumerate(res):
        assert "CP-aware" in out["cp_sdpa"]
        assert "divisible by 2*cp" in out["zigzag_seq"]
        assert "device count 2" in out["mesh_not_world"]
        assert 0.0 < out["adafactor_tp"] < 100.0  # a finite loss
        # a save at dp2, and a resume whose next loss is the straight run's
        assert out["save"] is True
        step, resumed, straight = out["resume"]
        assert step == 1 and resumed == straight
        # auto at cp 2 on one host, Hq 4 / Hkv 2: the zigzag ring
        assert out["auto"] == "ring" and out["zigzag"] and out["world"] == 2
        assert (out["rank_logs"] == 40) == (rank != 0)  # ERROR off rank 0
    assert res[0]["loss"] == res[1]["loss"]
    assert res[0]["adafactor_tp"] == res[1]["adafactor_tp"]
    assert res[0]["resume"] == res[1]["resume"]
