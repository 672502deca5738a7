"""PyTorch port, the examples over the mesh (``scaletorch_tpu_torch/
examples``), in gloo processes on the CPU, against the port's own
one-device runs and the JAX package's examples.

  * minGPT's and MNIST's data-parallel arms (and MNIST's ``--fsdp``), and
    the FSDP example: the losses of 2 ranks equal one device's within
    1e-5 (each rank's loss is its rows' share of the global mean, the
    gradients summed; fsdp slices all-gathered, their gradients
    reduce-scattered), each FSDP rank holding half the parameter bytes.
    The minGPT and MNIST arms are cases of
    ``tests/test_torch_examples.py::test_the_mesh_arms_run``;
  * the FSDP example's first 3 losses equal the JAX example's
    ``setup_fsdp`` step (8 virtual devices) from the same initial
    parameters and numpy batches within 1e-5; a run saved on one device
    and resumed on 2 ranks gives the losses of the same resume on one
    device (the coordinated checkpoint reads the global tensors into
    the new slices);
  * the moe, pipeline and long-context examples build the reference
    example's ``ScaleTorchTPUArguments`` (captured by running the
    reference ``main`` with its ``Trainer`` replaced by a recorder that
    stops it, so no JAX step compiles), the world-derived data-parallel
    size and ``donate_params`` (the port always updates in place) aside;
    the pipeline example prints the reference's tick accounting; over 2
    gloo ranks (ep2; pp2 under each engine; cp2 ring and Ulysses) each
    ends with a finite loss below its first. The layouts' numerics are
    held to the reference by the mesh tests of the trainer;
  * the device-mesh demos: every demo's assertion holds at world 4, and
    fewer ranks are refused.
"""

import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scaletorch_tpu_torch.examples.device_mesh import mesh_demos
from scaletorch_tpu_torch.examples.fsdp import train_fsdp
from scaletorch_tpu_torch.parallel.mesh import using_mesh_manager
from tests.torch_dist_harness import run_ranks

LOSS_TOL = 1e-5

FSDP = ["--device", "cpu", "--log_interval", "100"]
# the examples' own sizes and learning rates on the synthetic stream
# (uniform tokens: the loss falls slowly and noisily toward ln 256); the
# moe example at 16 steps, the others at their 8, longctx at seq 1024
TRAINER_RUNS = {
    "moe_ep2": ("moe.train_moe", ["--ep", "2", "--steps", "16"]),
    "pp2_afab": ("pipeline.train_pp", ["--engine", "afab"]),
    "pp2_interleaved": ("pipeline.train_pp", ["--engine", "interleaved"]),
    "pp2_memory_chunked": ("pipeline.train_pp",
                           ["--engine", "memory_chunked"]),
    "cp2_ring": ("longctx.train_longctx", ["--cp", "2", "--seq", "1024"]),
    "cp2_ulysses": ("longctx.train_longctx",
                    ["--cp", "2", "--strategy", "ulysses", "--seq", "1024"]),
}


@pytest.fixture(scope="module")
def trainer_ranks(tmp_path_factory):
    runs = [{"module": mod, "argv": ["--device", "cpu"] + argv,
             "keep": ["losses", "world"]}
            for mod, argv in TRAINER_RUNS.values()]
    res = run_ranks(tmp_path_factory.mktemp("trainer_examples"), 2,
                    "example_run", {"runs": runs}, timeout=240.0)
    return {name: [r[i] for r in res] for i, name in enumerate(TRAINER_RUNS)}


@pytest.mark.parametrize("name", sorted(TRAINER_RUNS))
def test_trainer_examples_learn_over_two_ranks(trainer_ranks, name):
    argv = TRAINER_RUNS[name][1]
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv else 8
    for out in trainer_ranks[name]:
        losses = out["losses"]
        assert out["world"] == 2 and len(losses) == steps
        assert all(math.isfinite(v) for v in losses)
        assert losses[-1] < losses[0], losses
        assert losses == trainer_ranks[name][0]["losses"]


# ---- the configs against the reference examples' ----------------------------
class _Stop(Exception):
    pass


def reference_config(module: str, argv, monkeypatch, capsys):
    """The ``ScaleTorchTPUArguments`` the reference example's ``main``
    hands its ``Trainer``, and what it printed before."""
    from scaletorch_tpu.trainer import trainer as jtrainer

    seen = {}

    def record(cfg, *a, **k):
        seen["cfg"] = cfg
        raise _Stop

    monkeypatch.setattr(jtrainer, "Trainer", record)
    ref = importlib.import_module(f"examples.{module}")
    with pytest.raises(_Stop):
        ref.main(argv)
    return seen["cfg"], capsys.readouterr().out


CONFIG_CASES = {
    "moe": ("moe.train_moe", []),
    "moe_interleaved": ("moe.train_moe", ["--ep", "4", "--sparse-step", "2",
                                          "--dispatch", "index",
                                          "--dense-layers", "0"]),
    "pp_afab": ("pipeline.train_pp", ["--engine", "afab"]),
    "pp_interleaved": ("pipeline.train_pp", ["--engine", "interleaved",
                                             "--vpp", "2"]),
    "pp_1f1b": ("pipeline.train_pp", ["--engine", "1f1b", "--pp", "4"]),
    "longctx_ring": ("longctx.train_longctx", []),
    "longctx_ulysses": ("longctx.train_longctx",
                        ["--cp", "2", "--strategy", "ulysses", "--layout",
                         "contiguous"]),
}
# the world-derived size, and the port's in-place updates
EXEMPT = {"data_parallel_size", "donate_params"}


@pytest.mark.parametrize("name", sorted(CONFIG_CASES))
def test_configs_equal_the_reference_examples(name, monkeypatch, capsys):
    module, argv = CONFIG_CASES[name]
    want, printed = reference_config(module, argv, monkeypatch, capsys)
    port = importlib.import_module(f"scaletorch_tpu_torch.examples.{module}")
    got = port.build_args(port.parse_args(argv), world=len(jax.devices()))
    theirs = {f.name: getattr(want, f.name) for f in dataclasses.fields(want)}
    ours = {f.name: getattr(got, f.name) for f in dataclasses.fields(got)}
    diff = {k: (ours[k], theirs[k]) for k in set(ours) & set(theirs) - EXEMPT
            if ours[k] != theirs[k]}
    assert not diff
    if module == "pipeline.train_pp":
        args = port.parse_args(argv)
        line = port.schedule_line(args.engine, args.pp, got.pp_virtual_stages,
                                  args.accum)
        assert line == printed.strip().splitlines()[0]


# ---- FSDP against the JAX example's step, save and resume ----------
def jax_fsdp_losses(params_host, steps):
    """The JAX example's setup_fsdp step (8 virtual devices) on its
    batches: the first ``steps`` losses."""
    from scaletorch_tpu.config import ScaleTorchTPUArguments
    from scaletorch_tpu.models.llama import LlamaConfig, forward
    from scaletorch_tpu.parallel.fsdp import setup_fsdp
    from scaletorch_tpu.trainer.optimizer import create_optimizer

    cfg = LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=4, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=32,
                      max_position_embeddings=64, dtype=jnp.float32,
                      param_dtype=jnp.float32)
    targs = ScaleTorchTPUArguments(total_train_steps=10, learning_rate=3e-3,
                                   warmup_steps=2, max_grad_norm=1.0)
    tx, _ = create_optimizer(targs, include_clip=True)
    step_fn, params, opt_state, _ = setup_fsdp(forward, cfg, params_host, tx)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(steps):
        b = train_fsdp.step_batch(rng, 512, 8, 64)
        batch = {k: jnp.asarray(b[k]) for k in ("input_ids", "target_ids")}
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
    return losses


def test_fsdp_example_matches_the_jax_example_step():
    from scaletorch_tpu.models.llama import LlamaConfig, init_params

    jcfg = LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                       num_hidden_layers=4, num_attention_heads=4,
                       num_key_value_heads=2, head_dim=32,
                       max_position_embeddings=64)
    host = jax.tree.map(np.asarray, init_params(jax.random.key(0), jcfg))
    want = jax_fsdp_losses(host, 3)
    with using_mesh_manager(None):
        got = train_fsdp.run(FSDP + ["--steps", "3"], params_host=host)
    np.testing.assert_allclose(got["losses"], want, atol=LOSS_TOL, rtol=0)


@pytest.fixture(scope="module")
def fsdp_runs(tmp_path_factory):
    """On one device (this process): 3 steps saved, then 2 resumed from
    them. Over 2 gloo ranks: 3 straight steps, and 2 resumed from a copy
    of the one-device checkpoint."""
    import shutil

    root = tmp_path_factory.mktemp("fsdp")
    ckpt_one, ckpt_two = root / "one", root / "two"
    with using_mesh_manager(None):
        straight = train_fsdp.run(FSDP + ["--steps", "3", "--checkpoint-dir",
                                          str(ckpt_one)])
        shutil.copytree(ckpt_one, ckpt_two)
        resumed = train_fsdp.run(FSDP + ["--steps", "2", "--checkpoint-dir",
                                         str(ckpt_one)])
    keep = ["losses", "start_step", "world", "rank_param_bytes"]
    two = run_ranks(root, 2, "example_run", {"runs": [
        {"module": "fsdp.train_fsdp", "argv": FSDP + ["--steps", "3"],
         "keep": keep},
        {"module": "fsdp.train_fsdp",
         "argv": FSDP + ["--steps", "2", "--checkpoint-dir", str(ckpt_two)],
         "keep": keep}]})
    return straight, resumed, two


def test_fsdp_example_over_two_ranks_gives_one_devices_losses(fsdp_runs):
    one, _, two = fsdp_runs
    for out, _ in two:
        assert out["world"] == 2 and out["start_step"] == 0
        np.testing.assert_allclose(out["losses"], one["losses"],
                                   atol=LOSS_TOL, rtol=0)
        assert out["rank_param_bytes"] * 2 == one["rank_param_bytes"]


def test_fsdp_resume_on_two_ranks_gives_the_one_device_resume(fsdp_runs):
    _, one, two = fsdp_runs
    assert one["start_step"] == 3
    for _, out in two:
        assert out["start_step"] == 3 and out["world"] == 2
        np.testing.assert_allclose(out["losses"], one["losses"],
                                   atol=LOSS_TOL, rtol=0)


# ---- the device-mesh demos ------------------------------------------
def test_mesh_demos_hold_at_world_four(tmp_path):
    res = run_ranks(tmp_path, 4, "example_run", {"runs": [{
        "module": "device_mesh.mesh_demos", "argv": ["--device", "cpu"],
        "keep": ["placements", "tp", "sp", "hsdp", "fsdp_tp"]}]})
    for (out,) in res:
        assert out["tp"] and out["sp"]
        assert out["placements"] == {"shard0": (4, 8), "replicate": (8, 8),
                                     "shard1": (8, 4)}
        assert out["hsdp"] == (512, 64) and out["fsdp_tp"] == (32, 256)


def test_mesh_demos_refuse_fewer_than_four_ranks():
    with pytest.raises(SystemExit, match="at least 4 ranks"):
        mesh_demos.run(["--device", "cpu"])
