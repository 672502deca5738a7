"""PyTorch port, the train step over pp x ep (``parallel/spmd.py`` with
``parallel/pipeline_parallel.py`` and the MoE exchange), the int8
gradient wire, and the training CLI over pp and ep, against the JAX
package.

  * A tiny Qwen3-MoE (8 experts, top-2, capacity factor 1.25 so some
    choices drop, the grouped-MLP op on the exchanged slabs: its plain
    version on the CPU), the same numpy weights on both sides, 3 AdamW
    steps (clip 1.0) on the same global batches at ``ep2``, ``dp2 x ep2``
    and ``pp2 x ep2`` (afab, M = 2), in gloo processes against the
    reference's ``make_spmd_train_step`` with its MoE specs and model
    kwargs on as many virtual CPU devices: each step's loss, grad norm
    and routing statistics, the eval loss, the final parameters.
    fp32 limits: losses, eval losses and stats rtol 1e-5, grad norms
    rtol 1e-4, parameters atol 2e-6.
  * The int8 wire (``grad_allreduce_dtype="int8"`` over dp 2 and dp 4,
    block 32): the reference's int8 *step* fails on this jax (ROADMAP
    Queue 3), so the port's int8 step is held to the port's own fp32 step
    on the same weights and batch: the loss (reduced in fp32 before any
    update) equal, every leaf's gradient and the whole gradient with
    cosine >= 0.999 (the reference's own bound), two int8 runs equal bit
    for bit, 3 steps without a skipped update.
  * ``torchrun --nproc-per-node 2 -m scaletorch_tpu_torch.train --device
    cpu`` at ``pp2`` (afab, M = 2) on a dense Qwen3 and at ``ep2`` on the
    Qwen3-MoE against the reference ``Trainer`` on the 8 virtual devices
    (dp4 x pp2, dp4 x ep2) on one HF checkpoint: each step's loss within
    1e-5 and learning rate rtol 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import transformers

from scaletorch_tpu import config as jconfig
from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.models import qwen3 as jqwen3
from scaletorch_tpu.models import qwen3_moe as jqmoe
from scaletorch_tpu.parallel.mesh import MeshManager as JMesh
from scaletorch_tpu.parallel.spmd import (
    make_spmd_eval_step,
    make_spmd_train_step,
    shard_params,
)
from scaletorch_tpu.trainer.optimizer import create_optimizer as jcreate
from scaletorch_tpu.utils import hf_interop as jhf
from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
from scaletorch_tpu_torch.models.convert import flatten_params, gather_params
from scaletorch_tpu_torch.models.qwen3_moe import Qwen3MoEConfig
from scaletorch_tpu_torch.parallel.mesh import MeshManager
from tests.test_torch_parallel_trainer import run_cli
from tests.torch_dist_harness import run_ranks

MOE = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=8, max_position_embeddings=128, rope_theta=1e6,
           num_experts=8, num_experts_per_tok=2, moe_intermediate_size=16,
           capacity_factor=1.25, aux_loss_coef=0.01, z_loss_coef=0.001)
DENSE = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, max_position_embeddings=256,
             qk_norm=True, tie_word_embeddings=True, rope_theta=1e6)
SEQ, STEPS, CE_CHUNK, BLOCK = 32, 3, 12, 32
TRAIN_CFG = dict(learning_rate=1e-3, total_train_steps=STEPS, warmup_steps=1,
                 max_grad_norm=1.0)
TOL = {"loss": 1e-5, "grad_norm": 1e-4, "params_abs": 2e-6}
STATS = ("moe_dropped_fraction", "moe_load_cv")
MOE_RUNS = {
    2: {"ep2": dict(mesh={"ep": 2}, rows=4, accum=1)},
    4: {"dp2xep2": dict(mesh={"dp": 2, "ep": 2}, rows=4, accum=1),
        "pp2xep2": dict(mesh={"pp": 2, "ep": 2}, rows=2, accum=2)},
}
WIRE_RUNS = {  # dense: fp32 beside int8, and int8 twice
    2: {"dp2_fp32": dict(mesh={"dp": 2}),
        "dp2_int8": dict(mesh={"dp": 2}, wire="int8"),
        "dp2_int8_again": dict(mesh={"dp": 2}, wire="int8")},
    4: {"dp4_fp32": dict(mesh={"dp": 4}),
        "dp4_int8": dict(mesh={"dp": 4}, wire="int8")},
}


def batches(rows, accum, vocab, seed=300):
    out = []
    for step in range(STEPS):
        rng = np.random.default_rng(seed + step)
        toks = rng.integers(0, vocab, (accum, rows, SEQ + 1)).astype(np.int32)
        out.append({"input_ids": toks[:, :, :-1],
                    "target_ids": toks[:, :, 1:],
                    "position_ids": np.broadcast_to(
                        np.arange(SEQ, dtype=np.int32), (accum, SEQ)).copy()})
    return out


def moe_params():
    jcfg = jqmoe.Qwen3MoEConfig(**MOE, dtype=jnp.float32,
                                use_grouped_mlp_kernel=True)
    return jax.tree.map(np.asarray,
                        jqmoe.init_params(jax.random.PRNGKey(2), jcfg))


def dense_params():
    jcfg = jllama.LlamaConfig(**DENSE, dtype=jnp.float32)
    return jax.tree.map(np.asarray,
                        jllama.init_params(jax.random.PRNGKey(0), jcfg))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    models = {"moe": {"arch": {**MOE, "use_grouped_mlp_kernel": True},
                      "params": moe_params()},
              "dense": {"arch": DENSE, "params": dense_params()}}
    out = {}
    for world in (2, 4):
        runs = [{**r, "model": "moe", "grads": False, "batches": batches(
            r["rows"], r["accum"], MOE["vocab_size"])}
            for r in MOE_RUNS[world].values()]
        runs += [{**r, "model": "dense", "grads": True,
                  "batches": batches(4, 1, DENSE["vocab_size"], seed=400)}
                 for r in WIRE_RUNS[world].values()]
        names = list(MOE_RUNS[world]) + list(WIRE_RUNS[world])
        ranks = run_ranks(tmp_path_factory.mktemp(f"ppep{world}"), world,
                          "mesh_steps", {"models": models, "runs": runs,
                                         "ce_chunk": CE_CHUNK,
                                         "train_cfg": TRAIN_CFG,
                                         "block": BLOCK})
        for i, name in enumerate(names):
            out[name] = [r[i] for r in ranks]
    return models, out


@pytest.fixture(autouse=True)
def ce_chunk(monkeypatch):
    monkeypatch.setenv("SCALETORCH_TPU_CE_CHUNK", str(CE_CHUNK))


def moe_reference(run, params, steps_batches):
    jcfg = jqmoe.Qwen3MoEConfig(**MOE, dtype=jnp.float32,
                                use_grouped_mlp_kernel=True)
    n = int(np.prod(list(run["mesh"].values())))
    mm = JMesh(**run["mesh"], devices=jax.devices()[:n])
    ep = "ep" if mm.ep > 1 else None
    specs = jqmoe.qwen3_moe_param_specs(
        jcfg, tp_axis="tp", ep_axis=ep, pp_axis="pp" if mm.pp > 1 else None)
    kw = dict(param_specs=specs, model_family="qwen3_moe",
              head_weight_fn=jqmoe.lm_head_weight,
              model_kwargs={"ep_axis": ep, "return_moe_stats": True})
    tx, _ = jcreate(ScaleTorchTPUArguments(**TRAIN_CFG), include_clip=False)
    step, p_specs, o_specs = make_spmd_train_step(
        mm, jqmoe.forward, jcfg, tx, params,
        max_grad_norm=TRAIN_CFG["max_grad_norm"], donate=False, **kw)
    evaluate, _ = make_spmd_eval_step(mm, jqmoe.forward, jcfg, **kw)
    jp = shard_params(mm, params, p_specs)
    js = shard_params(mm, tx.init(params), o_specs)
    metrics = []
    for b in steps_batches:
        jp, js, m = step(jp, js, b)
        metrics.append({k: float(v) for k, v in m.items()})
    val = float(evaluate(jp, steps_batches[0]))
    return metrics, val, flatten_params(jax.tree.map(np.asarray, jp))


def unflatten(flat):
    tree = {}
    for name, value in flat.items():
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = value
    return tree


@pytest.mark.parametrize("name", ["ep2", "dp2xep2", "pp2xep2"])
def test_moe_steps_match_the_jax_step(results, name):
    models, res = results
    run = {**MOE_RUNS[2], **MOE_RUNS[4]}[name]
    want, want_val, want_params = moe_reference(
        run, models["moe"]["params"],
        batches(run["rows"], run["accum"], MOE["vocab_size"]))
    per_rank = res[name]
    for out in per_rank:
        for got, ref in zip(out["metrics"], want):
            assert got["update_skipped"] == ref["update_skipped"] == 0.0
            assert got["loss"] == pytest.approx(ref["loss"], rel=TOL["loss"])
            assert got["grad_norm"] == pytest.approx(
                ref["grad_norm"], rel=TOL["grad_norm"])
            for k in STATS:
                assert got[k] == pytest.approx(ref[k], rel=TOL["loss"],
                                               abs=1e-7), k
        assert out["val"] == pytest.approx(want_val, rel=TOL["loss"])
    # some choices drop: the stats are not trivially zero
    assert per_rank[0]["metrics"][0]["moe_dropped_fraction"] > 0
    mm = MeshManager(**run["mesh"])
    got = flatten_params(gather_params(
        [unflatten(flatten_params(o["params"])) for o in per_rank],
        Qwen3MoEConfig(**MOE), mm))
    assert set(got) == set(want_params)
    for key, ref in want_params.items():
        np.testing.assert_allclose(got[key], ref, rtol=0,
                                   atol=TOL["params_abs"], err_msg=key)


def _cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("world", [2, 4])
def test_int8_wire_keeps_the_fp32_steps_gradients(results, world):
    _, res = results
    fp32, int8 = res[f"dp{world}_fp32"], res[f"dp{world}_int8"]
    for a, b in zip(fp32, int8):
        assert a["loss0"] == b["loss0"]  # reduced in fp32 either way
        for ga, gb in zip(a["grads0"], b["grads0"]):
            if np.abs(ga).max() > 0:
                assert _cosine(ga, gb) >= 0.999
        whole = _cosine(np.concatenate([g.ravel() for g in a["grads0"]]),
                        np.concatenate([g.ravel() for g in b["grads0"]]))
        assert 0.999 <= whole < 1.0  # int8 moved, and rounded
        assert all(m["update_skipped"] == 0.0 for m in b["metrics"])
        assert all(np.isfinite(m["loss"]) for m in b["metrics"])
    # every rank holds the same reduced gradient
    for g0, g1 in zip(int8[0]["grads0"], int8[-1]["grads0"]):
        np.testing.assert_array_equal(g0, g1)
    if world == 2:
        again = res["dp2_int8_again"]
        for a, b in zip(int8, again):
            for ga, gb in zip(a["grads0"], b["grads0"]):
                np.testing.assert_array_equal(ga, gb)
            assert a["metrics"] == b["metrics"]


# ---- the CLI ------------------------------------------------------------------------
CLI_STEPS = 3
CLI_COMMON = dict(load_pretrained_weights=True, synthetic_data=True,
                  sequence_length=16, dtype="float32",
                  total_train_steps=CLI_STEPS, warmup_steps=1,
                  log_frequency=1, gradient_accumulation_steps=2)
CLI_DENSE = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, head_dim=16,
                 max_position_embeddings=128, tie_word_embeddings=True,
                 rope_theta=10000.0)
CLI_MOE = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=8,
               max_position_embeddings=128, rope_theta=10000.0,
               num_experts=4, num_experts_per_tok=2,
               moe_intermediate_size=16)
CLI_CASES = {
    "pp2_dense": ("qwen3", CLI_DENSE, dict(pipeline_parallel_size=2)),
    "ep2_moe": ("qwen3_moe", CLI_MOE, dict(expert_parallel_size=2)),
}


def _checkpoint(path, model_type, arch):
    if model_type == "qwen3":
        jcfg = jqwen3.Qwen3Config(**arch, dtype=jnp.float32)
        params = jllama.init_params(jax.random.PRNGKey(5), jcfg)
        transformers.Qwen3Config(**arch).save_pretrained(str(path))
    else:
        jcfg = jqmoe.Qwen3MoEConfig(**arch, dtype=jnp.float32)
        params = jqmoe.init_params(jax.random.PRNGKey(5), jcfg)
        transformers.Qwen3MoeConfig(**arch).save_pretrained(str(path))
    jhf.save_hf_params(str(path), params, jcfg)
    return str(path)


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_torchrun_over_pp_and_ep_trains_like_the_reference(case, tmp_path):
    from scaletorch_tpu.trainer.trainer import Trainer as JTrainer

    model_type, arch, mesh = CLI_CASES[case]
    ckpt = _checkpoint(tmp_path / "hf", model_type, arch)
    logs = tmp_path / "logs"
    common = {**CLI_COMMON, "model_type": model_type,
              "model_name_or_path": ckpt}
    args = ["--device", "cpu", "--micro_batch_size", "4",
            "--performance_log_dir", str(logs)]
    for key, value in {**common, **mesh}.items():
        args += [f"--{key}", str(value)]
    rc, out = run_cli(args)
    assert rc == 0, out[-4000:]
    # (rank 0 also logs the coordinated run's straggler line)
    assert out.count("step      1 | loss") == 1, out[-4000:]
    assert out.count("step      1 | host step-time") == 1, out[-4000:]
    with open(logs / f"performance_log_step{CLI_STEPS}.json") as f:
        ours = json.load(f)["records"]
    theirs = JTrainer(jconfig.ScaleTorchTPUArguments(
        **common, **mesh, micro_batch_size=1,
        data_parallel_size=len(jax.devices()) // 2))
    theirs.train()
    ref = theirs.metrics.history
    assert [r["step"] for r in ours] == [r["step"] for r in ref] == [1, 2, 3]
    for a, b in zip(ours, ref):
        assert abs(a["loss"] - b["loss"]) <= 1e-5
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
        assert a["update_skipped"] == 0.0
        if model_type == "qwen3_moe":
            assert a["moe_dropped_fraction"] == pytest.approx(
                b["moe_dropped_fraction"], rel=1e-5, abs=1e-7)
