"""PyTorch port, pipeline parallelism (``parallel/pipeline_parallel.py``
and the pp arm of ``parallel/spmd.py``) against the JAX package.

The arithmetic (partitions, padding, the interleave order, tick
accounting) is held to the reference's functions over a grid of (L, pp,
vpp, M), and the port's MPMD tick plan to the reference's SPMD tick math
and to its discrete-event simulator (``tests/parallel/
test_pipeline_interleaved.py``).

The step: a tiny Qwen3 (qk-norm; tied embeddings, and an untied copy), the
same numpy weights on both sides, 3 AdamW steps (clip 1.0) of M
microbatches over the same global batches, in gloo processes against the
reference's ``make_spmd_train_step`` on as many virtual CPU devices:
``pp2`` afab, memory_chunked with M = 3 (a remainder pass), interleaved
(vpp 2), uneven layers (L 3), untied; ``pp4`` afab (the flash backend),
``pp2 x tp2`` + SP with GC (against the reference's one-device step:
its own pp x tp step doubles every gradient), ``pp2 x dp2``. Each step's
loss and grad
norm, the eval loss of the first batch, and the final parameters
gathered over every rank and put back in model order.

fp32 limits: losses and eval losses rtol 1e-5, grad norms rtol 1e-4,
final parameters atol 2e-6 (a pipeline sums its microbatches' gradients
in another order than the reference's scan; the tp/cp step holds 1e-6,
``tests/test_torch_spmd.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.parallel import pipeline_parallel as jpp
from scaletorch_tpu.parallel.mesh import MeshManager as JMesh
from scaletorch_tpu.parallel.spmd import (
    make_spmd_eval_step,
    make_spmd_train_step,
    shard_params,
)
from scaletorch_tpu.trainer.optimizer import create_optimizer as jcreate
from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
from scaletorch_tpu_torch.models.convert import flatten_params, gather_params
from scaletorch_tpu_torch.models.llama import LlamaConfig
from scaletorch_tpu_torch.parallel import pipeline_parallel as tpp
from scaletorch_tpu_torch.parallel.mesh import MeshManager
from tests.parallel.test_pipeline_interleaved import (
    expected_occupancy,
    simulate_schedule,
)
from tests.torch_dist_harness import run_ranks

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, max_position_embeddings=256,
            qk_norm=True, tie_word_embeddings=True, rope_theta=1e6)
MODELS = {"tied": ARCH, "untied": {**ARCH, "tie_word_embeddings": False},
          "l3": {**ARCH, "num_hidden_layers": 3}}
SEQ, ROWS, STEPS, CE_CHUNK = 32, 2, 3, 12
TRAIN_CFG = dict(learning_rate=1e-3, total_train_steps=STEPS, warmup_steps=1,
                 max_grad_norm=1.0)
TOL = {"loss": 1e-5, "grad_norm": 1e-4, "params_abs": 2e-6}
RUNS2 = {  # two gloo processes
    "pp2_afab": dict(mesh={"pp": 2}, accum=4),
    "pp2_memory_chunked_m3": dict(mesh={"pp": 2}, engine="memory_chunked",
                                  accum=3),
    "pp2_interleaved_vpp2": dict(mesh={"pp": 2}, engine="interleaved",
                                 vpp=2, accum=4),
    "pp2_uneven_l3": dict(mesh={"pp": 2}, model="l3", accum=3),
    "pp2_afab_untied": dict(mesh={"pp": 2}, model="untied", accum=2),
}
RUNS4 = {  # four
    "pp4_afab_flash": dict(mesh={"pp": 4}, backend="flash", accum=4),
    # the reference's own pp x tp step doubles every gradient (its norm
    # is 2x its one-device step's, ROADMAP Queue 3): the yardstick here is
    # its one-device step on the same global batch
    "pp2xtp2_sp_gc": dict(mesh={"pp": 2, "tp": 2}, sp=True, gc=True,
                          accum=2, yardstick=dict(mesh={}, sp=False)),
    "pp2xdp2": dict(mesh={"pp": 2, "dp": 2}, accum=2),
}


# ---- the arithmetic -------------------------------------------------------------
@pytest.mark.parametrize("layers,pp", [(8, 2), (7, 2), (7, 4), (3, 2),
                                       (28, 4), (5, 5)])
def test_partitions_and_padding_match_the_reference(layers, pp):
    assert (tpp.stage_layer_partition(layers, pp)
            == jpp.stage_layer_partition(layers, pp))
    assert (tpp.padded_stage_counts(layers, pp)
            == jpp.padded_stage_counts(layers, pp))
    w = np.arange(layers * 3, dtype=np.float32).reshape(layers, 3)
    got = tpp.pad_stacked_params({"w": w}, layers, pp)["w"]
    want = np.asarray(jpp.pad_stacked_params({"w": jnp.asarray(w)},
                                             layers, pp)["w"])
    np.testing.assert_array_equal(got, want)
    back = tpp.unpad_stacked_params({"w": got}, layers, pp)["w"]
    np.testing.assert_array_equal(back, w)
    import torch

    t = tpp.pad_stacked_params({"w": torch.from_numpy(w)}, layers, pp)["w"]
    np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("layers,pp,vpp", [(8, 2, 2), (8, 4, 2), (8, 2, 4),
                                           (12, 2, 3), (28, 2, 2)])
def test_interleave_order_matches_the_reference(layers, pp, vpp):
    w = np.arange(layers * 2, dtype=np.float32).reshape(layers, 2)
    got = tpp.interleave_stacked_params({"w": w}, layers, pp, vpp)["w"]
    want = np.asarray(jpp.interleave_stacked_params(
        {"w": jnp.asarray(w)}, layers, pp, vpp)["w"])
    np.testing.assert_array_equal(got, want)
    back = tpp.deinterleave_stacked_params({"w": got}, layers, pp, vpp)["w"]
    np.testing.assert_array_equal(back, w)
    layout = tpp.stage_layer_layout(layers, pp, "interleaved", vpp)
    unlayout = tpp.stage_layer_unlayout(layers, pp, "interleaved", vpp)
    np.testing.assert_array_equal(layout(w), want)
    np.testing.assert_array_equal(unlayout(layout(w)), w)


def test_virtual_stages_and_validation_match_the_reference():
    for layers in range(1, 30):
        for pp in (1, 2, 3, 4):
            assert (tpp.suggest_virtual_stages(layers, pp)
                    == jpp.suggest_virtual_stages(layers, pp))
    for args in ((8, 2, 1), (6, 2, 2), (8, 2, 2)):
        errs = []
        for mod in (tpp, jpp):
            try:
                mod.validate_interleaved_divisibility(*args)
                errs.append(None)
            except ValueError as exc:
                errs.append(str(exc)[:24])
        assert errs[0] == errs[1]
    with pytest.raises(ValueError, match="uniformly stacked"):
        tpp.interleave_stacked_params({"a": np.zeros((8, 2)),
                                       "b": np.zeros((4, 2))}, 8, 2, 2)
    assert tpp.MOE_PIPELINE_STATS == jpp.MOE_PIPELINE_STATS
    for layers, pp in ((8, 2), (7, 2)):
        cfg = LlamaConfig(**{**ARCH, "num_hidden_layers": layers})
        raised = []
        for mod in (tpp, jpp):
            try:
                mod.validate_pp_divisibility(cfg, pp)
                raised.append(False)
            except ValueError:
                raised.append(True)
        assert raised[0] == raised[1] == bool(layers % pp)


@pytest.mark.parametrize("m,pp,vpp", [(2, 2, 2), (4, 2, 2), (8, 4, 2),
                                      (8, 2, 4), (3, 2, 2), (6, 4, 3),
                                      (1, 3, 2), (5, 4, 1), (3, 2, 1)])
def test_tick_plan_is_the_reference_schedule(m, pp, vpp):
    assert (tpp.interleaved_finish_ticks(m, pp, vpp)
            == jpp.interleaved_finish_ticks(m, pp, vpp))
    assert (tpp.interleaved_tick_schedule(m, pp, vpp)
            == jpp.interleaved_tick_schedule(m, pp, vpp))
    ticks = jpp.interleaved_finish_ticks(m, pp, vpp)[-1] + 1
    occupancy = (simulate_schedule(m, pp, vpp)[0] if vpp > 1 else None)
    for r in range(pp):
        plan = tpp.tick_plan(m, pp, vpp, r)
        assert len(plan) == ticks
        for t, slot in enumerate(plan):
            want = expected_occupancy(t, r, m, pp, vpp)
            if occupancy is not None:
                assert want == occupancy.get((t, r))
            if vpp == 1:  # afab: stage r runs microbatch t - r
                want = (t - r, r) if 0 <= t - r < m else None
            got = None if slot is None else (slot.mb, slot.chunk * pp + r)
            assert got == want, (t, r)
            if slot is not None:
                assert slot.first == (r == 0 and slot.chunk == 0)
                assert slot.last == (r == pp - 1 and slot.chunk == vpp - 1)


def test_passes_of_each_engine():
    assert tpp._passes(4, 2, "afab") == [(0, 4)]
    assert tpp._passes(4, 2, "interleaved") == [(0, 4)]
    assert tpp._passes(5, 2, "memory_chunked") == [(0, 2), (2, 4), (4, 5)]
    assert tpp._passes(1, 4, "memory_chunked") == [(0, 1)]


# ---- the step -------------------------------------------------------------------
def batches(accum, seed=100):
    out = []
    for step in range(STEPS):
        rng = np.random.default_rng(seed + step)
        toks = rng.integers(0, ARCH["vocab_size"], (accum, ROWS, SEQ + 1))
        toks = toks.astype(np.int32)
        out.append({"input_ids": toks[:, :, :-1],
                    "target_ids": toks[:, :, 1:],
                    "position_ids": np.broadcast_to(
                        np.arange(SEQ, dtype=np.int32), (accum, SEQ)).copy()})
    return out


def jax_params(arch):
    jcfg = jllama.LlamaConfig(**arch, dtype=jnp.float32)
    return jax.tree.map(np.asarray,
                        jllama.init_params(jax.random.PRNGKey(0), jcfg))


def reference(run, arch, params, steps_batches):
    """The reference's step on the run's mesh: metrics, eval loss, final
    parameters (flat, model order)."""
    jcfg = jllama.LlamaConfig(**arch, dtype=jnp.float32)
    n = int(np.prod(list(run["mesh"].values())))
    mm = JMesh(**run["mesh"], devices=jax.devices()[:n])
    engine, vpp = run.get("engine", "afab"), run.get("vpp", 1)
    layers = arch["num_hidden_layers"]
    host = dict(params)
    if layers % mm.pp:
        host["layers"] = jpp.pad_stacked_params(host["layers"], layers,
                                                mm.pp)
    if engine == "interleaved":
        host["layers"] = jpp.interleave_stacked_params(
            host["layers"], layers, mm.pp, vpp)
    tx, _ = jcreate(ScaleTorchTPUArguments(**TRAIN_CFG), include_clip=False)
    kw = dict(attention_backend=run.get("backend", "sdpa"),
              sequence_parallel=run.get("sp", False), pp_schedule=engine,
              pp_vpp=vpp)
    step, p_specs, o_specs = make_spmd_train_step(
        mm, jllama.forward, jcfg, tx, host,
        gradient_checkpointing=run.get("gc", False),
        max_grad_norm=TRAIN_CFG["max_grad_norm"], donate=False, **kw)
    evaluate, _ = make_spmd_eval_step(mm, jllama.forward, jcfg, **kw)
    jp = shard_params(mm, host, p_specs)
    js = shard_params(mm, tx.init(host), o_specs)
    metrics = []
    for b in steps_batches:
        jp, js, m = step(jp, js, b)
        metrics.append({k: float(v) for k, v in m.items()})
    val = float(evaluate(jp, steps_batches[0]))
    final = jax.tree.map(np.asarray, jp)
    if engine == "interleaved":
        final["layers"] = jpp.deinterleave_stacked_params(
            final["layers"], layers, mm.pp, vpp)
    if layers % mm.pp:
        final["layers"] = jpp.unpad_stacked_params(final["layers"], layers,
                                                   mm.pp)
    return metrics, val, flatten_params(jax.tree.map(np.asarray, final))


def unflatten(flat):
    tree = {}
    for name, value in flat.items():
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = value
    return tree


def port_runs(runs):
    return [{**r, "model": r.get("model", "tied"),
             "batches": batches(r["accum"])} for r in runs.values()]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    params = {name: jax_params(arch) for name, arch in MODELS.items()}
    payload = {"models": {n: {"arch": a, "params": params[n]}
                          for n, a in MODELS.items()},
               "ce_chunk": CE_CHUNK, "train_cfg": TRAIN_CFG}
    out = {}
    for world, runs in ((2, RUNS2), (4, RUNS4)):
        ranks = run_ranks(tmp_path_factory.mktemp(f"pp{world}"), world,
                          "mesh_steps", {**payload,
                                         "runs": port_runs(runs)})
        for i, name in enumerate(runs):
            out[name] = [r[i] for r in ranks]
    return params, out


@pytest.fixture(autouse=True)
def ce_chunk(monkeypatch):
    monkeypatch.setenv("SCALETORCH_TPU_CE_CHUNK", str(CE_CHUNK))


@pytest.mark.parametrize("name", list(RUNS2) + list(RUNS4))
def test_three_steps_match_the_jax_step(results, name):
    params, res = results
    run = {**RUNS2, **RUNS4}[name]
    model = run.get("model", "tied")
    arch = MODELS[model]
    want, want_val, want_params = reference(
        {**run, **run.get("yardstick", {})}, arch, params[model],
        batches(run["accum"]))
    per_rank = res[name]
    for out in per_rank:
        for got, ref in zip(out["metrics"], want):
            assert got["update_skipped"] == ref["update_skipped"] == 0.0
            assert got["loss"] == pytest.approx(ref["loss"], rel=TOL["loss"])
            assert got["grad_norm"] == pytest.approx(
                ref["grad_norm"], rel=TOL["grad_norm"])
        assert out["val"] == pytest.approx(want_val, rel=TOL["loss"])
    mm = MeshManager(**run["mesh"])
    engine, vpp = run.get("engine", "afab"), run.get("vpp", 1)
    got = flatten_params(gather_params(
        [unflatten(flatten_params(o["params"])) for o in per_rank],
        LlamaConfig(**arch), mm, unlayout=tpp.stage_layer_unlayout(
            arch["num_hidden_layers"], mm.pp, engine, vpp)))
    assert set(got) == set(want_params)
    for key, ref in want_params.items():
        np.testing.assert_allclose(got[key], ref, rtol=0,
                                   atol=TOL["params_abs"], err_msg=key)
