"""PyTorch port, Adafactor over sharded leaves (``trainer/factored.py`` with
the ``tensor_parallel.shard_dims`` layout) in the train step over the mesh,
against the reference's Adafactor as its ``Trainer`` builds it
(``adafactor_sharded`` with the parameter specs and the mesh sizes) in
its ``make_spmd_train_step`` on as many virtual CPU devices.

Models whose big leaves take the factored branch (hidden 128,
intermediate 256, vocab 256: q/gate/up/down and the embedding are
factored, k/v are not), the same numpy weights on both sides, 3 steps
(clip 1.0) on the same global batches:

  * ``tp2``: every tp-split leaf, the factored dims chosen from the
    global shape (q_proj is [L, 128, 64] on a rank, [L, 128, 128] whole);
  * ``pp2_uneven_l3``: 3 layers over 2 stages, the stack padded with a
    zero layer, as the reference pads it (its statistics count the pad);
  * ``ep2``: a Qwen3-MoE's expert stacks over ep (top-2 of 8 experts).

Each step's loss and grad norm (rtol 1e-5 / 1e-4, the mesh tests'
limits), the eval loss, and the final parameters within the limits of
``tests/test_torch_optimizer.py`` (atol 1e-7, rtol 1e-5). A control,
``pp2_uneven_l3_local``, runs the same step with the statistics of each
rank's own shard (what the optimizer computed before it knew the
layout): its parameters must fail that limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.models import qwen3_moe as jqmoe
from scaletorch_tpu.parallel import pipeline_parallel as jpp
from scaletorch_tpu.parallel.mesh import MeshManager as JMesh
from scaletorch_tpu.parallel.spmd import (
    make_spmd_eval_step,
    make_spmd_train_step,
    shard_params,
)
from scaletorch_tpu.parallel.tensor_parallel import llama_param_specs
from scaletorch_tpu.trainer.optimizer import create_optimizer as jcreate
from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
from scaletorch_tpu_torch.models.convert import flatten_params, gather_params
from scaletorch_tpu_torch.models.llama import LlamaConfig
from scaletorch_tpu_torch.models.qwen3_moe import Qwen3MoEConfig
from scaletorch_tpu_torch.parallel import pipeline_parallel as tpp
from scaletorch_tpu_torch.parallel.mesh import MeshManager
from tests.torch_dist_harness import run_ranks

DENSE = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
             num_hidden_layers=3, num_attention_heads=4,
             num_key_value_heads=2, head_dim=32, max_position_embeddings=128,
             qk_norm=True, tie_word_embeddings=False, rope_theta=1e6)
MOE = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=32, max_position_embeddings=128, rope_theta=1e6,
           num_experts=8, num_experts_per_tok=2, moe_intermediate_size=128,
           capacity_factor=1.25, aux_loss_coef=0.01, z_loss_coef=0.001)
SEQ, STEPS, CE_CHUNK = 16, 3, 8
TRAIN_CFG = dict(optimizer_name="adafactor", learning_rate=1e-2,
                 weight_decay=0.01, total_train_steps=STEPS, warmup_steps=1,
                 max_grad_norm=1.0)
TOL = {"loss": 1e-5, "grad_norm": 1e-4}
PARAMS_TOL = dict(atol=1e-7, rtol=1e-5)  # test_torch_optimizer.py's fp32
RUNS = {
    "tp2": dict(mesh={"tp": 2}, model="dense", rows=2, accum=1),
    "pp2_uneven_l3": dict(mesh={"pp": 2}, model="dense", rows=2, accum=2),
    "ep2": dict(mesh={"ep": 2}, model="moe", rows=4, accum=1),
    "pp2_uneven_l3_local": dict(mesh={"pp": 2}, model="dense", rows=2,
                                accum=2, local_stats=True),
}


def batches(rows, accum, vocab, seed=500):
    out = []
    for step in range(STEPS):
        rng = np.random.default_rng(seed + step)
        toks = rng.integers(0, vocab, (accum, rows, SEQ + 1)).astype(np.int32)
        out.append({"input_ids": toks[:, :, :-1],
                    "target_ids": toks[:, :, 1:],
                    "position_ids": np.broadcast_to(
                        np.arange(SEQ, dtype=np.int32), (accum, SEQ)).copy()})
    return out


def run_batches(run):
    arch = MOE if run["model"] == "moe" else DENSE
    return batches(run["rows"], run["accum"], arch["vocab_size"])


def jax_params(model):
    if model == "moe":
        jcfg = jqmoe.Qwen3MoEConfig(**MOE, dtype=jnp.float32,
                                    use_grouped_mlp_kernel=True)
        init = jqmoe.init_params(jax.random.PRNGKey(3), jcfg)
    else:
        jcfg = jllama.LlamaConfig(**DENSE, dtype=jnp.float32)
        init = jllama.init_params(jax.random.PRNGKey(1), jcfg)
    return jax.tree.map(np.asarray, init)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    params = {m: jax_params(m) for m in ("dense", "moe")}
    models = {"dense": {"arch": DENSE, "params": params["dense"]},
              "moe": {"arch": {**MOE, "use_grouped_mlp_kernel": True},
                      "params": params["moe"]}}
    runs = [{**r, "batches": run_batches(r)} for r in RUNS.values()]
    ranks = run_ranks(tmp_path_factory.mktemp("adafactor"), 2, "mesh_steps",
                      {"models": models, "runs": runs, "ce_chunk": CE_CHUNK,
                       "train_cfg": TRAIN_CFG}, timeout=180.0)
    return params, {name: [r[i] for r in ranks]
                    for i, name in enumerate(RUNS)}


@pytest.fixture(autouse=True)
def ce_chunk(monkeypatch):
    monkeypatch.setenv("SCALETORCH_TPU_CE_CHUNK", str(CE_CHUNK))


def reference(run, params):
    """The reference Trainer's Adafactor step on the run's mesh: metrics,
    eval loss, final parameters (flat, model order, pad removed)."""
    n = int(np.prod(list(run["mesh"].values())))
    mm = JMesh(**run["mesh"], devices=jax.devices()[:n])
    pp = "pp" if mm.pp > 1 else None
    host = dict(params)
    if run["model"] == "moe":
        jcfg = jqmoe.Qwen3MoEConfig(**MOE, dtype=jnp.float32,
                                    use_grouped_mlp_kernel=True)
        ep = "ep" if mm.ep > 1 else None
        specs = jqmoe.qwen3_moe_param_specs(jcfg, tp_axis="tp", ep_axis=ep,
                                            pp_axis=pp)
        fwd = jqmoe.forward
        kw = dict(param_specs=specs, model_family="qwen3_moe",
                  head_weight_fn=jqmoe.lm_head_weight,
                  model_kwargs={"ep_axis": ep, "return_moe_stats": True})
    else:
        jcfg = jllama.LlamaConfig(**DENSE, dtype=jnp.float32)
        specs = llama_param_specs(jcfg, tp_axis="tp", pp_axis=pp)
        fwd = jllama.forward
        kw = {}
    layers = jcfg.num_hidden_layers
    if layers % mm.pp:
        host["layers"] = jpp.pad_stacked_params(host["layers"], layers,
                                                mm.pp)
    tx, _ = jcreate(ScaleTorchTPUArguments(**TRAIN_CFG), include_clip=False,
                    param_specs=specs, axis_sizes=dict(mm.mesh.shape))
    step, p_specs, o_specs = make_spmd_train_step(
        mm, fwd, jcfg, tx, host, max_grad_norm=TRAIN_CFG["max_grad_norm"],
        donate=False, **kw)
    evaluate, _ = make_spmd_eval_step(mm, fwd, jcfg, **kw)
    jp = shard_params(mm, host, p_specs)
    js = shard_params(mm, tx.init(host), o_specs)
    metrics = []
    steps_batches = run_batches(run)
    for b in steps_batches:
        jp, js, m = step(jp, js, b)
        metrics.append({k: float(v) for k, v in m.items()})
    val = float(evaluate(jp, steps_batches[0]))
    final = jax.tree.map(np.asarray, jp)
    if layers % mm.pp:
        final["layers"] = jpp.unpad_stacked_params(final["layers"], layers,
                                                   mm.pp)
    return metrics, val, flatten_params(final)


def unflatten(flat):
    tree = {}
    for name, value in flat.items():
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = value
    return tree


def port_params(run, per_rank):
    mm = MeshManager(**run["mesh"])
    cfg = (Qwen3MoEConfig(**MOE) if run["model"] == "moe"
           else LlamaConfig(**DENSE))
    return flatten_params(gather_params(
        [unflatten(flatten_params(o["params"])) for o in per_rank], cfg, mm,
        unlayout=tpp.stage_layer_unlayout(cfg.num_hidden_layers, mm.pp,
                                          "afab", 1)))


@pytest.mark.parametrize("name", ["tp2", "pp2_uneven_l3", "ep2"])
def test_three_adafactor_steps_match_the_reference(results, name):
    params, res = results
    run = RUNS[name]
    want, want_val, want_params = reference(run, params[run["model"]])
    for out in res[name]:
        for got, ref in zip(out["metrics"], want):
            assert got["update_skipped"] == ref["update_skipped"] == 0.0
            assert got["loss"] == pytest.approx(ref["loss"], rel=TOL["loss"])
            assert got["grad_norm"] == pytest.approx(
                ref["grad_norm"], rel=TOL["grad_norm"])
        assert out["val"] == pytest.approx(want_val, rel=TOL["loss"])
    got = port_params(run, res[name])
    assert set(got) == set(want_params)
    for key, ref in want_params.items():
        np.testing.assert_allclose(got[key], ref, **PARAMS_TOL, err_msg=key)
    # the updates moved every leaf by more than the limit
    init = flatten_params(params[run["model"]])
    for key, ref in want_params.items():
        assert np.abs(ref - init[key]).max() > 100 * PARAMS_TOL["atol"], key


def test_local_statistics_at_pp2_fail_the_limit(results):
    """The control: each stage's RMS of its own layers (the pad counted
    on the last) is not the whole leaf's, and the limit sees it."""
    params, res = results
    run = RUNS["pp2_uneven_l3_local"]
    _, _, want_params = reference({**run, "local_stats": False},
                                  params["dense"])
    got = port_params(run, res["pp2_uneven_l3_local"])
    failed = []
    for key, ref in want_params.items():
        try:
            np.testing.assert_allclose(got[key], ref, **PARAMS_TOL)
        except AssertionError:
            failed.append(key)
    # every stacked leaf is scaled by its stage's RMS, not the leaf's
    assert {k for k in want_params if k.startswith("layers.")} <= set(failed)
    # the repaired step on the same batches meets it (the case above)
    assert res["pp2_uneven_l3"][0]["metrics"][0]["loss"] == pytest.approx(
        res["pp2_uneven_l3_local"][0]["metrics"][0]["loss"], rel=1e-6)
