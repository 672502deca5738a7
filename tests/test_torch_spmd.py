"""PyTorch port, the train step over the mesh (``parallel/spmd.py``) in 4
gloo processes against the JAX package's ``make_spmd_train_step`` on 4
virtual CPU devices.

A tiny Qwen3 (qk-norm, tied embeddings), the same numpy weights on both
sides, takes 3 AdamW steps (clip 1.0) on the same global batches at
``dp2 x tp2`` (2 accumulated microbatches), ``cp2 x tp2`` (zigzag ring,
SP, gradient checkpointing) and ``dp2 x cp2`` (zigzag ring): each
step's loss, grad norm and ``update_skipped``, the final parameters
(gathered over the tp ranks) and the eval step's loss on the first batch.
The reference's zigzag batches are permuted on the host as its
``Trainer`` does; the port's step takes its rank's slice of the global
batch (``local_batch``). The bf16 gradient wire is held to the port's
fp32 wire.

Tolerances are those of ``tests/test_torch_train_step.py`` for fp32:
losses and eval losses rtol 1e-6, grad norms rtol 1e-5, final parameters
atol 1e-6 (the two sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.parallel.mesh import MeshManager as JMesh
from scaletorch_tpu.parallel.spmd import (
    make_spmd_eval_step,
    make_spmd_train_step,
    shard_params,
)
from scaletorch_tpu.parallel.zigzag import zigzag_batch
from scaletorch_tpu.trainer.optimizer import create_optimizer as jcreate
from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
from scaletorch_tpu_torch.models.convert import flatten_params, gather_params
from scaletorch_tpu_torch.models.llama import LlamaConfig
from scaletorch_tpu_torch.parallel.mesh import MeshManager
from tests.torch_dist_harness import run_ranks

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, max_position_embeddings=256,
            qk_norm=True, tie_word_embeddings=True, rope_theta=1e6)
SEQ, ROWS, STEPS, CE_CHUNK = 32, 2, 3, 12
TRAIN_CFG = dict(learning_rate=1e-3, total_train_steps=STEPS, warmup_steps=1,
                 max_grad_norm=1.0)
TOL = {"loss": 1e-6, "grad_norm": 1e-5, "params_abs": 1e-6}
RUNS = {
    "dp2xtp2-accum2": dict(mesh={"dp": 2, "tp": 2}, backend="flash",
                           accum=2),
    "cp2xtp2-zigzag-sp-gc": dict(mesh={"cp": 2, "tp": 2}, backend="ring",
                                 layout="zigzag", sp=True, gc=True),
    "dp2xcp2-zigzag": dict(mesh={"dp": 2, "cp": 2}, backend="ring",
                           layout="zigzag"),
}


def batches(accum):
    out = []
    for step in range(STEPS):
        rng = np.random.default_rng(100 + step)
        toks = rng.integers(0, ARCH["vocab_size"], (accum, ROWS, SEQ + 1))
        toks = toks.astype(np.int32)
        out.append({"input_ids": toks[:, :, :-1],
                    "target_ids": toks[:, :, 1:],
                    "position_ids": np.broadcast_to(
                        np.arange(SEQ, dtype=np.int32), (accum, SEQ)).copy()})
    return out


def reference(run, params, steps_batches):
    jcfg = jllama.LlamaConfig(**ARCH, dtype=jnp.float32)
    mm = JMesh(**run["mesh"], devices=jax.devices()[:4])
    tx, _ = jcreate(ScaleTorchTPUArguments(**TRAIN_CFG), include_clip=False)
    kw = dict(attention_backend=run["backend"],
              sequence_parallel=run.get("sp", False),
              cp_layout=run.get("layout", "contiguous"))
    step, p_specs, o_specs = make_spmd_train_step(
        mm, jllama.forward, jcfg, tx, params,
        gradient_checkpointing=run.get("gc", False),
        max_grad_norm=TRAIN_CFG["max_grad_norm"], donate=False, **kw)
    evaluate, _ = make_spmd_eval_step(mm, jllama.forward, jcfg, **kw)
    jp = shard_params(mm, params, p_specs)
    js = shard_params(mm, tx.init(params), o_specs)
    metrics = []
    zig = run["backend"] == "ring" and run.get("layout") == "zigzag"
    host = [zigzag_batch(b, mm.cp) if zig else b for b in steps_batches]
    for b in host:
        jp, js, m = step(jp, js, b)
        metrics.append({k: float(v) for k, v in m.items()})
    val = float(evaluate(jp, host[0]))
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg = jllama.LlamaConfig(**ARCH, dtype=jnp.float32)
    params = jax.tree.map(np.asarray,
                          jllama.init_params(jax.random.PRNGKey(0), jcfg))
    order = list(RUNS)
    port_runs = [{**RUNS[n], "batches": batches(RUNS[n].get("accum", 1))}
                 for n in order]
    # the bf16 wire, beside the fp32 run of the same mesh
    port_runs.append({**port_runs[order.index("dp2xcp2-zigzag")],
                      "wire": "bf16"})
    out = run_ranks(tmp_path_factory.mktemp("spmd"), 4, "spmd_steps",
                    {"arch": ARCH, "params": params, "ce_chunk": CE_CHUNK,
                     "train_cfg": TRAIN_CFG, "runs": port_runs})
    per_run_batches = {n: r["batches"] for n, r in zip(order, port_runs)}
    res = {key: [o[i] for o in out] for i, key in
           enumerate(order + ["bf16"])}
    return params, per_run_batches, res


@pytest.fixture(autouse=True)
def ce_chunk(monkeypatch):
    monkeypatch.setenv("SCALETORCH_TPU_CE_CHUNK", str(CE_CHUNK))


@pytest.mark.parametrize("name", list(RUNS))
def test_three_steps_match_the_jax_step(runs, name):
    params, per_run_batches, res = runs
    run = RUNS[name]
    per_rank = res[name]
    want, want_val, want_params = reference(run, params,
                                            per_run_batches[name])
    for out in per_rank:
        for got, ref in zip(out["metrics"], want):
            assert got["update_skipped"] == ref["update_skipped"] == 0.0
            assert got["loss"] == pytest.approx(ref["loss"], rel=TOL["loss"])
            assert got["grad_norm"] == pytest.approx(
                ref["grad_norm"], rel=TOL["grad_norm"])
        assert out["val"] == pytest.approx(want_val, rel=TOL["loss"])
    mm = MeshManager(**run["mesh"])
    got = flatten_params(gather_params(
        [unflatten(flatten_params(o["params"])) for o in per_rank],
        LlamaConfig(**ARCH), mm))
    for key, ref in want_params.items():
        np.testing.assert_allclose(got[key], ref, rtol=0,
                                   atol=TOL["params_abs"], err_msg=key)


def test_bf16_wire_keeps_the_fp32_wires_steps(runs):
    _, _, res = runs
    fp32, bf16 = res["dp2xcp2-zigzag"], res["bf16"]
    for a, b in zip(fp32, bf16):
        first_a, first_b = a["metrics"][0], b["metrics"][0]
        # the loss is reduced in fp32 either way; the gradients round once
        assert first_a["loss"] == first_b["loss"]
        assert first_b["grad_norm"] == pytest.approx(first_a["grad_norm"],
                                                     rel=1e-2)
        assert first_a["grad_norm"] != first_b["grad_norm"]


def test_the_step_refuses_what_waits_for_item_6b():
    # items 6b and 6b-2 are ported: a selective policy under cp builds a
    # step (the cp backends are one op each under a policy), and bad
    # pipeline or wire settings are refused as the reference does
    from scaletorch_tpu_torch.parallel.spmd import make_spmd_train_step as t

    cfg = LlamaConfig(**ARCH)
    for policy in ("save_attn", "dots_saveable"):
        assert callable(t(MeshManager(cp=2), cfg, None,
                          gradient_checkpointing=True, remat_policy=policy,
                          attention_backend="ring"))
    with pytest.raises(ValueError, match="pp_virtual_stages"):
        t(MeshManager(dp=2, pp=2), cfg, None, pp_engine="interleaved",
          pp_vpp=1)
    with pytest.raises(ValueError, match="pp_engine"):
        t(MeshManager(dp=2, pp=2), cfg, None, pp_engine="gpipe")
    with pytest.raises(ValueError, match="grad_allreduce_dtype"):
        t(MeshManager(dp=2), cfg, None, grad_allreduce_dtype="fp8")

