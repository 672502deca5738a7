"""PyTorch port, the Qwen3-MoE training step against the JAX package's.

As ``test_torch_train_step.py`` does for Qwen3: the JAX side is
``parallel/spmd.make_spmd_train_step`` on a one-device mesh with the MoE
forward, its parameter specs and ``return_moe_stats`` (as the JAX
``Trainer`` builds it, ``trainer.py:328-348``), and
``create_optimizer(cfg, include_clip=False)``. A tiny Qwen3-MoE (E 4,
top-2, capacity factor 1.25: some choices drop), its JAX parameters
carried across, takes 5 steps on the same numpy batches through both:
the loss (CE + aux) curve, the grad norms, the routing statistics in the
metrics and the final parameters are compared in fp32, with the
grouped-MLP kernel toggle and gradient checkpointing. Tolerances: losses
rtol 1e-6, grad norms rtol 1e-5, routing statistics atol 1e-5, final
parameters atol 1e-6. Then the port's ``Trainer`` builds this family
from its CLI fields and counts MFU over the active parameters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.models import qwen3_moe as jmoe
from scaletorch_tpu.parallel.mesh import MeshManager
from scaletorch_tpu.parallel.spmd import make_spmd_train_step, shard_params
from scaletorch_tpu.trainer.optimizer import create_optimizer as jcreate
from scaletorch_tpu_torch.benchmark import make_bench_args
from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
from scaletorch_tpu_torch.data.dataloader import device_batch
from scaletorch_tpu_torch.models import params_from_numpy, params_to_numpy
from scaletorch_tpu_torch.models import presets as tpresets
from scaletorch_tpu_torch.models import qwen3_moe as tmoe
from scaletorch_tpu_torch.trainer.optimizer import create_optimizer
from scaletorch_tpu_torch.trainer.train_step import make_train_step
from scaletorch_tpu_torch.trainer.trainer import Trainer, build_model_config

ARCH = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            moe_intermediate_size=48, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=8,
            num_experts=4, num_experts_per_tok=2, capacity_factor=1.25,
            qk_norm=True, tie_word_embeddings=False, rope_theta=1e6)
SEQ, ROWS, STEPS = 16, 2, 5
TOL = {"loss": 1e-6, "grad_norm": 1e-5, "stats": 1e-5, "params_abs": 1e-6}
STATS = ("moe_dropped_fraction", "moe_load_cv")


def batch(step):
    rng = np.random.default_rng(step)
    toks = rng.integers(0, ARCH["vocab_size"], (1, ROWS, SEQ + 1))
    toks = toks.astype(np.int32)
    return {"input_ids": toks[:, :, :-1], "target_ids": toks[:, :, 1:],
            "position_ids": np.arange(SEQ, dtype=np.int32)[None].copy()}


@pytest.fixture(autouse=True)
def ce_chunk(monkeypatch):
    monkeypatch.setenv("SCALETORCH_TPU_CE_CHUNK", "12")


@pytest.mark.parametrize("kernel,gc", [(False, False), (True, True)],
                         ids=["einsum", "kernel-gc"])
def test_five_steps_match_the_jax_step(kernel, gc):
    jcfg = jmoe.Qwen3MoEConfig(**ARCH, dtype=jnp.float32)
    tcfg = tmoe.Qwen3MoEConfig(**ARCH, dtype=torch.float32,
                               use_grouped_mlp_kernel=kernel)
    cfg = ScaleTorchTPUArguments(learning_rate=1e-3, total_train_steps=STEPS,
                                 warmup_steps=1, max_grad_norm=1.0)
    mm = MeshManager(devices=jax.devices()[:1])
    params = jmoe.init_params(jax.random.PRNGKey(0), jcfg)
    tx, _ = jcreate(cfg, include_clip=False)
    jstep, p_specs, o_specs = make_spmd_train_step(
        mm, jmoe.forward, jcfg, tx, params, attention_backend="flash",
        gradient_checkpointing=gc, max_grad_norm=cfg.max_grad_norm,
        donate=False, head_weight_fn=jmoe.lm_head_weight,
        param_specs=jmoe.qwen3_moe_param_specs(jcfg, tp_axis="tp",
                                               ep_axis=None),
        model_kwargs={"return_moe_stats": True})
    jp = shard_params(mm, params, p_specs)
    js = shard_params(mm, tx.init(params), o_specs)
    ttx, _ = create_optimizer(cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    ts = ttx.init(tp)
    tstep = make_train_step(tcfg, ttx, attention_backend="flash",
                            gradient_checkpointing=gc,
                            max_grad_norm=cfg.max_grad_norm)
    dropped = []
    for i in range(STEPS):
        b = batch(i)
        jp, js, jm = jstep(jp, js, b)
        tp, ts, tm = tstep(tp, ts, device_batch(b, "cpu"))
        jm = {k: float(v) for k, v in jm.items()}
        tm = {k: float(v) for k, v in tm.items()}
        assert tm["update_skipped"] == jm["update_skipped"] == 0.0
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=TOL["loss"])
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=TOL["grad_norm"])
        for name in STATS:
            np.testing.assert_allclose(tm[name], jm[name], atol=TOL["stats"],
                                       err_msg=name)
        dropped.append(tm["moe_dropped_fraction"])
    assert max(dropped) > 0
    want = jax.tree.map(np.asarray, jp)
    got = params_to_numpy(tp)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        t = got
        for key in path:
            t = t[key.key]
        np.testing.assert_allclose(t, leaf, atol=TOL["params_abs"], rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_trainer_builds_the_moe_family():
    cfg = ScaleTorchTPUArguments(
        model_type="qwen3_moe", vocab_size=64, hidden_size=32,
        intermediate_size=64, moe_intermediate_size=48, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        num_experts=4, num_experts_per_tok=2, moe_capacity_factor=2.0,
        mlp_only_layers=[1, -1], sequence_length=16, synthetic_data=True,
        total_train_steps=2, log_frequency=1)
    mcfg = build_model_config(cfg)
    assert isinstance(mcfg, tmoe.Qwen3MoEConfig)
    assert mcfg.mlp_only_layers == (1,) and mcfg.capacity_factor == 2.0
    trainer = Trainer(cfg, device="cpu")
    assert trainer.mfu_params == mcfg.num_active_params() < trainer.num_params
    record = trainer.train()
    assert np.isfinite(record["loss"])
    assert 0.0 <= record["moe_dropped_fraction"] <= 1.0
    assert record["moe_load_cv"] >= 0.0


def test_make_bench_args_passes_the_preset_whole(monkeypatch):
    args = make_bench_args("qwen3-30b-a3b", seq=4096, gc=True)
    assert (args.model_type, args.num_experts, args.num_experts_per_tok,
            args.moe_intermediate_size) == ("qwen3_moe", 128, 8, 768)
    mcfg = build_model_config(dataclasses.replace(args, num_hidden_layers=4))
    assert mcfg.num_experts == 128 and mcfg.num_key_value_heads == 4
    bad = dict(tpresets.MODEL_PRESETS["moe-tiny"], expert_bias=True)
    monkeypatch.setitem(tpresets.MODEL_PRESETS, "moe-tiny", bad)
    with pytest.raises(TypeError, match="expert_bias"):
        make_bench_args("moe-tiny", seq=64)
