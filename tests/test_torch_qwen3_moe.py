"""PyTorch port, the Qwen3-MoE training forward against the JAX package's
``models/qwen3_moe.py``.

A tiny config (E 4, top-2, capacity factor 1.25, so some choices drop),
its JAX parameters carried across with ``params_from_numpy``, the same
tokens through both ``forward``s in fp32: logits atol 1e-4, the aux loss
and the routing stats to 1e-5, and the gradients of CE + aux to a
relative L2 of 1e-4 on every leaf. The cases cover the uniform and the
interleaved (``mlp_only_layers``) layouts, both movement forms, the
grouped-MLP kernel toggle (on the CPU the port runs the kernels' plain
versions, the JAX package its masked reference) and gradient
checkpointing, each both ways. The parameter counts of the Qwen3-30B-A3B
preset equal the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scaletorch_tpu.models import qwen3_moe as jmoe
from scaletorch_tpu.models.layers import cross_entropy_loss
from scaletorch_tpu.models.presets import preset as jpreset
from scaletorch_tpu_torch.models import model_config, params_from_numpy
from scaletorch_tpu_torch.models import qwen3_moe as tmoe
from scaletorch_tpu_torch.trainer.optimizer import tree_leaves

ARCH = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            moe_intermediate_size=48, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2, head_dim=8,
            num_experts=4, num_experts_per_tok=2, capacity_factor=1.25,
            qk_norm=True, tie_word_embeddings=False, aux_loss_coef=0.01,
            z_loss_coef=0.001)
LAYOUTS = {"uniform": {}, "interleaved": {"mlp_only_layers": (1,)}}
B, S = 2, 16
TOL = {"logits": 1e-4, "scalar": 1e-5, "grad_rel": 1e-4}


def configs(layout, mode, kernel):
    kw = {**ARCH, **LAYOUTS[layout], "moe_dispatch": mode,
          "use_grouped_mlp_kernel": kernel}
    return (jmoe.Qwen3MoEConfig(**kw, dtype=jnp.float32),
            tmoe.Qwen3MoEConfig(**kw, dtype=torch.float32))


def batch(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, ARCH["vocab_size"], (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def jax_run(cfg, params, ids, tgt, gc):
    def loss(p):
        logits, aux, stats = jmoe.forward(
            p, jnp.asarray(ids), cfg, gradient_checkpointing=gc,
            return_moe_stats=True)
        return cross_entropy_loss(logits, jnp.asarray(tgt)) + aux, (
            logits, aux, stats)

    (value, (logits, aux, stats)), grads = jax.value_and_grad(
        loss, has_aux=True)(params)
    return value, logits, aux, stats, grads


@pytest.mark.parametrize("layout,mode,kernel,gc", [
    ("uniform", "index", False, False),
    ("uniform", "index", True, True),
    ("uniform", "einsum", True, False),
    ("uniform", "einsum", False, True),
    ("interleaved", "index", True, True),
    ("interleaved", "einsum", False, False),
])
def test_forward_and_grads_match_the_reference(layout, mode, kernel, gc):
    jcfg, tcfg = configs(layout, mode, kernel)
    params = jmoe.init_params(jax.random.PRNGKey(0), jcfg)
    ids, tgt = batch()
    value, logits, aux, stats, jgrads = jax_run(jcfg, params, ids, tgt, gc)

    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    out, taux, tstats = tmoe.forward(
        tparams, torch.from_numpy(ids), tcfg, gradient_checkpointing=gc,
        return_moe_stats=True, attention_backend="sdpa")
    ce = F.cross_entropy(out.float().reshape(-1, out.shape[-1]),
                         torch.from_numpy(tgt).long().reshape(-1))
    tloss = ce + taux
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(logits),
                               atol=TOL["logits"], rtol=0)
    np.testing.assert_allclose(float(taux.detach()), float(aux),
                               atol=TOL["scalar"])
    np.testing.assert_allclose(float(tloss.detach()), float(value),
                               atol=TOL["scalar"])
    for name in ("moe_dropped_fraction", "moe_load_cv"):
        np.testing.assert_allclose(float(tstats[name]), float(stats[name]),
                                   atol=TOL["scalar"], err_msg=name)
    assert float(tstats["moe_dropped_fraction"]) > 0  # cf 1.25 drops some

    tgrads = torch.autograd.grad(tloss, tree_leaves(tparams))
    assert len(tgrads) == len(jax.tree.leaves(jgrads))
    flat_t = {}

    def walk(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat_t[prefix + (k,)] = v

    walk(tparams)
    by_path = {tuple(k.key for k in p): np.asarray(g) for p, g in
               jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    for (path, leaf), g in zip(flat_t.items(), tgrads):
        want = by_path[path]
        rel = np.linalg.norm(g.numpy() - want) / max(np.linalg.norm(want),
                                                     1e-30)
        assert rel <= TOL["grad_rel"], f"{path}: grad rel {rel}"


def test_kernel_toggle_reads_the_environment_once(monkeypatch):
    monkeypatch.setenv(tmoe.GROUPED_MLP_ENV, "1")
    assert tmoe.Qwen3MoEConfig().use_grouped_mlp_kernel is True
    monkeypatch.setenv(tmoe.GROUPED_MLP_ENV, "0")
    cfg = tmoe.Qwen3MoEConfig()
    assert cfg.use_grouped_mlp_kernel is False
    monkeypatch.setenv(tmoe.GROUPED_MLP_ENV, "1")
    assert cfg.use_grouped_mlp_kernel is False
    monkeypatch.delenv(tmoe.GROUPED_MLP_ENV)
    assert tmoe.Qwen3MoEConfig().use_grouped_mlp_kernel is False


def test_layout_helpers_match_the_reference():
    kw = {**ARCH, "num_hidden_layers": 6, "mlp_only_layers": [0],
          "decoder_sparse_step": 2}
    j, t = jmoe.Qwen3MoEConfig(**kw), tmoe.Qwen3MoEConfig(**kw)
    for fn in ("sparse_layout", "sparse_layer_ids", "dense_layer_ids",
               "moe_segments", "num_params", "num_active_params"):
        assert getattr(t, fn)() == getattr(j, fn)(), fn
    assert t.mlp_only_layers == (0,) and not t.is_uniform_sparse
    with pytest.raises(ValueError, match="no layer is sparse"):
        tmoe.Qwen3MoEConfig(**{**ARCH, "mlp_only_layers": (0, 1, 2)})
    with pytest.raises(ValueError, match="moe_dispatch"):
        tmoe.Qwen3MoEConfig(moe_dispatch="sort")


def test_qwen3_30b_a3b_parameter_counts():
    kw = jpreset("qwen3-30b-a3b")
    kw.pop("model_type")
    want = jmoe.Qwen3MoEConfig(**kw)
    got = model_config("qwen3-30b-a3b")
    assert isinstance(got, tmoe.Qwen3MoEConfig)
    assert got.num_params() == want.num_params() == 30_532_122_624
    assert got.num_active_params() == want.num_active_params()
    assert got.num_hidden_layers == 48 and got.num_experts == 128
    # init_params' layout: the reference's keys and shapes
    small = dataclasses.replace(got, num_hidden_layers=1, vocab_size=8)
    jsmall = dataclasses.replace(want, num_hidden_layers=1, vocab_size=8)
    shapes = {k: s for k, (s, _) in tmoe.param_shapes(small).items()}
    jshapes = jax.eval_shape(lambda: jmoe.init_params(jax.random.PRNGKey(0),
                                                      jsmall))
    flat = {".".join(str(k.key) for k in p): tuple(v.shape) for p, v in
            jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert shapes == flat


def test_init_params_distributions():
    _, tcfg = configs("interleaved", "index", False)
    p = tmoe.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    layers = p["layers"]
    assert layers["router"].shape == (2, 32, 4)
    assert layers["gate_proj"].shape == (1, 32, 64)
    assert float(layers["router"].std()) == pytest.approx(0.02, rel=0.2)
    bound = 1 / np.sqrt(48)
    assert float(layers["expert_down_proj"].abs().max()) <= bound
    assert torch.all(layers["q_norm"] == 1)
