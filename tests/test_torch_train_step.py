"""PyTorch port, the single-device training step against the JAX package's.

The JAX side is ``parallel/spmd.make_spmd_train_step`` on a one-device
mesh, with ``create_optimizer(cfg, include_clip=False)``: that is the
step the JAX ``Trainer`` builds and runs (``trainer.py:1189-1222``), so
the comparison covers the same loss (decoder with ``return_hidden``, then
the chunked fused head + cross entropy), the fp32 gradients, the
global-norm clip and ``guarded_update``. A tiny Qwen3 (qk-norm, tied
embeddings), its JAX parameters carried across with
``params_from_numpy``, takes 5 steps on the same numpy batches through
both; the loss curve and the final parameters are compared, with
gradient checkpointing on and off, with and without accumulation. The
attention backend is ``flash`` on both sides: on the CPU the JAX package
runs its XLA softmax there and the port the kernels' plain versions.

Tolerances. fp32: losses rtol 1e-6, grad norms rtol 1e-5, final
parameters atol 1e-6 (the largest difference seen is 4e-7: the two sum
in another order). bf16 compute with fp32 masters: losses rtol 2e-4,
grad norms rtol 5e-3, and each leaf's change over the 5 steps within 5e-2
in relative L2 norm (seen: 3e-2). bf16 rounds inside the forward and the
backward at other places in the two frameworks, and Adam turns a gradient
entry that is all rounding noise into a full-size step of either sign,
so single entries may differ by up to the summed learning rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.parallel.mesh import MeshManager
from scaletorch_tpu.parallel.spmd import make_spmd_train_step, shard_params
from scaletorch_tpu.trainer.optimizer import create_optimizer as jcreate
from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
from scaletorch_tpu_torch.data.dataloader import device_batch
from scaletorch_tpu_torch.models import llama as tllama
from scaletorch_tpu_torch.models import params_from_numpy, params_to_numpy
from scaletorch_tpu_torch.trainer.optimizer import create_optimizer
from scaletorch_tpu_torch.trainer.train_step import make_train_step

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, max_position_embeddings=256,
            qk_norm=True, tie_word_embeddings=True, rope_theta=1e6)
SEQ, ROWS, STEPS = 32, 2, 5
CE_CHUNK = "12"  # 32 tokens: chunks of 12, 12 and a ragged 8
TOL = {"float32": {"loss": 1e-6, "grad_norm": 1e-5, "params_abs": 1e-6},
       "bfloat16": {"loss": 2e-4, "grad_norm": 5e-3, "update_rel": 5e-2}}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def train_cfg():
    return ScaleTorchTPUArguments(learning_rate=1e-3, total_train_steps=STEPS,
                                  warmup_steps=1, max_grad_norm=1.0)


def batch(step, accum):
    rng = np.random.default_rng(step)
    toks = rng.integers(0, ARCH["vocab_size"], (accum, ROWS, SEQ + 1))
    toks = toks.astype(np.int32)
    return {"input_ids": toks[:, :, :-1], "target_ids": toks[:, :, 1:],
            "position_ids": np.broadcast_to(np.arange(SEQ, dtype=np.int32),
                                            (accum, SEQ)).copy()}


class Pair:
    """The JAX step and the port's, from one parameter draw."""

    def __init__(self, dtype, gc):
        jdt, tdt = DTYPES[dtype]
        jcfg = jllama.LlamaConfig(**ARCH, dtype=jdt)
        tcfg = tllama.LlamaConfig(**ARCH, dtype=tdt)
        cfg = train_cfg()
        self.mm = MeshManager(devices=jax.devices()[:1])
        params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
        self.tx, _ = jcreate(cfg, include_clip=False)
        self.jstep, p_specs, o_specs = make_spmd_train_step(
            self.mm, jllama.forward, jcfg, self.tx, params,
            attention_backend="flash", gradient_checkpointing=gc,
            max_grad_norm=cfg.max_grad_norm, donate=False)
        self.jp = shard_params(self.mm, params, p_specs)
        self.js = shard_params(self.mm, self.tx.init(params), o_specs)
        ttx, _ = create_optimizer(cfg)
        self.tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
        self.init = params_to_numpy(self.tp)
        self.ts = ttx.init(self.tp)
        self.tstep = make_train_step(
            tcfg, ttx, attention_backend="flash", gradient_checkpointing=gc,
            max_grad_norm=cfg.max_grad_norm)

    def step(self, b):
        self.jp, self.js, jm = self.jstep(self.jp, self.js, b)
        self.tp, self.ts, tm = self.tstep(self.tp, self.ts,
                                          device_batch(b, "cpu"))
        return ({k: float(v) for k, v in jm.items()},
                {k: float(v) for k, v in tm.items()})


@pytest.fixture(autouse=True)
def ce_chunk(monkeypatch):
    monkeypatch.setenv("SCALETORCH_TPU_CE_CHUNK", CE_CHUNK)


# fp32 covers accumulation; bf16 (the headline's compute dtype) runs one
# microbatch, as the headline row does
@pytest.mark.parametrize("dtype,gc,accum", [
    ("float32", False, 1), ("float32", True, 1), ("float32", False, 2),
    ("float32", True, 2), ("bfloat16", False, 1), ("bfloat16", True, 1)],
    ids=["fp32-no_gc", "fp32-gc", "fp32-no_gc-accum2", "fp32-gc-accum2",
         "bf16-no_gc", "bf16-gc"])
def test_five_steps_match_the_jax_step(dtype, gc, accum):
    tol = TOL[dtype]
    pair = Pair(dtype, gc)
    losses = []
    for i in range(STEPS):
        jm, tm = pair.step(batch(i, accum))
        assert tm["update_skipped"] == jm["update_skipped"] == 0.0
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=tol["loss"])
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=tol["grad_norm"])
        losses.append(tm["loss"])
    assert np.all(np.isfinite(losses))
    want = jax.tree.map(np.asarray, pair.jp)
    got = params_to_numpy(pair.tp)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        t, t0 = got, pair.init
        for key in path:
            t, t0 = t[key.key], t0[key.key]
        name = jax.tree_util.keystr(path)
        if "params_abs" in tol:
            np.testing.assert_allclose(t, leaf, atol=tol["params_abs"],
                                       rtol=0, err_msg=name)
        else:
            rel = np.linalg.norm((t - t0) - (leaf - t0)) / np.linalg.norm(
                leaf - t0)
            assert rel <= tol["update_rel"], f"{name}: update differs {rel}"
    assert int(pair.ts["count"]) == STEPS


def test_a_nonfinite_batch_skips_the_update():
    """A poisoned embedding row (inf) makes the loss of a batch that uses
    it non-finite: both steps report ``update_skipped = 1``, keep the
    parameters and moments, and advance the count."""
    pair = Pair("float32", gc=False)
    pair.step(batch(0, 1))
    b = batch(1, 1)
    tok = int(b["input_ids"][0, 0, 0])
    pair.jp["embed_tokens"] = pair.jp["embed_tokens"].at[tok].set(jnp.inf)
    with torch.no_grad():
        pair.tp["embed_tokens"][tok] = float("inf")
    before = params_to_numpy(pair.tp)
    mu_before = params_to_numpy(pair.ts["mu"])
    jm, tm = pair.step(b)
    assert tm["update_skipped"] == jm["update_skipped"] == 1.0
    assert not np.isfinite(tm["loss"]) and not np.isfinite(jm["loss"])
    after = params_to_numpy(pair.tp)
    for a, c in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
        np.testing.assert_array_equal(a, c)
    for a, c in zip(jax.tree.leaves(mu_before),
                    jax.tree.leaves(params_to_numpy(pair.ts["mu"]))):
        np.testing.assert_array_equal(a, c)
    assert int(pair.ts["count"]) == 2


def test_remat_policies_run_and_unknown_names_are_refused():
    """Each of the reference's policies runs (the port no longer refuses
    the selective ones) and gives ``nothing_saveable``'s loss and
    gradients bit for bit; an unknown name raises."""
    tcfg = tllama.LlamaConfig(**ARCH, dtype=torch.float32)
    params = params_from_numpy(
        jax.tree.map(np.asarray, jllama.init_params(
            jax.random.PRNGKey(0),
            jllama.LlamaConfig(**ARCH, dtype=jnp.float32))), "cpu")
    ids = torch.from_numpy(batch(0, 1)["input_ids"][0])
    leaves = jax.tree.leaves(params)
    results = {}
    for policy in tllama.REMAT_POLICIES:
        loss = tllama.forward(params, ids, tcfg, attention_backend="flash",
                              gradient_checkpointing=True,
                              remat_policy=policy).float().square().mean()
        results[policy] = (loss, torch.autograd.grad(loss, leaves))
    base_loss, base = results["nothing_saveable"]
    for policy, (loss, grads) in results.items():
        assert torch.equal(loss, base_loss), policy
        assert all(torch.equal(g, b) for g, b in zip(grads, base)), policy
    with pytest.raises(ValueError, match="unknown remat_policy"):
        tllama.resolve_remat_policy("everything")
