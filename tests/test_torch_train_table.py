"""PyTorch port, the rest of the reference's single-chip training table
against the JAX step: each optimizer (Adam, SGD, LAMB, Adafactor), bf16
master weights and the three selective remat policies, for Qwen3.

The JAX side is ``parallel/spmd.make_spmd_train_step`` on a one-device
mesh with ``create_optimizer(cfg, include_clip=False)``, and for
Adafactor the sharded Adafactor over ``llama_param_specs`` with the
mesh's sizes, as the JAX ``Trainer`` builds it (``trainer.py:438-453``).
A small Qwen3 (hidden 128, vocab 256: the embedding and the MLP leaves
take Adafactor's factored branch), its JAX parameters carried across,
takes 5 steps on the same numpy batches through both.

Tolerances. fp32: losses rtol 1e-6, grad norms rtol 1e-5, final
parameters atol 1e-6 (LAMB and Adafactor 2e-6: their per-leaf norms sum
in another order). bf16 masters with fp32 compute: losses rtol 1e-5,
the final parameters within ``BF16_ULPS`` bf16 ulps (at
max(|reference|, leaf RMS)) and the share of entries that differ under
``BF16_SHARE``, which the control (the same steps with fp32 optimizer
state) exceeds.
bf16 masters with bf16 compute (the table's rows): losses rtol 2e-4
(seen 8.0e-5), grad norms rtol 5e-3 (seen 3.9e-4) and each leaf's change
over the 5 steps within 8e-2 relative L2 (seen 5.9e-2; 3e-2 with fp32
masters in ``test_torch_train_step.py``: a bf16 master quantizes each
change to its own ulp). Here the forward and the backward round at other
places in the two frameworks, which hides the state's dtype: the control
with fp32 state reads the same (6.0e-2), so the fp32-compute test above
is the one that holds the state's dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.parallel.mesh import MeshManager
from scaletorch_tpu.parallel.spmd import make_spmd_train_step, shard_params
from scaletorch_tpu.parallel.tensor_parallel import llama_param_specs
from scaletorch_tpu.trainer.optimizer import create_optimizer as jcreate
from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
from scaletorch_tpu_torch.data.dataloader import device_batch
from scaletorch_tpu_torch.models import llama as tllama
from scaletorch_tpu_torch.models import params_from_numpy, params_to_numpy
from scaletorch_tpu_torch.trainer.optimizer import (
    create_optimizer,
    tree_map,
)
from scaletorch_tpu_torch.trainer.train_step import make_train_step
from tests.test_torch_one_thread import one_torch_thread  # noqa: F401


ARCH = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=32, max_position_embeddings=256,
            qk_norm=True, tie_word_embeddings=True, rope_theta=1e6)
SEQ, ROWS, STEPS = 32, 2, 5
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# bf16 masters, fp32 compute: the fp32 gradients differ from the
# reference's in the last bits (sums in another order), so a few round to
# the neighbouring bf16 and the difference carries. Seen: at most 2 ulps
# (adamw) and 1 (adafactor); entries not equal 0.71% (adamw) and 0.037%
# (adafactor), against 4.6% and 0.145% with fp32 optimizer state.
BF16_ULPS = 2
BF16_SHARE = {"adamw": 0.02, "adafactor": 0.0007}


def train_cfg(optimizer):
    return ScaleTorchTPUArguments(learning_rate=1e-3, total_train_steps=STEPS,
                                  warmup_steps=1, max_grad_norm=1.0,
                                  optimizer_name=optimizer)


def batch(step):
    rng = np.random.default_rng(step)
    toks = rng.integers(0, ARCH["vocab_size"], (1, ROWS, SEQ + 1))
    toks = toks.astype(np.int32)
    return {"input_ids": toks[:, :, :-1], "target_ids": toks[:, :, 1:],
            "position_ids": np.arange(SEQ, dtype=np.int32)[None].copy()}


def jax_tx(cfg, mm, jcfg):
    if cfg.optimizer_name == "adafactor":
        return jcreate(cfg, include_clip=False,
                       param_specs=llama_param_specs(jcfg, tp_axis="tp"),
                       axis_sizes=dict(mm.mesh.shape))[0]
    return jcreate(cfg, include_clip=False)[0]


class Pair:
    """The JAX step and the port's, from one parameter draw."""

    def __init__(self, optimizer="adamw", compute="float32",
                 masters="float32", gc=False, policy="nothing_saveable",
                 fp32_state=False):
        jcfg = jllama.LlamaConfig(**ARCH, dtype=DT[compute][0],
                                  param_dtype=DT[masters][0])
        tcfg = tllama.LlamaConfig(**ARCH, dtype=DT[compute][1],
                                  param_dtype=DT[masters][1])
        cfg = train_cfg(optimizer)
        mm = MeshManager(devices=jax.devices()[:1])
        params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
        tx = jax_tx(cfg, mm, jcfg)
        self.jstep, p_specs, o_specs = make_spmd_train_step(
            mm, jllama.forward, jcfg, tx, params, attention_backend="flash",
            gradient_checkpointing=gc, remat_policy=policy,
            max_grad_norm=cfg.max_grad_norm, donate=False)
        self.jp = shard_params(mm, params, p_specs)
        self.js = shard_params(mm, tx.init(params), o_specs)
        ttx, _ = create_optimizer(cfg)
        self.tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu",
                                    dtype=DT[masters][1])
        self.init = params_to_numpy(self.tp)
        self.ts = ttx.init(tree_map(lambda t: t.detach().float(), self.tp)
                           if fp32_state else self.tp)
        self.tstep = make_train_step(
            tcfg, ttx, attention_backend="flash", gradient_checkpointing=gc,
            remat_policy=policy, max_grad_norm=cfg.max_grad_norm)

    def run(self):
        out = []
        for i in range(STEPS):
            b = batch(i)
            self.jp, self.js, jm = self.jstep(self.jp, self.js, b)
            self.tp, self.ts, tm = self.tstep(self.tp, self.ts,
                                              device_batch(b, "cpu"))
            out.append(({k: float(v) for k, v in jm.items()},
                        {k: float(v) for k, v in tm.items()}))
        return out

    def leaves(self):
        """(name, port leaf, reference leaf, initial leaf) as fp32 numpy."""
        got = params_to_numpy(self.tp)
        want = jax.tree.map(lambda a: np.asarray(a, np.float32), self.jp)
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
            t, t0 = got, self.init
            for key in path:
                t, t0 = t[key.key], t0[key.key]
            yield jax.tree_util.keystr(path), t, leaf, t0


def scaled_ulps(got, want):
    """|got - want| in bf16 ulps of max(|want|, rms(want))."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want), np.sqrt(np.mean(want * want)))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(scale, 1e-30))) - 7)
    return float(np.max(np.abs(got - want) / ulp))


@pytest.fixture(autouse=True)
def ce_chunk(monkeypatch):
    monkeypatch.setenv("SCALETORCH_TPU_CE_CHUNK", "12")


@pytest.mark.parametrize("optimizer,gc,policy", [
    ("adam", False, "nothing_saveable"), ("sgd", False, "nothing_saveable"),
    ("lamb", False, "nothing_saveable"),
    ("adafactor", True, "nothing_saveable"),
    ("adamw", True, "dots_saveable"),
    ("adamw", True, "dots_with_no_batch_dims_saveable"),
    ("adamw", True, "save_attn")])
def test_fp32_five_steps_match_the_jax_step(optimizer, gc, policy):
    pair = Pair(optimizer, gc=gc, policy=policy)
    for jm, tm in pair.run():
        assert tm["update_skipped"] == jm["update_skipped"] == 0.0
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-6)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=1e-5)
    atol = 2e-6 if optimizer in ("lamb", "adafactor") else 1e-6
    for name, t, leaf, _ in pair.leaves():
        np.testing.assert_allclose(t, leaf, atol=atol, rtol=0, err_msg=name)
    assert int(pair.ts["count"]) == STEPS


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_bf16_masters_match_the_jax_step(optimizer):
    """bf16 masters and state, fp32 compute: losses rtol 1e-5, every
    parameter within ``BF16_ULPS``, and the share of parameter entries
    not equal to the reference's under ``BF16_SHARE``, which the same
    steps with fp32 optimizer state exceed."""
    share = {}
    for fp32_state in (False, True):
        pair = Pair(optimizer, masters="bfloat16", gc=True,
                    fp32_state=fp32_state)
        for jm, tm in pair.run():
            assert tm["update_skipped"] == jm["update_skipped"] == 0.0
            if not fp32_state:
                np.testing.assert_allclose(tm["loss"], jm["loss"],
                                           rtol=1e-5)
        leaves = list(pair.leaves())
        assert all(leaf.dtype == torch.bfloat16
                   for leaf in jax.tree.leaves(pair.tp))
        if not fp32_state:
            assert all(t.dtype == torch.bfloat16 for k, v in pair.ts.items()
                       if k != "count" for t in jax.tree.leaves(v))
            assert max(scaled_ulps(t, leaf)
                       for _, t, leaf, _ in leaves) <= BF16_ULPS
        share[fp32_state] = (sum(int(np.sum(t != leaf))
                                 for _, t, leaf, _ in leaves)
                             / sum(leaf.size for _, _, leaf, _ in leaves))
    assert share[False] <= BF16_SHARE[optimizer] < share[True], share


def test_bf16_masters_with_bf16_compute_match_the_jax_step():
    pair = Pair("adamw", compute="bfloat16", masters="bfloat16", gc=True,
                policy="save_attn")
    for jm, tm in pair.run():
        assert tm["update_skipped"] == jm["update_skipped"] == 0.0
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=2e-4)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                                   rtol=5e-3)
    assert pair.ts["mu"]["embed_tokens"].dtype == torch.bfloat16
    for name, t, leaf, t0 in pair.leaves():
        if not np.any(leaf != t0):
            # a norm weight of 1.0: lr 1e-3 is under half its bf16 ulp
            np.testing.assert_array_equal(t, t0, err_msg=name)
            continue
        rel = np.linalg.norm((t - t0) - (leaf - t0)) / np.linalg.norm(
            leaf - t0)
        assert rel <= 8e-2, f"{name}: update differs {rel}"
