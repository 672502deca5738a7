"""PyTorch port, tensor and sequence parallelism (``parallel/
tensor_parallel.py``, ``parallel/sequence_parallel.py`` and the tp/sp
path of ``models/llama.py``) in 2 gloo processes against the JAX
package.

  * The region functions (copy / reduce / gather, and the column and
    row-parallel linears built on them) against their defining sums.
  * ``vocab_parallel_embedding`` and the vocab-parallel losses (plain
    and fused, ``ignore_index`` included) against the JAX functions under
    ``shard_map`` over ``tp`` on 2 virtual devices: outputs and the
    gradients each rank's shard receives.
  * The decoder + fused CE at tp 2, with and without SP: loss and every
    gradient (gathered over the ranks) against ``jax.value_and_grad`` of
    the JAX model on one device, on the same numpy weights and batch.

Tolerances, fp32: region functions exact up to 1e-6 (sums of two
terms); losses rtol 1e-6; each gradient leaf within 1e-5 of its largest
entry (the shards' partial sums add in another order; seen: 1.2e-6).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.parallel import tensor_parallel as jtp
from scaletorch_tpu.parallel.mesh import MeshManager as JMesh
from scaletorch_tpu_torch.models.convert import (
    flatten_params,
    gather_params,
)
from scaletorch_tpu_torch.parallel.mesh import MeshManager
from tests.torch_dist_harness import run_ranks

ARCH = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, max_position_embeddings=256,
            qk_norm=True, tie_word_embeddings=True, rope_theta=1e6)
SEQ, ROWS, CE_CHUNK = 32, 2, 12
B, S, V, H = 2, 7, 16, 8
TP = 2


def unflatten(flat):
    tree = {}
    for name, value in flat.items():
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = value
    return tree


def gathered(per_rank, cfg, mm):
    """The full gradient tree from each rank's flat-named local grads."""
    return flatten_params(gather_params(
        [unflatten(r["grads"]) for r in per_rank], cfg, mm))


def assert_leaves_close(got, want, rel=1e-5):
    assert set(got) == set(want)
    for name in want:
        scale = float(np.abs(want[name]).max()) or 1.0
        err = float(np.abs(got[name] - want[name]).max())
        assert err <= rel * scale, (name, err, scale)


def jax_mesh():
    return JMesh(tp=TP, devices=jax.devices()[:TP]).mesh


def op_payload():
    rng = np.random.default_rng(3)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    ign = targets.copy()
    ign[0, :3] = -100
    ign[1, -1] = -100
    return {
        "mesh": {"tp": TP},
        "x": rng.standard_normal((B, S, H)).astype(np.float32),
        "table": rng.standard_normal((V, H)).astype(np.float32),
        "ids": rng.integers(0, V, (B, S)).astype(np.int32),
        "emb_w": rng.standard_normal((B, S, H)).astype(np.float32),
        "logits": 3 * rng.standard_normal((B, S, V)).astype(np.float32),
        "targets": {"all": targets, "ign": ign,
                    "none": np.full_like(targets, -100)},
        "hidden": rng.standard_normal((B, S, H)).astype(np.float32),
        "head": rng.standard_normal((H, V)).astype(np.float32) / 3,
        "xa": rng.standard_normal((B, S, H)).astype(np.float32),
        "wa": rng.standard_normal((H, 2 * H)).astype(np.float32) / 3,
        "wb": rng.standard_normal((2 * H, H)).astype(np.float32) / 3,
    }


@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    payload = op_payload()
    return payload, run_ranks(tmp_path_factory.mktemp("tp_ops"), TP,
                              "tp_ops", payload)


def test_region_functions_and_parallel_linears(ops):
    p, res = ops
    x = p["x"]
    for r, out in enumerate(res):
        # copy: identity forward; backward sums each rank's (r + 1)
        np.testing.assert_allclose(out["copy_grad"], np.full_like(x, 3.0))
        # reduce: the sum forward (x + 2x); identity backward (2 * sum)
        np.testing.assert_allclose(out["reduce"], 3 * x, rtol=1e-6)
        np.testing.assert_allclose(out["reduce_grad"], 6 * x, rtol=1e-6)
        # gather: concatenation forward; this rank's slice backward
        np.testing.assert_allclose(out["gather"],
                                   np.concatenate([x, x + 1], -1))
        w = np.arange(out["gather"].size, dtype=np.float32).reshape(
            out["gather"].shape)
        np.testing.assert_allclose(out["gather_grad"],
                                   w[..., r * H:(r + 1) * H])
    # column (gathered) then row-parallel == the two plain products
    xa, wa, wb = (jnp.asarray(p[k]) for k in ("xa", "wa", "wb"))

    def plain(xa, wa, wb):
        y = xa @ wa @ wb
        return jnp.sum(y * y), y

    (_, y), (gx, gwa, gwb) = jax.jit(jax.value_and_grad(
        plain, (0, 1, 2), has_aux=True))(xa, wa, wb)
    for r, out in enumerate(res):
        np.testing.assert_allclose(out["linear"], y, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["linear_x_grad"], gx, rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(out["linear_wa_grad"],
                                   gwa[:, r * H:(r + 1) * H], rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(out["linear_wb_grad"],
                                   gwb[r * H:(r + 1) * H], rtol=1e-5,
                                   atol=1e-4)


def test_vocab_parallel_embedding_matches_the_reference(ops):
    p, res = ops
    ids, emb_w = jnp.asarray(p["ids"]), jnp.asarray(p["emb_w"])
    f = jax.shard_map(
        lambda i, t: jtp.vocab_parallel_embedding(i, t, axis="tp"),
        mesh=jax_mesh(), in_specs=(P(), P("tp", None)), out_specs=P())
    emb, g = jax.jit(lambda t: (f(ids, t), jax.grad(
        lambda t: jnp.sum(f(ids, t) * emb_w))(t)))(jnp.asarray(p["table"]))
    for out in res:
        np.testing.assert_allclose(out["emb"], emb, rtol=1e-6)
    np.testing.assert_allclose(
        np.concatenate([out["table_grad"] for out in res]), g, rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("targets", ["all", "ign", "none"])
def test_vocab_parallel_cross_entropy_matches_the_reference(ops, targets):
    p, res = ops
    t = jnp.asarray(p["targets"][targets])
    f = jax.shard_map(
        lambda lg, tg: jtp.vocab_parallel_cross_entropy(lg, tg, axis="tp"),
        mesh=jax_mesh(), in_specs=(P(None, None, "tp"), P()),
        out_specs=P())
    loss, g = jax.jit(jax.value_and_grad(lambda lg: f(lg, t)))(
        jnp.asarray(p["logits"]))
    for out in res:
        np.testing.assert_allclose(out[f"ce_{targets}"], loss, rtol=1e-6)
    np.testing.assert_allclose(
        np.concatenate([out[f"ce_grad_{targets}"] for out in res], -1), g,
        rtol=1e-5, atol=1e-7)


def test_fused_cross_entropy_matches_the_reference(ops):
    p, res = ops
    t = jnp.asarray(p["targets"]["ign"])
    f = jax.shard_map(
        lambda h, w, tg: jtp.fused_vocab_parallel_cross_entropy(
            h, w, tg, axis="tp", chunk_size=5),
        mesh=jax_mesh(), in_specs=(P(), P(None, "tp"), P()), out_specs=P())
    loss, (gh, gw) = jax.jit(jax.value_and_grad(
        lambda h, w: f(h, w, t), (0, 1)))(jnp.asarray(p["hidden"]),
                                          jnp.asarray(p["head"]))
    for out in res:
        np.testing.assert_allclose(out["fused"], loss, rtol=1e-6)
        np.testing.assert_allclose(out["fused_hidden_grad"], gh, rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(
        np.concatenate([out["fused_head_grad"] for out in res], -1), gw,
        rtol=1e-5, atol=1e-6)


def model_case(ce_chunk=CE_CHUNK, seed=0):
    """The JAX model's numpy weights and batch, and its one-device loss
    and gradients (flat-named)."""
    jcfg = jllama.LlamaConfig(**ARCH, dtype=jnp.float32)
    params = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, ARCH["vocab_size"], (1, ROWS, SEQ + 1))
    toks = toks.astype(np.int32)
    batch = {"input_ids": toks[:, :, :-1], "target_ids": toks[:, :, 1:],
             "position_ids": np.arange(SEQ, dtype=np.int32)[None]}

    def loss_fn(p):
        hidden = jllama.forward(p, jnp.asarray(batch["input_ids"][0]), jcfg,
                                return_hidden=True)
        return jtp.fused_vocab_parallel_cross_entropy(
            hidden, jllama.lm_head_weight(p, jcfg),
            jnp.asarray(batch["target_ids"][0]), axis=None,
            chunk_size=ce_chunk)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    numpy = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (numpy(params), batch, float(loss),
            flatten_params(numpy(grads)))


def test_decoder_at_tp2_with_and_without_sp(tmp_path):
    params, batch, loss, grads = model_case()
    runs = [dict(mesh={"tp": TP}, backend="flash"),
            dict(mesh={"tp": TP}, backend="flash", sp=True),
            dict(mesh={"tp": TP}, backend="flash", sp=True, gc=True)]
    res = run_ranks(tmp_path, TP, "tp_model",
                    {"arch": ARCH, "params": params, "batch": batch,
                     "ce_chunk": CE_CHUNK, "runs": runs})
    from scaletorch_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(**ARCH)
    mm = MeshManager(tp=TP)
    for i, run in enumerate(runs):
        per_rank = [r[i] for r in res]
        for out in per_rank:
            assert out["loss"] == pytest.approx(loss, rel=1e-6), run
        assert_leaves_close(gathered(per_rank, cfg, mm), grads)
    # the replicated leaves agree across the ranks bit for bit
    for name in ("layers.input_layernorm", "layers.q_norm", "norm"):
        assert np.array_equal(res[0][1]["grads"][name],
                              res[1][1]["grads"][name])
    assert os.environ.get("SCALETORCH_TPU_CE_CHUNK") is None
