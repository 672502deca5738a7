"""PyTorch port, the expert-parallel exchange (``parallel/expert_parallel.
py``) and the MoE block over the mesh (``models/qwen3_moe.moe_block`` with
``ep_axis`` / ``tp_axis`` / SP) against the JAX package.

In 2 and 4 gloo processes:

  * the exchange to the experts and back (``all_to_all_single`` autograd
    Functions) and ``exchange_slot_counts`` at ep 2 and 4, against the
    reference's ``_exchange_to_experts`` / ``_exchange_from_experts`` /
    ``exchange_slot_counts`` under ``shard_map`` on as many virtual CPU
    devices: the moved slabs exactly, the gradient of an objective of
    both directions to 1e-6, the counts exactly;
  * ``moe_block`` (index movement, the grouped-MLP op on the exchanged
    slabs with the exchanged counts: the plain version of K5-K7 on the
    CPU) at ep 2, ep 4, ep2 x tp2 and ep2 x tp2 + SP: each rank's output,
    aux loss and routing stats against the reference's one-device block on
    that rank's rows; its gradients (the input's, every expert shard's,
    the replicated router's and norm's summed over the ranks that hold
    partials) against the reference's one-device gradients of the sum of
    every rank's objective. fp32 limits: outputs and gradients atol 1e-5,
    aux and stats rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.models import qwen3_moe as jqmoe
from scaletorch_tpu.parallel import expert_parallel as jep
from tests.torch_dist_harness import run_ranks

E, GC, H, G = 8, 6, 4, 3
ARCH = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=4,
            num_key_value_heads=2, head_dim=8, max_position_embeddings=64,
            num_experts=8, num_experts_per_tok=2, moe_intermediate_size=16,
            capacity_factor=1.25, aux_loss_coef=0.01, z_loss_coef=0.001,
            use_grouped_mlp_kernel=True)
ROWS, SEQ = 4, 16
ATOL, RTOL = 1e-5, 1e-5
RUNS = {2: {"ep2": dict(mesh={"ep": 2})},
        4: {"ep4": dict(mesh={"ep": 4}),
            "ep2xtp2": dict(mesh={"ep": 2, "tp": 2}),
            "ep2xtp2_sp": dict(mesh={"ep": 2, "tp": 2}, sp=True)}}


def payload_for(ep_max: int) -> dict:
    rng = np.random.default_rng(3)
    jcfg = jqmoe.Qwen3MoEConfig(**ARCH, dtype=jnp.float32)
    params = jax.tree.map(np.asarray,
                          jqmoe.init_params(jax.random.PRNGKey(1), jcfg))
    layer = {k: v[:1] for k, v in params["layers"].items()
             if k in ("post_attention_layernorm", "router",
                      "expert_gate_proj", "expert_up_proj",
                      "expert_down_proj")}
    layer["post_attention_layernorm"] = (
        1.0 + 0.1 * rng.standard_normal(layer["post_attention_layernorm"]
                                        .shape)).astype(np.float32)
    return {
        "arch": ARCH, "layer": layer,
        "slots": [rng.standard_normal((E, GC, H)).astype(np.float32)
                  for _ in range(ep_max)],
        "w_back": rng.standard_normal((E, GC, H)).astype(np.float32),
        "counts": [rng.integers(0, 3, (E, G)).astype(np.int32)
                   for _ in range(ep_max)],
        "x": rng.standard_normal((ROWS, SEQ, H * 8)).astype(np.float32),
        "dy": rng.standard_normal((ROWS, SEQ, H * 8)).astype(np.float32),
    }


def exchange_reference(ep: int, payload: dict) -> dict:
    mesh = Mesh(np.array(jax.devices()[:ep]), ("ep",))
    slots = jnp.stack([jnp.asarray(s) for s in payload["slots"][:ep]])
    w_back = jnp.asarray(payload["w_back"])

    def per_rank(s):
        got = jep._exchange_to_experts(s[0], "ep")
        back = jep._exchange_from_experts(got * 2.0, "ep")
        obj = jnp.sum(back * w_back) + jnp.sum(got * got)
        return got[None], back[None], obj[None]

    f = jax.jit(jax.shard_map(per_rank, mesh=mesh, in_specs=P("ep"),
                              out_specs=(P("ep"), P("ep"), P("ep"))))
    got, back, _ = f(slots)
    grad = jax.jit(jax.grad(lambda s: jnp.sum(f(s)[2])))(slots)
    counts = jnp.stack([jnp.asarray(c) for c in payload["counts"][:ep]])
    c = jax.jit(jax.shard_map(
        lambda x: jep.exchange_slot_counts(x[0], "ep")[None], mesh=mesh,
        in_specs=P("ep"), out_specs=P("ep")))(counts)
    return {"to_experts": np.asarray(got), "round_trip": np.asarray(back),
            "slots_grad": np.asarray(grad), "counts": np.asarray(c)}


def block_reference(payload: dict, ep: int) -> dict:
    """One-device ``moe_block``: each ep rank's rows alone (forward), and
    the gradients of the sum of every rank's objective."""
    jcfg = jqmoe.Qwen3MoEConfig(**ARCH, dtype=jnp.float32)
    helpers = jllama.tp_region_helpers(jcfg, None, False)
    layer = {k: jnp.asarray(v[0]) for k, v in payload["layer"].items()}
    rows = ROWS // ep
    x, dy = jnp.asarray(payload["x"]), jnp.asarray(payload["dy"])
    fwd = jax.jit(lambda x_, lyr: jqmoe.moe_block(x_, lyr, jcfg, helpers))
    per_rank = []
    for r in range(ep):
        y, aux, stats = fwd(x[r * rows:(r + 1) * rows], layer)
        per_rank.append({"y": np.asarray(y), "aux": float(aux),
                         "stats": {k: float(v) for k, v in stats.items()}})

    def objective(x_, lyr):
        total = 0.0
        for r in range(ep):
            y, aux, _ = jqmoe.moe_block(x_[r * rows:(r + 1) * rows], lyr,
                                        jcfg, helpers)
            total = total + jnp.sum(y * dy[r * rows:(r + 1) * rows]) \
                + 10.0 * aux
        return total

    gx, glayer = jax.jit(jax.grad(objective, argnums=(0, 1)))(x, layer)
    return {"per_rank": per_rank, "x_grad": np.asarray(gx),
            "layer_grads": {k: np.asarray(v) for k, v in glayer.items()}}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    payload = payload_for(4)
    out = {}
    for world, runs in RUNS.items():
        ranks = run_ranks(tmp_path_factory.mktemp(f"ep{world}"), world,
                          "ep_ops", {**payload, "runs": list(runs.values())})
        for i, name in enumerate(runs):
            out[name] = [r[i] for r in ranks]
    return payload, out


def _coords(mesh: dict, rank: int):
    tp = mesh.get("tp", 1)
    return rank // tp, rank % tp  # (ep, tp): tp fastest


@pytest.mark.parametrize("name", ["ep2", "ep4"])
def test_exchange_and_counts_match_the_reference(results, name):
    payload, res = results
    ep = RUNS[2 if name == "ep2" else 4][name]["mesh"]["ep"]
    want = exchange_reference(ep, payload)
    for rank, out in enumerate(res[name]):
        np.testing.assert_array_equal(out["to_experts"],
                                      want["to_experts"][rank])
        np.testing.assert_array_equal(out["round_trip"],
                                      want["round_trip"][rank])
        np.testing.assert_allclose(out["slots_grad"], want["slots_grad"][rank],
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(out["counts"], want["counts"][rank])
        # a round trip is the identity (times 2)
        np.testing.assert_array_equal(out["round_trip"],
                                      2.0 * payload["slots"][rank])


@pytest.mark.parametrize("name", ["ep2", "ep4", "ep2xtp2", "ep2xtp2_sp"])
def test_moe_block_over_the_mesh_matches_the_reference(results, name):
    payload, res = results
    run = {**RUNS[2], **RUNS[4]}[name]
    mesh = run["mesh"]
    ep, tp, sp = mesh["ep"], mesh.get("tp", 1), run.get("sp", False)
    want = block_reference(payload, ep)
    rows = ROWS // ep
    e_loc = ARCH["num_experts"] // ep
    inter = ARCH["moe_intermediate_size"] // tp
    summed = {}
    for rank, out in enumerate(res[name]):
        e, t = _coords(mesh, rank)
        ref = want["per_rank"][e]
        y, gx = ref["y"], want["x_grad"][e * rows:(e + 1) * rows]
        if sp:
            w = SEQ // tp
            y, gx = y[:, t * w:(t + 1) * w], gx[:, t * w:(t + 1) * w]
        np.testing.assert_allclose(out["y"], y, atol=ATOL, rtol=0)
        np.testing.assert_allclose(out["x_grad"], gx, atol=ATOL, rtol=0)
        assert out["aux"] == pytest.approx(ref["aux"], rel=RTOL)
        for k, v in ref["stats"].items():
            assert out["stats"][k] == pytest.approx(v, rel=RTOL, abs=1e-7)
        g = out["layer_grads"]
        experts = slice(e * e_loc, (e + 1) * e_loc)
        cols = slice(t * inter, (t + 1) * inter)
        lg = want["layer_grads"]
        for k, ref_g in (("expert_gate_proj", lg["expert_gate_proj"][
                              experts][..., cols]),
                         ("expert_up_proj", lg["expert_up_proj"][
                             experts][..., cols]),
                         ("expert_down_proj", lg["expert_down_proj"][
                             experts][:, cols])):
            np.testing.assert_allclose(g[k], ref_g, atol=ATOL, rtol=0,
                                       err_msg=k)
        # replicated leaves: each ep rank's own tokens (and, under SP, a
        # tp-partial)
        if sp or t == 0:
            for k in ("router", "post_attention_layernorm"):
                summed[k] = summed.get(k, 0.0) + g[k]
    for k in ("router", "post_attention_layernorm"):
        np.testing.assert_allclose(summed[k], want["layer_grads"][k],
                                   atol=ATOL, rtol=0, err_msg=k)
