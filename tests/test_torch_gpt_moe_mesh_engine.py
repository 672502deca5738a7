"""PyTorch port, GPT-MoE served over a tp mesh (``models/gpt_moe.py``'s
sharded ``GPTMoEForCausalLM`` under ``gpt_moe_param_specs``;
``inference/engine.py`` with ``mesh``) in 2 and 4 gloo processes,
against the JAX package's engine.

A 2-layer GPT-MoE (4 heads of 16, 4 experts, top-2, the JAX draw scaled
by 10 so continuations move, the dropless capacity factor 4.0), the
same numpy weights on both sides, fp32, greedy:

  * over tp2 (paged, prefix cache on; and dense), tp4 (paged) and tp2 x
    dp2 (dense, slots over dp): the tokens of every request on every rank
    equal the reference engine's on one device AND on its tp virtual CPU
    mesh (weights whole, the cache's heads placed by the reference's
    ``kv_cache_shardings`` / ``paged_kv_cache_shardings``), and the
    port's own one-device engine's; every request ends ok; one compile of
    each step; each rank holds n_head/tp heads of the cache, its q/k/v
    columns and each expert's fc columns and proj rows;
  * the teacher-forced logits of the tp2 and tp4 models (paged cache)
    within 1e-5 of the JAX model's full forward, the same bits on every
    rank;
  * the engine refuses a GPT-MoE over pp, cp or ep, and a tp that does
    not divide the heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scaletorch_tpu.inference import InferenceEngine as JEngine
from scaletorch_tpu.inference import SamplingParams as JSampling
from scaletorch_tpu.models import gpt_moe as jg
from scaletorch_tpu.parallel.mesh import MeshManager as JMeshManager
from scaletorch_tpu_torch.inference import InferenceEngine, SamplingParams
from scaletorch_tpu_torch.models import gpt_moe as tg
from scaletorch_tpu_torch.parallel.mesh import MeshManager
from tests.torch_dist_harness import run_ranks

KW = dict(block_size=32, vocab_size=65, n_layer=2, n_head=4, n_embd=64,
          num_experts=4, top_k=2, capacity_factor=4.0)
ENGINE = dict(max_slots=2, max_seq=32, prefill_len=16, page_size=4)
TOL = 1e-5  # logits, fp32
RUNS = {
    2: {"tp2_paged": dict(mesh={"tp": 2},
                          engine=dict(cache_layout="paged"), logits=True),
        "tp2_dense": dict(mesh={"tp": 2}, engine=dict(cache_layout="dense"))},
    4: {"tp4_paged": dict(mesh={"tp": 4},
                          engine=dict(cache_layout="paged"), logits=True),
        "tp2_dp2_dense": dict(mesh={"tp": 2, "dp": 2},
                              engine=dict(cache_layout="dense"),
                              batch_axis="dp")},
}
ALL_RUNS = {**RUNS[2], **RUNS[4]}
TOKENS = np.array([[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7, 6, 5, 4, 3, 2]],
                  np.int32)


def schedule():
    """Four requests: the third shares the first's two-page prefix."""
    rng = np.random.default_rng(11)

    def toks(n):
        return rng.integers(0, 65, n).tolist()

    prefix = toks(8)
    return [(prefix + toks(3), 6), (toks(12), 5), (prefix + toks(2), 6),
            (toks(5), 4)]


@pytest.fixture(scope="module")
def params():
    jcfg = jg.GPTMoEConfig(**KW)
    return tg.scale_matrices(jg.init_params(jax.random.PRNGKey(3), jcfg),
                             10.0)


@pytest.fixture(scope="module")
def ranks(params, tmp_path_factory):
    tree = jax.tree.map(np.asarray, params)
    out = {}
    for world, runs in RUNS.items():
        res = run_ranks(tmp_path_factory.mktemp(f"gptmoe{world}"), world,
                        "gpt_moe_mesh_serving",
                        {"kw": KW, "params": tree, "engine": ENGINE,
                         "schedule": schedule(), "tokens": TOKENS,
                         "runs": list(runs.values())}, timeout=180.0)
        for i, name in enumerate(runs):
            out[name] = [r[i] for r in res]
    return out


def serve(eng):
    ids = [eng.submit(list(p), max_new_tokens=n) for p, n in schedule()]
    results = eng.run()
    return [results[i].tokens for i in ids]


def reference_tokens(params, layout, mesh=None, batch_axis=None):
    """The reference engine's tokens: on one device, or on the virtual
    CPU mesh ``mesh`` (GSPMD: the weights whole, the cache placed by the
    engine's own ``kv_cache_shardings``)."""
    kw = {}
    if mesh is not None:
        n = int(np.prod(list(mesh.values())))
        mm = JMeshManager(**mesh, devices=jax.devices()[:n])
        kw = dict(mesh=mm.mesh, tp_axis="tp", batch_axis=batch_axis)
    return serve(JEngine(params, jg.GPTMoEConfig(**KW),
                         sampling=JSampling(temperature=0.0),
                         cache_layout=layout, **ENGINE, **kw))


@pytest.fixture(scope="module")
def one_device(params):
    port = serve(InferenceEngine(
        jax.tree.map(np.asarray, params), tg.GPTMoEConfig(**KW),
        sampling=SamplingParams(temperature=0.0), cache_layout="paged",
        device="cpu", **ENGINE))
    want = reference_tokens(params, "paged")
    assert port == want
    return want


@pytest.mark.parametrize("name", sorted(ALL_RUNS))
def test_tokens_match_the_jax_engine_on_one_device_and_on_its_mesh(
        params, ranks, one_device, name):
    run = ALL_RUNS[name]
    layout = run["engine"]["cache_layout"]
    assert reference_tokens(params, layout, run["mesh"],
                            run.get("batch_axis")) == one_device
    for out in ranks[name]:
        assert out["tokens"] == one_device
        assert out["outcomes"] == ["ok"] * len(schedule())
        assert out["compiles"] == (1, 1)


@pytest.mark.parametrize("name", sorted(ALL_RUNS))
def test_each_rank_holds_its_heads_and_expert_slices(ranks, name):
    tp = ALL_RUNS[name]["mesh"]["tp"]
    d, layers, e = KW["n_embd"], KW["n_layer"], KW["num_experts"]
    for out in ranks[name]:
        # dim 2 holds the heads of both layouts' [L, B | pages, H, S, D]
        assert out["cache_shape"][2] == KW["n_head"] // tp
        assert out["qkv_shape"] == (layers, d, 3 * d // tp)
        assert out["expert_shapes"] == ((layers, e, d, 4 * d // tp),
                                        (layers, e, 4 * d // tp, d))


@pytest.mark.parametrize("name", ["tp2_paged", "tp4_paged"])
def test_teacher_forced_logits_match_the_jax_forward(params, ranks, name):
    want = np.asarray(jg.forward(params, jnp.asarray(TOKENS),
                                 jg.GPTMoEConfig(**KW)))
    for out in ranks[name]:
        np.testing.assert_allclose(out["logits"], want, atol=TOL, rtol=0)
        assert np.array_equal(out["logits"], ranks[name][0]["logits"])


def test_slices_put_back_give_the_full_tree(params):
    """``shard_numpy_params`` cuts q, k and v by heads; ``gather_params``
    puts every rank's slices back into the full tree."""
    from scaletorch_tpu_torch.models.convert import (
        gather_params,
        shard_numpy_params,
    )

    tree = jax.tree.map(np.asarray, params)
    cfg = tg.GPTMoEConfig(**KW)
    mm = MeshManager(tp=4)
    shards = [shard_numpy_params(tree, cfg, mm, r) for r in range(4)]
    qkv = tree["layers"]["attn_qkv"]
    w = KW["n_embd"] // 4
    for r, shard in enumerate(shards):
        want = np.concatenate([qkv[..., j * KW["n_embd"] + r * w:
                                   j * KW["n_embd"] + (r + 1) * w]
                               for j in range(3)], axis=-1)
        np.testing.assert_array_equal(shard["layers"]["attn_qkv"], want)
    back = gather_params(shards, cfg, mm)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh,match", [
    (dict(pp=2), "spans tp and dp only"), (dict(cp=2), "spans tp and dp only"),
    (dict(ep=2), "spans tp and dp only"), (dict(tp=3), "does not split 4")])
def test_the_engine_refuses_what_the_mesh_cannot_serve(mesh, match):
    with pytest.raises(ValueError, match=match):
        InferenceEngine({}, tg.GPTMoEConfig(**KW), mesh=MeshManager(**mesh),
                        device="cpu", **ENGINE)
