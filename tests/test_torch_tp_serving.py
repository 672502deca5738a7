"""PyTorch port, serving over a mesh (``inference/engine.py`` with ``mesh``,
``tp_axis`` and ``batch_axis``; the tensor-parallel ``forward_cached`` of
``models/llama.py``; the sharded caches of ``inference/kv_cache.py``) in
2 and 4 gloo processes, against the JAX package's engine.

A tiny Llama and a tiny Qwen3 (qk-norm), the same numpy weights on both
sides, greedy:

  * the reference's ``TestShardedServing`` schedule (dense, one request)
    and ``TestShardedPagedServing`` schedule (paged, page 4, five
    requests) at tp2, and the dense one at tp2 x dp2 with
    ``batch_axis="dp"`` (each dp rank computes its slot): the tokens of
    every request on every rank equal the reference engine's, unsharded
    and on its tp2 x dp4 mesh; ``prefill_compile_count ==
    decode_compile_count == 1`` on every rank; each rank holds Hkv/tp
    heads (and B/dp slots) of the cache and V/tp rows of the embedding;
    the paged pool's pages are conserved;
  * the teacher-forced logits of the tp2 model (dense and paged cache)
    within ``tests/test_torch_decode_graph.py``'s limit (1e-4, fp32) of
    the JAX model's full forward;
  * a clock skewed on one rank (it jumps 1000 s ahead once the requests
    are in, so a 60 s TTL passes there first): the deadline is rank 0's
    decision on every rank, so both ranks end the request alike (ok when
    rank 1 is skewed, timeout when rank 0 is) and the run ends within its
    bounded wait (the harness kills it after 120 s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from scaletorch_tpu.inference import InferenceEngine as JEngine
from scaletorch_tpu.inference import SamplingParams as JSampling
from scaletorch_tpu.inference import kv_cache as jkv
from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.parallel.tensor_parallel import llama_param_specs
from scaletorch_tpu_torch.inference import kv_cache as tkv
from scaletorch_tpu_torch.parallel.mesh import MeshManager
from tests.torch_dist_harness import run_ranks

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
ARCHS = {"llama": TINY, "qwen3": {**TINY, "qk_norm": True, "head_dim": 8}}
DENSE_SCHEDULE = [([1, 2, 3], 6)]
PAGED_SCHEDULE = [([1, 2, 3], 3), ([9, 8], 5), ([4, 5, 6, 7], 2), ([11], 6),
                  ([1, 2, 3, 5], 4)]
TOL = 1e-4  # logits, fp32 (test_torch_decode_graph.py's)
RUNS = {
    2: {
        "llama_dense_tp2": dict(arch="llama", mesh={"tp": 2},
                                schedule=DENSE_SCHEDULE, max_seq=24),
        "llama_paged_tp2": dict(arch="llama", mesh={"tp": 2},
                                layout="paged", schedule=PAGED_SCHEDULE,
                                max_seq=32),
        "qwen3_dense_tp2": dict(arch="qwen3", mesh={"tp": 2},
                                schedule=DENSE_SCHEDULE, max_seq=24),
        "qwen3_paged_tp2": dict(arch="qwen3", mesh={"tp": 2},
                                layout="paged", schedule=PAGED_SCHEDULE,
                                max_seq=32),
        "skew_rank1": dict(arch="llama", mesh={"tp": 2}, skew=1, ttl_s=60.0,
                           schedule=DENSE_SCHEDULE, max_seq=24),
        "skew_rank0": dict(arch="llama", mesh={"tp": 2}, skew=0, ttl_s=60.0,
                           schedule=DENSE_SCHEDULE, max_seq=24),
    },
    4: {
        "llama_dense_tp2_dp2_batch": dict(
            arch="llama", mesh={"tp": 2, "dp": 2}, batch_axis="dp",
            schedule=[([1, 2, 3], 6), ([7, 8, 9, 10], 5)], max_seq=24),
        "qwen3_dense_tp2_dp2_batch": dict(
            arch="qwen3", mesh={"tp": 2, "dp": 2}, batch_axis="dp",
            schedule=[([1, 2, 3], 6), ([7, 8, 9, 10], 5)], max_seq=24),
    },
}
ALL_RUNS = {**RUNS[2], **RUNS[4]}
TOKENS = np.array([[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7, 6, 5, 4, 3, 2]],
                  np.int32)


def jcfg(arch):
    return jllama.LlamaConfig(**ARCHS[arch], dtype=jnp.float32)


@pytest.fixture(scope="module")
def params():
    return {a: jax.tree.map(np.asarray,
                            jllama.init_params(jax.random.PRNGKey(0),
                                               jcfg(a)))
            for a in ARCHS}


@pytest.fixture(scope="module")
def ranks(params, tmp_path_factory):
    out = {}
    for world, runs in RUNS.items():
        res = run_ranks(tmp_path_factory.mktemp(f"serve{world}"), world,
                        "tp_serving",
                        {"archs": ARCHS, "params": params, "tokens": TOKENS,
                         "runs": list(runs.values())}, timeout=120.0)
        for i, name in enumerate(runs):
            out[name] = [r[i] for r in res]
    return out


def reference_tokens(params, run, mm_factory=None):
    """The reference engine's tokens for the run's schedule: unsharded,
    or (``mm_factory``) on its tp2 x dp4 mesh."""
    cfg = jcfg(run["arch"])
    kw = {}
    p = params[run["arch"]]
    if mm_factory is not None:
        mm = mm_factory(tp=2, dp=4)
        shard = jax.tree.map(lambda s: NamedSharding(mm.mesh, s),
                             llama_param_specs(cfg, tp_axis="tp"),
                             is_leaf=lambda x: isinstance(x, P))
        p = jax.tree.map(jax.device_put, p, shard)
        kw = dict(mesh=mm.mesh, tp_axis="tp")
    eng = JEngine(p, cfg, max_slots=2, max_seq=run["max_seq"],
                  prefill_len=8, sampling=JSampling(temperature=0.0),
                  cache_layout=run.get("layout", "dense"), page_size=4, **kw)
    ids = [eng.submit(list(q), max_new_tokens=n) for q, n in run["schedule"]]
    results = eng.run()
    return [results[i].tokens for i in ids]


SERVED = [n for n, r in ALL_RUNS.items() if "skew" not in r]


@pytest.mark.parametrize("name", SERVED)
def test_tokens_match_the_reference_engine(params, ranks, name,
                                           mm_factory):
    run = ALL_RUNS[name]
    want = reference_tokens(params, run)
    assert reference_tokens(params, run, mm_factory) == want
    for out in ranks[name]:
        assert out["tokens"] == want
        assert out["outcomes"] == ["ok"] * len(want)
        assert out["compiles"] == (1, 1)
        assert out.get("pages_free", True)


@pytest.mark.parametrize("name", SERVED)
def test_each_rank_holds_its_shards(ranks, name):
    run = ALL_RUNS[name]
    arch = ARCHS[run["arch"]]
    tp = run["mesh"]["tp"]
    dp = run["mesh"].get("dp", 1) if run.get("batch_axis") else 1
    head_dim = arch.get("head_dim", arch["hidden_size"]
                        // arch["num_attention_heads"])
    for out in ranks[name]:
        assert out["cache_shape"][2] == arch["num_key_value_heads"] // tp
        assert out["cache_shape"][4] == head_dim
        if run.get("layout", "dense") == "dense":
            assert out["cache_shape"][1] == 2 // dp
        assert out["embed_shape"] == (arch["vocab_size"] // tp,
                                      arch["hidden_size"])


@pytest.mark.parametrize("name", SERVED)
def test_teacher_forced_logits_match_the_jax_forward(params, ranks, name):
    run = ALL_RUNS[name]
    want = np.asarray(jllama.forward(params[run["arch"]],
                                     jnp.asarray(TOKENS), jcfg(run["arch"])))
    for out in ranks[name]:
        np.testing.assert_allclose(out["logits"], want, atol=TOL, rtol=0)
    assert np.array_equal(ranks[name][0]["logits"], ranks[name][-1]["logits"])


@pytest.mark.parametrize("name,outcome", [("skew_rank1", "ok"),
                                          ("skew_rank0", "timeout")])
def test_a_skewed_clock_ends_the_request_alike_on_every_rank(ranks, name,
                                                             outcome):
    outs = ranks[name]
    assert [o["outcomes"] for o in outs] == [[outcome]] * len(outs)
    assert all(o["tokens"] == outs[0]["tokens"] for o in outs)


def test_cache_specs_are_the_references():
    assert tkv.kv_cache_specs(tp_axis="tp").k == tuple(
        jkv.kv_cache_specs(tp_axis="tp").k)
    assert tkv.kv_cache_specs(tp_axis="tp", batch_axis="dp").v == tuple(
        jkv.kv_cache_specs(tp_axis="tp", batch_axis="dp").v)
    assert tkv.paged_kv_cache_specs(tp_axis="tp").k == tuple(
        jkv.paged_kv_cache_specs(tp_axis="tp").k)
    # a rank's shard and its bytes (the grid alone: no process group)
    mm = MeshManager(tp=2, dp=2)
    from scaletorch_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(**TINY)
    sh = tkv.kv_cache_shardings(mm, tp_axis="tp", batch_axis="dp")
    assert sh.k.local_shape(tkv.kv_cache_shape(cfg, 4, 16)) == (2, 2, 1,
                                                                16, 8)
    assert tkv.kv_cache_bytes(cfg, 4, 16, sharding=sh) * 4 == \
        tkv.kv_cache_bytes(cfg, 4, 16)


def test_the_engine_refuses_what_the_mesh_cannot_serve():
    from scaletorch_tpu_torch.inference.engine import InferenceEngine
    from scaletorch_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(**TINY)
    mm = MeshManager(tp=2, dp=2)
    with pytest.raises(ValueError, match="dense layout only"):
        InferenceEngine({}, cfg, mesh=mm, batch_axis="dp",
                        cache_layout="paged", device="cpu")
    with pytest.raises(ValueError, match="does not split over dp"):
        InferenceEngine({}, cfg, mesh=mm, batch_axis="dp", max_slots=3,
                        device="cpu")
    with pytest.raises(ValueError, match="tp and dp only"):
        InferenceEngine({}, cfg, mesh=MeshManager(pp=2), device="cpu")
