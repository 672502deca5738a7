"""PyTorch port, Qwen3-MoE served over a tp x ep mesh
(``models/qwen3_moe.py``'s sharded ``Qwen3MoEForCausalLM`` and
``moe_block_serving`` over a rank's experts; ``inference/engine.py``
with ``mesh``) in 2 and 4 gloo processes, against the JAX package's
engine.

The tiny dropless config of ``tests/test_torch_moe_engine.py`` (capacity
factor E / k), the same numpy weights on both sides, fp32, greedy, paged
(page 4, the prefix cache on), over tp2, ep2, ep4 and tp2 x ep2 (the
grouped-MLP toggle on at ep2, plain versions on the CPU):

  * the tokens of every request on every rank equal the reference
    engine's on one device AND on the same (tp, ep) virtual CPU mesh
    with its weights placed by ``qwen3_moe_param_specs`` (a divergence
    is accepted only where the JAX logits' top-2 margin is below 1e-4,
    and the test checks it); every request ends ok; ``prefill_compile_count
    == decode_compile_count == 1`` on every rank; each rank holds Hkv/tp
    heads of the pool and its [E/ep, H, I/tp] expert slices;
  * the teacher-forced logits of the mesh's model (paged cache) within
    1e-4 of the JAX model's full forward, the same bits on every rank;
  * the engine refuses a dense config with ep > 1, a Qwen3-MoE over pp
    or cp or with ``batch_axis``, and a GPT-MoE over pp, cp or ep (its
    tp serving: ``tests/test_torch_gpt_moe_mesh_engine.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from scaletorch_tpu.inference import InferenceEngine as JEngine
from scaletorch_tpu.inference import SamplingParams as JSampling
from scaletorch_tpu.models import qwen3_moe as jmoe
from scaletorch_tpu.parallel.mesh import MeshManager as JMeshManager
from scaletorch_tpu_torch.inference.engine import InferenceEngine
from scaletorch_tpu_torch.models import qwen3_moe as tmoe
from scaletorch_tpu_torch.models.gpt_moe import GPTMoEConfig
from scaletorch_tpu_torch.models.llama import LlamaConfig
from scaletorch_tpu_torch.parallel.mesh import MeshManager
from tests.torch_dist_harness import run_ranks

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=16, moe_intermediate_size=48, num_experts=4,
          num_experts_per_tok=2, capacity_factor=2.0,
          tie_word_embeddings=False)
ENGINE = dict(max_slots=2, max_seq=32, prefill_len=16, page_size=4,
              cache_layout="paged")
MARGIN = 1e-4
TOL = 1e-4  # logits, fp32
RUNS = {
    2: {"tp2": dict(mesh={"tp": 2}),
        "ep2": dict(mesh={"ep": 2}, kernel=True)},
    4: {"ep4": dict(mesh={"ep": 4}),
        "tp2_ep2": dict(mesh={"tp": 2, "ep": 2})},
}
ALL_RUNS = {**RUNS[2], **RUNS[4]}
TOKENS = np.array([[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7, 6, 5, 4, 3, 2]],
                  np.int32)


def schedule():
    rng = np.random.default_rng(3)

    def toks(n):
        return rng.integers(0, 64, n).tolist()

    prefix = toks(8)
    return [(prefix + toks(3), 5), (toks(12), 8), (prefix + toks(2), 6),
            (toks(5), 4), (toks(7), 3)]


def jcfg():
    return jmoe.Qwen3MoEConfig(**KW, dtype=jnp.float32)


@pytest.fixture(scope="module")
def params():
    return jmoe.init_params(jax.random.PRNGKey(0), jcfg())


@pytest.fixture(scope="module")
def ranks(params, tmp_path_factory):
    tree = jax.tree.map(np.asarray, params)
    out = {}
    for world, runs in RUNS.items():
        res = run_ranks(tmp_path_factory.mktemp(f"moe{world}"), world,
                        "moe_mesh_serving",
                        {"kw": KW, "params": tree, "engine": ENGINE,
                         "schedule": schedule(), "tokens": TOKENS,
                         "runs": list(runs.values())}, timeout=180.0)
        for i, name in enumerate(runs):
            out[name] = [r[i] for r in res]
    return out


def reference_tokens(params, mesh=None):
    """The reference engine's tokens for the schedule: on one device, or
    on the (tp, ep) virtual CPU mesh ``mesh`` with the weights placed by
    ``qwen3_moe_param_specs``."""
    cfg = jcfg()
    kw = {}
    if mesh is not None:
        n = mesh.get("tp", 1) * mesh.get("ep", 1)
        mm = JMeshManager(**mesh, devices=jax.devices()[:n])
        shard = jax.tree.map(lambda s: NamedSharding(mm.mesh, s),
                             jmoe.qwen3_moe_param_specs(cfg, tp_axis="tp",
                                                        ep_axis="ep"),
                             is_leaf=lambda x: isinstance(x, P))
        params = jax.tree.map(jax.device_put, params, shard)
        kw = dict(mesh=mm.mesh, tp_axis="tp")
    eng = JEngine(params, cfg, sampling=JSampling(temperature=0.0),
                  **ENGINE, **kw)
    ids = [eng.submit(list(p), max_new_tokens=n) for p, n in schedule()]
    results = eng.run()
    return [results[i].tokens for i in ids]


def top2_margin(params, tokens):
    logits = np.asarray(jmoe.forward(
        params, jnp.asarray([tokens], jnp.int32), jcfg()))[0, -1]
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


def assert_same_tokens(params, got, want):
    """Equal, or diverging only at a near-tie of the JAX logits."""
    for (prompt, _), a, b in zip(schedule(), got, want):
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        margin = top2_margin(params, list(prompt) + list(b[:i]))
        assert margin < MARGIN, (a, b, margin)


@pytest.fixture(scope="module")
def one_device(params):
    return reference_tokens(params)


@pytest.mark.parametrize("name", sorted(ALL_RUNS))
def test_tokens_match_the_jax_engine_on_one_device_and_on_its_mesh(
        params, ranks, one_device, name):
    run = ALL_RUNS[name]
    assert_same_tokens(params, reference_tokens(params, run["mesh"]),
                       one_device)
    for out in ranks[name]:
        assert_same_tokens(params, out["tokens"], one_device)
        assert out["tokens"] == ranks[name][0]["tokens"]
        assert out["outcomes"] == ["ok"] * len(schedule())
        assert out["compiles"] == (1, 1)
        assert out["prefix_hits"] > 0


@pytest.mark.parametrize("name", sorted(ALL_RUNS))
def test_each_rank_holds_its_heads_and_experts(ranks, name):
    mesh = ALL_RUNS[name]["mesh"]
    tp, ep = mesh.get("tp", 1), mesh.get("ep", 1)
    firsts = set()
    for out in ranks[name]:
        assert out["cache_shape"][2] == KW["num_key_value_heads"] // tp
        assert out["expert_shape"] == (KW["num_experts"] // ep,
                                       KW["hidden_size"],
                                       KW["moe_intermediate_size"] // tp)
        firsts.add(out["first_expert"])
    assert firsts == {i * KW["num_experts"] // ep for i in range(ep)}


@pytest.mark.parametrize("name", sorted(ALL_RUNS))
def test_teacher_forced_logits_match_the_jax_forward(params, ranks, name):
    want = np.asarray(jmoe.forward(params, jnp.asarray(TOKENS), jcfg()))
    for out in ranks[name]:
        np.testing.assert_allclose(out["logits"], want, atol=TOL, rtol=0)
        assert np.array_equal(out["logits"], ranks[name][0]["logits"])


def test_the_engine_refuses_what_the_mesh_cannot_serve():
    moe = tmoe.Qwen3MoEConfig(**KW)
    with pytest.raises(ValueError, match="tp and dp only"):
        InferenceEngine({}, LlamaConfig(vocab_size=64, hidden_size=32,
                                        intermediate_size=64,
                                        num_hidden_layers=2,
                                        num_attention_heads=4,
                                        num_key_value_heads=2),
                        mesh=MeshManager(ep=2), device="cpu")
    for mesh in (MeshManager(pp=2), MeshManager(cp=2)):
        with pytest.raises(ValueError, match="spans tp, ep and dp"):
            InferenceEngine({}, moe, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="batch_axis must be None"):
        InferenceEngine({}, moe, mesh=MeshManager(dp=2), batch_axis="dp",
                        device="cpu")
    with pytest.raises(ValueError, match="does not split 4 experts"):
        InferenceEngine({}, moe, mesh=MeshManager(ep=3), device="cpu")
    with pytest.raises(ValueError, match="does not split 2 KV heads"):
        InferenceEngine({}, moe, mesh=MeshManager(tp=4), device="cpu")
    gpt = GPTMoEConfig(block_size=16, vocab_size=11, n_layer=1, n_head=2,
                       n_embd=16, num_experts=2, top_k=1)
    for mesh in (MeshManager(pp=2), MeshManager(cp=2), MeshManager(ep=2)):
        with pytest.raises(ValueError, match="GPT-MoE serving mesh spans "
                                             "tp and dp only"):
            InferenceEngine({}, gpt, max_seq=16, mesh=mesh, device="cpu")


def test_a_module_built_for_another_mesh_is_refused():
    cfg = tmoe.Qwen3MoEConfig(**KW, dtype=torch.float32)
    model = tmoe.Qwen3MoEForCausalLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="ep=1 shards"):
        InferenceEngine(model, cfg, mesh=MeshManager(ep=2), device="cpu",
                        **ENGINE)
