"""PyTorch port, serving Qwen3-MoE: the port's paged ``InferenceEngine``
on the CPU against the JAX package's, fp32, greedy, on a tiny dropless
config (capacity factor E / k, as the reference's paged-engine test
runs it). Generated tokens must agree (a divergence is accepted only
where the JAX logits' top-2 margin is below 1e-4, and the test checks
it), with prefix hits and page conservation; the grouped-MLP kernel
toggle (plain versions on the CPU) changes nothing. Teacher-forced
decode, dense and paged, equals the port's own full forward to 1e-4, and
an interleaved dense/sparse config is refused."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.inference import InferenceEngine as JaxEngine
from scaletorch_tpu.inference import SamplingParams as JaxSampling
from scaletorch_tpu.models import qwen3_moe as jmoe
from scaletorch_tpu_torch.inference import (
    InferenceEngine,
    SamplingParams,
    teacher_forced_decode,
    teacher_forced_decode_paged,
)
from scaletorch_tpu_torch.models import Qwen3MoEForCausalLM, params_from_numpy
from scaletorch_tpu_torch.models import qwen3_moe as tmoe

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=16, moe_intermediate_size=48, num_experts=4,
          num_experts_per_tok=2, capacity_factor=2.0,
          tie_word_embeddings=False)
ENGINE = dict(max_slots=2, max_seq=32, prefill_len=16, page_size=4,
              cache_layout="paged")
MARGIN = 1e-4
TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = jmoe.Qwen3MoEConfig(**KW, dtype=jnp.float32)
    tcfg = tmoe.Qwen3MoEConfig(**KW, dtype=torch.float32)
    params = jmoe.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    model = Qwen3MoEForCausalLM.from_params(tree, tcfg, device="cpu")
    return jcfg, params, tcfg, model, tree


def schedule():
    rng = np.random.default_rng(3)

    def toks(n):
        return rng.integers(0, 64, n).tolist()

    prefix = toks(8)
    return [(prefix + toks(3), 5), (toks(12), 8), (prefix + toks(2), 6),
            (toks(5), 4), (toks(7), 3)]


def serve(eng):
    ids = [eng.submit(p, max_new_tokens=n) for p, n in schedule()]
    eng.run()
    return [eng.result(i) for i in ids]


def top2_margin(params, jcfg, tokens):
    logits = np.asarray(jmoe.forward(
        params, jnp.asarray([tokens], jnp.int32), jcfg))[0, -1]
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("kernel", [False, True], ids=["einsum", "kernel"])
def test_paged_engine_matches_the_jax_engine(models, kernel):
    jcfg, params, tcfg, model, _ = models
    tcfg = dataclasses.replace(tcfg, use_grouped_mlp_kernel=kernel)
    je = JaxEngine(params, jcfg, sampling=JaxSampling(temperature=0.0),
                   **ENGINE)
    te = InferenceEngine(model, tcfg, sampling=SamplingParams(
        temperature=0.0), device="cpu", **ENGINE)
    for j, t in zip(serve(je), serve(te)):
        assert (j.outcome, j.finish_reason) == (t.outcome, t.finish_reason)
        assert j.prefix_hit == t.prefix_hit
        if j.tokens != t.tokens:
            k = next(i for i, (a, b) in enumerate(zip(j.tokens, t.tokens))
                     if a != b)
            margin = top2_margin(params, jcfg, j.prompt + j.tokens[:k])
            assert margin < MARGIN, (j.request_id, k, margin)
    assert te.metrics.prefix_hits == je.metrics.prefix_hits >= 1
    assert te.metrics.snapshot()["requests_ok"] == 5
    te.allocator.check_conservation()


def test_engine_builds_the_moe_model_from_a_tree(models):
    _, _, tcfg, model, tree = models
    eng = InferenceEngine(tree, tcfg, device="cpu", **ENGINE)
    assert isinstance(eng.model, Qwen3MoEForCausalLM)
    assert eng.model.layers["router"].dtype == torch.float32
    for name, p in model.named_parameters():
        assert torch.equal(dict(eng.model.named_parameters())[name], p)


@pytest.mark.parametrize("prefill_len", [1, 5])
def test_teacher_forced_decode_matches_the_forward(models, prefill_len):
    _, _, tcfg, model, tree = models
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, (2, 12)).astype(np.int32))
    params = params_from_numpy(tree, "cpu")
    with torch.no_grad():
        full = tmoe.forward(params, ids, tcfg)
        dense = teacher_forced_decode(model, tcfg, ids,
                                      prefill_len=prefill_len)
        paged = teacher_forced_decode_paged(model, tcfg, ids, page_size=4,
                                            prefill_len=prefill_len)
    np.testing.assert_allclose(dense.numpy(), full.numpy(), atol=TOL, rtol=0)
    assert torch.equal(paged, dense)


def test_a_config_of_other_weights_is_refused(models):
    _, _, tcfg, model, _ = models
    ids = torch.zeros(1, 3, dtype=torch.int32)
    other = dataclasses.replace(tcfg, num_experts=8)
    with pytest.raises(ValueError, match="another config"):
        teacher_forced_decode(model, other, ids)
    # how it runs may change: the kernel toggle and the movement form
    same = dataclasses.replace(tcfg, use_grouped_mlp_kernel=True,
                               moe_dispatch="einsum")
    with torch.no_grad():
        a = teacher_forced_decode(model, same, ids)
        b = teacher_forced_decode(model, tcfg, ids)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_interleaved_configs_are_refused(models):
    _, _, tcfg, model, tree = models
    mixed = dataclasses.replace(tcfg, mlp_only_layers=(0,))
    with pytest.raises(NotImplementedError, match="uniform-sparse"):
        Qwen3MoEForCausalLM(mixed, device="cpu")
    with pytest.raises(NotImplementedError, match="uniform-sparse"):
        tmoe.forward_cached(model, torch.zeros(1, 1, dtype=torch.int32),
                            mixed, (None, None),
                            positions=torch.zeros(1, 1, dtype=torch.int32))


def test_init_weights_in_place(models):
    _, _, tcfg, _, _ = models
    cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    a = Qwen3MoEForCausalLM(cfg, device="cpu").init_weights_(
        torch.Generator().manual_seed(4))
    b = Qwen3MoEForCausalLM(cfg, device="cpu").init_weights_(
        torch.Generator().manual_seed(4))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        assert torch.isfinite(p.float()).all(), name
    assert a.layers["expert_gate_proj"].dtype == torch.bfloat16
    assert a.layers["router"].dtype == torch.float32
    assert torch.all(a.norm == 1)
    bound = 1 / np.sqrt(KW["hidden_size"])
    assert float(a.layers["expert_up_proj"].float().abs().max()) <= bound
