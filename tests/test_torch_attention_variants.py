"""PyTorch port, the attention-variant library (``models/attention``) and
MLA's latent cache against the JAX package.

  * MHA, MQA, GQA and MLA (with and without ``q_lora_rank``) on the same
    parameters (``models/convert.attention_from_jax``) and inputs:
    <= 1e-5, causal and not;
  * the reference's own checks: GQA with every head equals MHA,
    causality, config validation, MQA's kv-parameter saving, MLA's
    q_lora projections;
  * MLA ``prefill`` + ``decode`` against the JAX ones and the full
    forward (within the reference's ``ATOL`` 2e-5);
  * ``init_mla_cache`` and the GPT-MoE ``kv_cache_shape`` against the
    JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.inference import kv_cache as jkv
from scaletorch_tpu.models import attention as jatt
from scaletorch_tpu.models import gpt_moe as jg
from scaletorch_tpu_torch.inference import kv_cache as tkv
from scaletorch_tpu_torch.models import attention as tatt
from scaletorch_tpu_torch.models import gpt_moe as tg
from scaletorch_tpu_torch.models.convert import attention_from_jax

TOL = 1e-5
ATOL = 2e-5  # tests/inference/test_decode_parity.py's
VARIANTS = ["MultiHeadAttention", "MultiQueryAttention",
            "GroupQueryAttention", "MultiHeadLatentAttention"]
CFG = dict(embed_dim=64, num_heads=8, num_kv_heads=2, kv_lora_rank=16)


def pair(name, **kw):
    kw = {**CFG, **kw}
    jcls, tcls = getattr(jatt, name), getattr(tatt, name)
    jattn = jcls(jatt.AttentionConfig(**kw))
    params = jattn.init(jax.random.PRNGKey(0))
    tattn = tcls(tatt.AttentionConfig(**kw))
    return jattn, params, tattn, attention_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")


def inputs(seed, b=2, s=10, d=64):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name,extra", [(n, {}) for n in VARIANTS]
                         + [("MultiHeadLatentAttention",
                             {"q_lora_rank": 16})])
def test_variant_matches_the_jax_variant(name, extra, causal):
    jattn, jp, tattn, tp = pair(name, **extra)
    x = inputs(1)
    want = np.asarray(jattn(jp, jnp.asarray(x), causal=causal))
    got = tattn(tp, torch.from_numpy(x), causal=causal).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", VARIANTS)
def test_init_shapes_match_the_reference(name):
    jattn, jp, tattn, _ = pair(name, q_lora_rank=None)
    drawn = tattn.init(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in drawn.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    bound = 1 / np.sqrt(64)
    assert float(drawn[next(iter(drawn))].abs().max()) <= bound


def test_gqa_with_all_heads_equals_mha():
    cfg = tatt.AttentionConfig(embed_dim=64, num_heads=8, num_kv_heads=8)
    mha, gqa = tatt.MultiHeadAttention(cfg), tatt.GroupQueryAttention(cfg)
    params = mha.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(inputs(2, s=12))
    torch.testing.assert_close(mha(params, x), gqa(params, x), rtol=1e-6,
                               atol=0)


def test_kv_param_savings():
    cfg = tatt.AttentionConfig(**CFG)
    mha = tatt.MultiHeadAttention(cfg).init(torch.Generator().manual_seed(0),
                                            device="cpu")
    mqa = tatt.MultiQueryAttention(cfg).init(torch.Generator().manual_seed(0),
                                             device="cpu")
    assert mqa["k_proj"].numel() == mha["k_proj"].numel() // 8


def test_causality():
    """Changing a future token must not change earlier outputs."""
    cfg = tatt.AttentionConfig(**CFG)
    attn = tatt.GroupQueryAttention(cfg)
    params = attn.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(inputs(3, b=1, s=8))
    y1 = attn(params, x)
    x2 = x.clone()
    x2[:, -1] = 0.0
    y2 = attn(params, x2)
    torch.testing.assert_close(y1[:, :-1], y2[:, :-1], atol=1e-6, rtol=0)


def test_config_validation():
    with pytest.raises(ValueError, match="not divisible"):
        tatt.AttentionConfig(embed_dim=65, num_heads=8)
    with pytest.raises(ValueError, match="num_kv_heads"):
        tatt.AttentionConfig(embed_dim=64, num_heads=8, num_kv_heads=3)


def test_mla_with_q_lora_has_its_projections():
    cfg = tatt.AttentionConfig(embed_dim=64, num_heads=8, q_lora_rank=16,
                               kv_lora_rank=16)
    attn = tatt.MultiHeadLatentAttention(cfg)
    params = attn.init(torch.Generator().manual_seed(0), device="cpu")
    assert "q_down" in params and "q_up" in params and "q_proj" not in params
    x = torch.from_numpy(inputs(4, s=8))
    assert attn(params, x).shape == x.shape


@pytest.mark.parametrize("q_lora_rank", [None, 16])
def test_mla_latent_cache_decode_matches(q_lora_rank):
    """Prefill 4 tokens, decode 6 one at a time against the latent cache:
    each step equals the JAX step, and the whole equals the full
    forward."""
    kw = dict(embed_dim=64, num_heads=8, kv_lora_rank=16,
              q_lora_rank=q_lora_rank)
    jattn = jatt.MultiHeadLatentAttention(jatt.AttentionConfig(**kw))
    jp = jattn.init(jax.random.PRNGKey(0))
    tattn = tatt.MultiHeadLatentAttention(tatt.AttentionConfig(**kw))
    tp = attention_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = inputs(5)
    full = tattn(tp, torch.from_numpy(x)).numpy()

    jcache = jattn.init_cache(2, 12)
    cache = tattn.init_cache(2, 12, device="cpu")
    assert tuple(cache.shape) == (2, 12, 16)  # latent rank, not 2·H·D
    jout, jcache = jattn.prefill(jp, jnp.asarray(x[:, :4]), jcache)
    out, cache = tattn.prefill(tp, torch.from_numpy(x[:, :4]), cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    outs = [out]
    for t in range(4, 10):
        jo, jcache = jattn.decode(jp, jnp.asarray(x[:, t:t + 1]), jcache,
                                  jnp.full((2,), t))
        o, cache = tattn.decode(tp, torch.from_numpy(x[:, t:t + 1]), cache,
                                torch.full((2,), t))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL)
        outs.append(o)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), atol=ATOL)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full,
                               atol=ATOL)


def test_mla_cache_and_gpt_cache_shapes_match_the_reference():
    jcfg = jatt.AttentionConfig(embed_dim=64, num_heads=8, kv_lora_rank=16)
    tcfg = tatt.AttentionConfig(embed_dim=64, num_heads=8, kv_lora_rank=16)
    want = jkv.init_mla_cache(jcfg, 3, 20)
    got = tkv.init_mla_cache(tcfg, 3, 20, device="cpu")
    assert isinstance(got, tkv.MLACache)
    assert tuple(got.latent.shape) == want.latent.shape == (3, 20, 16)
    assert got.latent.dtype == torch.float32 and not got.latent.any()
    kv_floats = 2 * 8 * 8 * 20  # both buffers, heads, head_dim, seq
    assert got.latent[0].numel() < kv_floats

    shape = dict(block_size=32, vocab_size=65, n_layer=3, n_head=4,
                 n_embd=64)
    jg_cfg, tg_cfg = jg.GPTMoEConfig(**shape), tg.GPTMoEConfig(**shape)
    assert tkv.kv_cache_shape(tg_cfg, 2, 24) == jkv.kv_cache_shape(
        jg_cfg, 2, 24) == (3, 2, 4, 24, 16)
    assert tkv.paged_kv_cache_shape(tg_cfg, 9, 4) == jkv.paged_kv_cache_shape(
        jg_cfg, 9, 4)
    assert tkv.kv_cache_bytes(tg_cfg, 2, 24) == jkv.kv_cache_bytes(
        jg_cfg, 2, 24)
