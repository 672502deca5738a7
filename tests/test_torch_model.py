"""PyTorch port, the decoder's cached forward: JAX parameters carried across
with ``load_numpy_params``, the same tokens through both packages'
``forward_cached`` (prefill and decode), ``teacher_forced_decode`` and
``teacher_forced_decode_paged``; fp32 at atol/rtol 1e-4, for a Qwen3
variant (qk_norm, tied head) and a Llama variant (no qk_norm, untied).
Inside the port the paged gather path is bit-identical to the dense
layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.inference import decode as jdecode
from scaletorch_tpu.inference.kv_cache import init_kv_cache as j_init_kv_cache
from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.models import presets as jpresets
from scaletorch_tpu.models import qwen3_moe as jqwen3_moe
from scaletorch_tpu_torch.inference import decode as tdecode
from scaletorch_tpu_torch.inference.kv_cache import init_kv_cache
from scaletorch_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    Qwen3Config,
    init_params,
    load_numpy_params,
    model_config,
)
from scaletorch_tpu_torch.models import presets as tpresets

TOL = 1e-4
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, max_position_embeddings=256)
VARIANTS = {
    "qwen3": dict(qk_norm=True, tie_word_embeddings=True, rope_theta=1e6),
    "llama": dict(qk_norm=False, tie_word_embeddings=False),
}


def configs(variant):
    kw = {**SMALL, **VARIANTS[variant]}
    return (jllama.LlamaConfig(**kw, dtype=jnp.float32),
            LlamaConfig(**kw, dtype=torch.float32))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    """(jax cfg, jax params, port cfg, port model) sharing one draw."""
    jcfg, tcfg = configs(request.param)
    params = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    model = LlamaForCausalLM(tcfg, device="cpu")
    load_numpy_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, tcfg, model


def tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)


def close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j),
                               atol=TOL, rtol=TOL)


def test_forward_cached_prefill_then_decode(pair):
    jcfg, params, tcfg, model = pair
    toks = tokens(2, 7)
    mask = np.array([True, False])
    jcache = tuple(j_init_kv_cache(jcfg, 2, 16, dtype=jnp.float32))
    tcache = tuple(init_kv_cache(tcfg, 2, 16, device="cpu"))
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    lj, jcache = jllama.forward_cached(
        params, jnp.asarray(toks), jcfg, jcache, positions=jnp.asarray(pos),
        write_mask=jnp.asarray(mask))
    lt, tcache = model.forward_cached(
        torch.from_numpy(toks), tcache, positions=torch.from_numpy(pos.copy()),
        write_mask=torch.from_numpy(mask))
    close(lt, lj)
    close(tcache[0], jcache[0])
    close(tcache[1], jcache[1])
    # one decode step at per-slot positions
    step = tokens(2, 1, seed=1)
    dpos = np.array([[7], [3]], np.int32)
    lj, jcache = jllama.forward_cached(
        params, jnp.asarray(step), jcfg, jcache, positions=jnp.asarray(dpos))
    lt, tcache = model.forward_cached(
        torch.from_numpy(step), tcache, positions=torch.from_numpy(dpos))
    close(lt, lj)
    close(tcache[0], jcache[0])


def test_last_index_keeps_the_sampled_rows(pair):
    _, _, tcfg, model = pair
    toks = torch.from_numpy(tokens(3, 6, seed=2))
    pos = torch.arange(6, dtype=torch.int32).expand(3, 6)
    last = torch.tensor([5, 0, 3])
    full, _ = model.forward_cached(
        toks, tuple(init_kv_cache(tcfg, 3, 8, device="cpu")), positions=pos)
    rows, _ = model.forward_cached(
        toks, tuple(init_kv_cache(tcfg, 3, 8, device="cpu")), positions=pos,
        last_index=last)
    assert rows.shape == (3, 1, tcfg.vocab_size)
    np.testing.assert_allclose(rows[:, 0].numpy(),
                               full[torch.arange(3), last].numpy(),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("prefill_len", [1, 5])
def test_teacher_forced_decode_matches_jax(pair, prefill_len):
    jcfg, params, tcfg, model = pair
    toks = tokens(2, 9, seed=3)
    lj = jdecode.teacher_forced_decode(params, jcfg, jnp.asarray(toks),
                                       max_seq=16, prefill_len=prefill_len)
    lt = tdecode.teacher_forced_decode(model, tcfg, torch.from_numpy(toks),
                                       max_seq=16, prefill_len=prefill_len)
    close(lt, lj)


@pytest.mark.parametrize("page_size", [3])  # 14 % 3 != 0: the crop bites
def test_teacher_forced_decode_paged_matches_jax_and_dense(pair, page_size):
    jcfg, params, tcfg, model = pair
    toks = tokens(2, 10, seed=4)
    lj = jdecode.teacher_forced_decode_paged(
        params, jcfg, jnp.asarray(toks), page_size=page_size, max_seq=14,
        prefill_len=3)
    paged = tdecode.teacher_forced_decode_paged(
        model, tcfg, torch.from_numpy(toks), page_size=page_size, max_seq=14,
        prefill_len=3)
    dense = tdecode.teacher_forced_decode(
        model, tcfg, torch.from_numpy(toks), max_seq=14, prefill_len=3)
    close(paged, lj)
    # the bit-identity contract: the gather path's crop to max_seq gives
    # the dense layout's operand shapes
    assert torch.equal(paged, dense)


def test_init_params_matches_the_reference_layout():
    jcfg, tcfg = configs("llama")
    jp = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    gen = torch.Generator().manual_seed(0)
    tp = init_params(tcfg, gen, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        keys = [k.key for k in path]
        t = tp
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
    bound = 1.0 / np.sqrt(tcfg.hidden_size)
    assert float(tp["layers"]["q_proj"].abs().max()) <= bound
    assert torch.equal(tp["norm"], torch.ones(tcfg.hidden_size))
    assert abs(float(tp["embed_tokens"].std()) - 0.02) < 0.002
    again = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["lm_head"], tp["lm_head"])


def test_model_holds_compute_dtype_weights_and_fp32_norms():
    kw = {**SMALL, **VARIANTS["qwen3"]}
    cfg = LlamaConfig(**kw, dtype=torch.bfloat16)
    params = init_params(cfg, device="cpu")
    model = LlamaForCausalLM.from_params(params, cfg, device="cpu")
    assert model.layers["q_proj"].dtype == torch.bfloat16
    assert model.layers["q_norm"].dtype == torch.float32
    assert model.lm_head is None
    assert torch.equal(model.lm_head_weight(),
                       params["embed_tokens"].to(torch.bfloat16).T)
    assert sum(p.numel() for p in model.parameters()) == cfg.num_params()


def test_load_numpy_params_rejects_mismatches():
    jcfg, tcfg = configs("qwen3")
    params = jax.tree.map(np.asarray,
                          jllama.init_params(jax.random.PRNGKey(0), jcfg))
    model = LlamaForCausalLM(tcfg, device="cpu")
    bad = dict(params, lm_head=np.zeros((64, 128), np.float32))
    with pytest.raises(KeyError, match="lm_head"):
        load_numpy_params(model, bad)
    bad = dict(params, norm=np.zeros((65,), np.float32))
    with pytest.raises(ValueError, match="norm"):
        load_numpy_params(model, bad)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the error path is for hosts without")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(configs("llama")[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(configs("llama")[1])


def test_moe_configs_have_no_port_forward():
    """The JAX package's MoE config has no port forward; the port's own
    MoE config (from the same preset) has the MoE one."""
    from scaletorch_tpu_torch.models import qwen3_moe as tqwen3_moe

    cfg = jqwen3_moe.Qwen3MoEConfig(**{**SMALL, "num_experts": 4})
    with pytest.raises(TypeError, match="Llama family"):
        tdecode.resolve_forward_cached(cfg)
    tcfg = model_config("moe-tiny")
    assert isinstance(tcfg, tqwen3_moe.Qwen3MoEConfig)
    assert tdecode.resolve_forward_cached(tcfg) is tqwen3_moe.forward_cached


def test_presets_are_a_copy_of_the_reference():
    assert tpresets.MODEL_PRESETS == jpresets.MODEL_PRESETS
    cfg = model_config("qwen3-0.6b")
    assert cfg == Qwen3Config(max_position_embeddings=40960)
    assert model_config("dense-tiny", num_hidden_layers=2).num_hidden_layers == 2
