"""PyTorch port, flash attention on the CPU: ``ops/flash.py`` against the
Pallas kernels of the JAX package run in interpret mode.

On a CPU tensor the port's wrappers compute the kernels' plain versions
(``flash_forward_ref``, ``flash_dq_ref``, ``flash_dkv_ref``); the same
numpy inputs go through ``pallas_flash_attention(..., interpret=True)``
and its ``jax.vjp``, and through ``flash_forward_with_lse`` /
``flash_block_backward``. The sequence (96) is not a multiple of the
preferred Pallas block (64), so ``_pick_block`` halves it to 32.

Tolerances: fp32 max abs 2e-5 on the output, the LSE and the gradients
(the two sum in another order; the largest difference seen is 4e-6).
bf16 relative L2 norm 1e-2 (a probability on the other side of a bf16
rounding step moves by one bf16 ulp, 2^-8 relative, in a few entries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scaletorch_tpu_torch.models  # noqa: F401  (registers the backends)
from scaletorch_tpu.models import registry as jregistry
from scaletorch_tpu.ops.pallas import flash as jflash
from scaletorch_tpu_torch.models import registry as tregistry
from scaletorch_tpu_torch.ops import _build
from scaletorch_tpu_torch.ops import flash as tflash

B, HKV, S, D = 1, 2, 96, 64
BLOCK = 64  # the preferred Pallas tile: 96 % 64 != 0, so it halves to 32
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
FP32_ABS = 2e-5
BF16_REL = 1e-2


def arrays(n_rep, seed=0, s_kv=S):
    rng = np.random.default_rng(seed + n_rep)
    q = rng.standard_normal((B, HKV * n_rep, S, D)).astype(np.float32)
    k = rng.standard_normal((B, HKV, s_kv, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, s_kv, D)).astype(np.float32)
    g = rng.standard_normal((B, HKV * n_rep, S, D)).astype(np.float32)
    return q, k, v, g


def to_jax(a, jdt):
    return jnp.asarray(a, dtype=jdt)


def to_torch(x, tdt):
    """A JAX array as a torch tensor of the same values (exact: the bf16
    values are representable in fp32)."""
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(tdt)


def assert_close(t, j, tdt, what):
    got = t.detach().float().numpy()
    want = np.asarray(jnp.asarray(j, jnp.float32))
    if tdt == torch.float32:
        err = float(np.abs(got - want).max())
        assert err <= FP32_ABS, f"{what}: max abs {err} > {FP32_ABS}"
    else:
        err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert err <= BF16_REL, f"{what}: relative {err} > {BF16_REL}"


def pallas(q, k, v, causal):
    return jflash.pallas_flash_attention(q, k, v, causal=causal,
                                         block_q=BLOCK, block_kv=BLOCK,
                                         interpret=True)


@pytest.mark.parametrize("n_rep", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_and_grads_match_pallas(dtype, causal, n_rep):
    jdt, tdt = DTYPES[dtype]
    jq, jk, jv, jg = (to_jax(a, jdt) for a in arrays(n_rep))
    out, vjp = jax.vjp(lambda a, b, c: pallas(a, b, c, causal), jq, jk, jv)
    dq, dk, dv = vjp(jg)
    tq, tk, tv = (to_torch(x, tdt).requires_grad_() for x in (jq, jk, jv))
    tout = tflash.flash_attention(tq, tk, tv, causal=causal)
    tout.backward(to_torch(jg, tdt))
    assert tout.dtype == tdt and tq.grad.dtype == tdt
    assert tk.grad.shape == tk.shape  # unexpanded [B, Hkv, S, D]
    assert_close(tout, out, tdt, "out")
    assert_close(tq.grad, dq, tdt, "dq")
    assert_close(tk.grad, dk, tdt, "dk")
    assert_close(tv.grad, dv, tdt, "dv")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_forward_with_lse_matches_pallas(causal):
    jq, jk, jv, _ = (jnp.asarray(a) for a in arrays(2))
    out, lse = jflash.flash_forward_with_lse(
        jq, jk, jv, causal=causal, block_q=BLOCK, block_kv=BLOCK,
        interpret=True)
    tq, tk, tv = (to_torch(x, torch.float32) for x in (jq, jk, jv))
    tout, tlse = tflash.flash_forward_with_lse(tq, tk, tv, causal=causal)
    assert tlse.shape == (B, 2 * HKV, S) and tlse.dtype == torch.float32
    assert_close(tout, out, torch.float32, "out")
    assert_close(tlse, lse, torch.float32, "lse")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_block_backward_matches_pallas(causal):
    """One key block (the first half of the keys) against the GLOBAL
    (out, lse) of the whole sequence, as ring attention calls it."""
    jq, jk, jv, jg = (jnp.asarray(a) for a in arrays(4))
    out, lse = jflash.flash_forward_with_lse(
        jq, jk, jv, causal=causal, block_q=BLOCK, block_kv=BLOCK,
        interpret=True)
    half = S // 2
    jkb, jvb = jk[:, :, :half], jv[:, :, :half]
    want = jflash.flash_block_backward(
        jq, jkb, jvb, out, lse, jg, causal=causal, block_q=BLOCK,
        block_kv=BLOCK, interpret=True)
    t = [to_torch(x, torch.float32) for x in (jq, jkb, jvb, out, lse, jg)]
    got = tflash.flash_block_backward(*t, causal=causal)
    assert got[1].shape == (B, HKV, half, D)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert_close(a, b, torch.float32, name)


@pytest.mark.parametrize("seq,preferred", [
    (96, 64), (8192, 512), (1000, 512), (7, 4), (1, 512), (200, 64)])
def test_pick_block_is_the_reference_rule(seq, preferred):
    assert tflash._pick_block(seq, preferred) == jflash._pick_block(
        seq, preferred)


def test_cpu_tensors_launch_no_kernel():
    tq, tk, tv, tg = (torch.from_numpy(a) for a in arrays(2))
    tq.requires_grad_()
    before = dict(_build.launch_counts)
    tflash.flash_attention(tq, tk, tv, causal=True).backward(tg)
    assert dict(_build.launch_counts) == before


def test_plain_versions_chunk_the_query_rows(monkeypatch):
    """The plain versions give the same numbers, to fp32 rounding, whether
    they hold all the scores at once or one query chunk at a time (as they
    do on the card at S = 8192)."""
    q, k, v, g = (torch.from_numpy(a) for a in arrays(2))
    whole = tflash.flash_forward_ref(q, k, v, causal=True)
    lse, delta = whole[1], tflash.attention_delta(whole[0], g)
    whole_bwd = (tflash.flash_dq_ref(q, k, v, g, lse, delta, causal=True),
                 *tflash.flash_dkv_ref(q, k, v, g, lse, delta, causal=True))
    # room for 24 rows of fp32 scores: four chunks
    monkeypatch.setattr(tflash, "_REF_CHUNK_BYTES", 24 * 4 * B * 2 * HKV * S)
    assert len(list(tflash._query_chunks(q, k))) == 4
    chunked = tflash.flash_forward_ref(q, k, v, causal=True)
    chunked_bwd = (tflash.flash_dq_ref(q, k, v, g, lse, delta, causal=True),
                   *tflash.flash_dkv_ref(q, k, v, g, lse, delta, causal=True))
    for a, b in zip(whole + whole_bwd, chunked + chunked_bwd):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_gqa_mismatch_raises_like_the_reference():
    q, k, v, _ = arrays(2)
    with pytest.raises(ValueError, match="not a multiple"):
        jflash.pallas_flash_attention(
            jnp.asarray(q[:, :3]), jnp.asarray(k), jnp.asarray(v),
            interpret=True)
    with pytest.raises(ValueError, match="not a multiple"):
        tflash.flash_attention(torch.from_numpy(q[:, :3]),
                               torch.from_numpy(k), torch.from_numpy(v))


@pytest.mark.parametrize("env", [
    {}, {"FLASH_ATTEN": "0"}, {"SCALETORCH_TPU_DISABLE_PALLAS": "1"},
    {"CONTEXT_PARALLEL": "true"}, {"FLASH_ATTEN": "yes"}])
@pytest.mark.parametrize("requested", ["auto", "sdpa"])
def test_backend_resolution_matches_the_reference(monkeypatch, env,
                                                  requested):
    for name in ("FLASH_ATTEN", "CONTEXT_PARALLEL",
                 "SCALETORCH_TPU_DISABLE_PALLAS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert tregistry.resolve_attention_backend(requested) == \
        jregistry.resolve_attention_backend(requested)


def test_flash_and_sdpa_backends_are_registered():
    q, k, v, _ = (torch.from_numpy(a) for a in arrays(2))
    flash = tregistry.get_attention_backend("flash")(q, k, v, causal=True)
    sdpa = tregistry.get_attention_backend("sdpa")(q, k, v, causal=True)
    torch.testing.assert_close(flash, sdpa, atol=2e-5, rtol=0)
    with pytest.raises(KeyError, match="not registered"):
        tregistry.get_attention_backend("no_such_backend")
