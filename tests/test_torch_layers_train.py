"""PyTorch port, the training half of the model building blocks: values and
gradients of ``rms_norm``, ``swiglu``, ``cross_entropy_loss``,
``sdpa_attention`` and ``sdpa_attention_with_lse`` against ``jax.vjp`` of
the JAX package's functions on the same numpy inputs and cotangents.

Tolerances: fp32 atol/rtol 1e-5 (the two frameworks sum in another
order); bf16 atol/rtol 2e-2 (bf16 rounds the outputs and the cotangents
at one ulp, 2^-8 relative). The custom backward passes must also keep
the reference's memory contract: they save only their original-dtype
inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.models import layers as jlayers
from scaletorch_tpu_torch.models import layers as tlayers

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both(x: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(np.array(x)).to(tdt)


def assert_close(j, t, dtype):
    np.testing.assert_allclose(
        t.detach().float().numpy(), np.asarray(j, np.float32),
        atol=TOL[dtype], rtol=TOL[dtype])


def saved_dtypes(fn, *args):
    """dtypes of the tensors autograd saves for ``fn(*args)``'s backward."""
    saved = []

    def pack(t):
        saved.append(t.dtype)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*args)
    return saved


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,wshape", [((2, 5, 64), (64,)),
                                          ((2, 5, 4, 16), (16,))],
                         ids=["hidden", "per_head"])
def test_rms_norm_value_and_grads(dtype, shape, wshape):
    rng = np.random.default_rng(1)
    xj, xt = both(rng.standard_normal(shape).astype(np.float32), dtype)
    gj, gt = both(rng.standard_normal(shape).astype(np.float32), dtype)
    w = (1.0 + 0.1 * rng.standard_normal(wshape)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda x, w_: jlayers.rms_norm(x, w_, 1e-6), xj,
                         jnp.asarray(w))
    dx_j, dw_j = vjp(gj)
    xt.requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out_t = tlayers.rms_norm(xt, wt, 1e-6)
    out_t.backward(gt)
    assert out_t.dtype == xt.dtype and xt.grad.dtype == xt.dtype
    assert wt.grad.shape == wshape and wt.grad.dtype == torch.float32
    assert_close(out_j, out_t, dtype)
    assert_close(dx_j, xt.grad, dtype)
    # dw sums over every leading axis: compare relative to its size
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j),
                               atol=TOL[dtype] * 10, rtol=TOL[dtype])


def test_rms_norm_saves_only_its_inputs():
    x = torch.randn(2, 3, 8, dtype=torch.bfloat16, requires_grad=True)
    w = torch.ones(8, requires_grad=True)
    assert saved_dtypes(tlayers.rms_norm, x, w) == [torch.bfloat16,
                                                    torch.float32]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_value_and_grads(dtype):
    rng = np.random.default_rng(2)
    shape = (2, 5, 48)
    gate_j, gate_t = both(3 * rng.standard_normal(shape).astype(np.float32),
                          dtype)
    up_j, up_t = both(rng.standard_normal(shape).astype(np.float32), dtype)
    ct_j, ct_t = both(rng.standard_normal(shape).astype(np.float32), dtype)
    out_j, vjp = jax.vjp(jlayers.swiglu, gate_j, up_j)
    dgate_j, dup_j = vjp(ct_j)
    gate_t.requires_grad_()
    up_t.requires_grad_()
    out_t = tlayers.swiglu(gate_t, up_t)
    out_t.backward(ct_t)
    assert out_t.dtype == gate_t.dtype
    assert_close(out_j, out_t, dtype)
    assert_close(dgate_j, gate_t.grad, dtype)
    assert_close(dup_j, up_t.grad, dtype)


def test_swiglu_saves_only_gate_and_up():
    gate = torch.randn(4, 8, dtype=torch.bfloat16, requires_grad=True)
    up = torch.randn(4, 8, dtype=torch.bfloat16, requires_grad=True)
    assert saved_dtypes(tlayers.swiglu, gate, up) == [torch.bfloat16] * 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ignored", [0, 3, 10], ids=lambda n: f"ignore{n}")
def test_cross_entropy_value_and_grads(dtype, ignored):
    rng = np.random.default_rng(3 + ignored)
    vocab = 37
    logits = 2 * rng.standard_normal((2, 5, vocab)).astype(np.float32)
    targets = rng.integers(0, vocab, (2, 5)).astype(np.int32)
    targets.reshape(-1)[:ignored] = -100
    lj, lt = both(logits, dtype)
    loss_j, vjp = jax.vjp(
        lambda x: jlayers.cross_entropy_loss(x, jnp.asarray(targets)), lj)
    (dl_j,) = vjp(jnp.float32(1.0))
    lt.requires_grad_()
    loss_t = tlayers.cross_entropy_loss(lt, torch.from_numpy(targets))
    loss_t.backward()
    assert loss_t.dtype == torch.float32
    # every token ignored: the loss is 0, the count is clamped to 1
    assert_close(loss_j, loss_t, dtype)
    assert_close(dl_j, lt.grad, dtype)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sq,skv", [(12, 12), (5, 12)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_attention_value_and_grads(dtype, sq, skv, causal):
    rng = np.random.default_rng(4)
    qj, qt = both(rng.standard_normal((2, 4, sq, 16)).astype(np.float32),
                  dtype)
    kj, kt = both(rng.standard_normal((2, 2, skv, 16)).astype(np.float32),
                  dtype)
    vj, vt = both(rng.standard_normal((2, 2, skv, 16)).astype(np.float32),
                  dtype)
    gj, gt = both(rng.standard_normal((2, 4, sq, 16)).astype(np.float32),
                  dtype)
    out_j, vjp = jax.vjp(
        lambda q, k, v: jlayers.sdpa_attention(q, k, v, causal=causal),
        qj, kj, vj)
    grads_j = vjp(gj)
    leaves = [t.requires_grad_() for t in (qt, kt, vt)]
    out_t = tlayers.sdpa_attention(*leaves, causal=causal)
    out_t.backward(gt)
    assert out_t.dtype == qt.dtype
    assert_close(out_j, out_t, dtype)
    for gj_, leaf in zip(grads_j, leaves):
        assert_close(gj_, leaf.grad, dtype)


@pytest.mark.parametrize("sq,skv", [(8, 8), (4, 8), (8, 4)],
                         ids=["square", "short_q", "masked_rows"])
def test_sdpa_attention_with_lse(sq, skv):
    """``masked_rows``: with more queries than keys, the first rows see no
    key: lse -inf and output 0 in both packages."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 4, sq, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, skv, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, skv, 16)).astype(np.float32)
    out_j, lse_j = jlayers.sdpa_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    out_t, lse_t = tlayers.sdpa_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True)
    assert_close(out_j, out_t, "float32")
    lse_j = np.asarray(lse_j)
    np.testing.assert_array_equal(np.isinf(lse_t.numpy()), np.isinf(lse_j))
    finite = np.isfinite(lse_j)
    np.testing.assert_allclose(lse_t.numpy()[finite], lse_j[finite],
                               atol=1e-5, rtol=1e-5)
    if sq > skv:
        assert not finite.all() and bool((out_t[~torch.from_numpy(finite)]
                                          == 0).all())
