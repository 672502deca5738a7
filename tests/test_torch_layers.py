"""PyTorch port, model building blocks: the same numpy inputs through the
JAX package's layers and the port's, fp32 at atol/rtol 1e-5 and bf16 at
2e-2 (bf16 rounds at other places in the two frameworks)."""

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
        t.float().numpy(), np.asarray(j, np.float32),
        atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,wshape", [((2, 5, 64), (64,)),
                                          ((2, 5, 4, 16), (16,))])
def test_rms_norm(dtype, shape, wshape):
    rng = np.random.default_rng(0)
    xj, xt = both(rng.standard_normal(shape).astype(np.float32), dtype)
    w = (1.0 + 0.1 * rng.standard_normal(wshape)).astype(np.float32)
    out_j = jlayers.rms_norm(xj, jnp.asarray(w), 1e-6)
    out_t = tlayers.rms_norm(xt, torch.from_numpy(w), 1e-6)
    assert out_t.dtype == xt.dtype
    assert_close(out_j, out_t, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_get_cos_sin_per_slot_positions(dtype):
    positions = np.array([[0, 1, 2, 3], [7, 8, 9, 10], [2047, 2048, 5, 6]],
                         np.int32)
    jdt, tdt = DTYPES[dtype]
    cj, sj = jlayers.get_cos_sin(4, 16, 1e6, dtype=jdt,
                                 positions=jnp.asarray(positions))
    ct, st = tlayers.get_cos_sin(4, 16, 1e6, dtype=tdt,
                                 positions=torch.from_numpy(positions))
    assert ct.shape == (3, 4, 16) and ct.dtype == tdt
    assert_close(cj, ct, dtype)
    assert_close(sj, st, dtype)


def test_get_cos_sin_default_positions():
    cj, sj = jlayers.get_cos_sin(9, 32, 10000.0)
    ct, st = tlayers.get_cos_sin(9, 32, 10000.0)
    assert ct.shape == (9, 32)
    assert_close(cj, ct, "float32")
    assert_close(sj, st, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_slot", [True, False])
def test_apply_rotary_pos_emb(dtype, per_slot):
    rng = np.random.default_rng(1)
    qj, qt = both(rng.standard_normal((2, 4, 3, 16)).astype(np.float32), dtype)
    kj, kt = both(rng.standard_normal((2, 2, 3, 16)).astype(np.float32), dtype)
    if per_slot:
        pos = np.array([[5, 6, 7], [0, 1, 2]], np.int32)
        cj, sj = jlayers.get_cos_sin(3, 16, positions=jnp.asarray(pos))
        ct, st = tlayers.get_cos_sin(3, 16, positions=torch.from_numpy(pos))
    else:
        cj, sj = jlayers.get_cos_sin(3, 16)
        ct, st = tlayers.get_cos_sin(3, 16)
    qrj, krj = jlayers.apply_rotary_pos_emb(qj, kj, cj, sj)
    qrt, krt = tlayers.apply_rotary_pos_emb(qt, kt, ct, st)
    assert qrt.dtype == qt.dtype
    assert_close(qrj, qrt, dtype)
    assert_close(krj, krt, dtype)


@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_repeat_kv(n_rep):
    x = np.random.default_rng(2).standard_normal((2, 2, 5, 8)).astype(
        np.float32)
    out_j = jlayers.repeat_kv(jnp.asarray(x), n_rep)
    out_t = tlayers.repeat_kv(torch.from_numpy(x), n_rep)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 4])
def test_cached_sdpa_attention(dtype, s):
    rng = np.random.default_rng(3)
    qj, qt = both(rng.standard_normal((3, 4, s, 16)).astype(np.float32), dtype)
    kj, kt = both(rng.standard_normal((3, 2, 12, 16)).astype(np.float32), dtype)
    vj, vt = both(rng.standard_normal((3, 2, 12, 16)).astype(np.float32), dtype)
    pos = (np.array([0, 5, 11 - s + 1])[:, None]
           + np.arange(s)[None, :]).astype(np.int32)
    out_j = jlayers.cached_sdpa_attention(qj, kj, vj, jnp.asarray(pos))
    out_t = tlayers.cached_sdpa_attention(qt, kt, vt, torch.from_numpy(pos))
    assert out_t.dtype == qt.dtype
    assert_close(out_j, out_t, dtype)


@pytest.mark.parametrize("mask", [None, [True, False, True]])
@pytest.mark.parametrize("starts", [[0, 3, 6], [2, 9, 12]])
def test_write_kv_cache_in_place(mask, starts):
    """Byte-equal to lax.dynamic_update_slice (clamped starts included),
    masked slots untouched, and the cache written in place."""
    rng = np.random.default_rng(4)
    cache = rng.standard_normal((3, 2, 10, 8)).astype(np.float32)
    new = rng.standard_normal((3, 2, 4, 8)).astype(np.float32)
    st = np.array(starts, np.int32)
    wm = None if mask is None else np.array(mask)
    out_j = jlayers.write_kv_cache(
        jnp.asarray(cache), jnp.asarray(new), jnp.asarray(st),
        None if wm is None else jnp.asarray(wm))
    cache_t = torch.from_numpy(cache.copy())
    ptr = cache_t.data_ptr()
    out_t = tlayers.write_kv_cache(
        cache_t, torch.from_numpy(new), torch.from_numpy(st),
        None if wm is None else torch.from_numpy(wm))
    assert out_t is cache_t and cache_t.data_ptr() == ptr
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    if wm is not None:
        np.testing.assert_array_equal(out_t.numpy()[1], cache[1])


def test_swiglu():
    rng = np.random.default_rng(5)
    g = rng.standard_normal((2, 3, 8)).astype(np.float32)
    u = rng.standard_normal((2, 3, 8)).astype(np.float32)
    out_j = jlayers.swiglu(jnp.asarray(g), jnp.asarray(u))
    out_t = tlayers.swiglu(torch.from_numpy(g), torch.from_numpy(u))
    assert_close(out_j, out_t, "float32")
