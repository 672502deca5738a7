"""PyTorch port, the grouped-MLP op (K5-K7's plain versions and the VJP)
against the JAX package's ``ops/pallas/grouped_mlp.py``.

The same numpy problem (``_problem``'s tiny shapes: E 4, G 2, C 8, H 16,
I 32) goes through the port's ``grouped_swiglu_mlp`` on the CPU, which
runs the kernels' plain versions, and through the JAX op in interpret
mode (bc 4, bi 16: two slot tiles, two I tiles). Counts include 0 and C.
The forward and the gradients of a loss with a DENSE random cotangent
(which reaches the rows past the fill count, so the dO mask matters) agree
to 1e-5 in fp32. The interpret-mode backward is slow, so one case runs it
and the others compare with ``jax.vjp`` of ``masked_grouped_mlp``, the
reference's own check for the Pallas backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.ops.pallas import grouped_mlp as jgm
from scaletorch_tpu_torch.ops import grouped_mlp as tgm

ATOL = 1e-5


def problem(seed=0, e=4, g=2, c=8, h=16, i=32):
    """The reference test's ``_problem``, with counts 0 and C forced."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, g, c, h)).astype(np.float32)
    counts = rng.integers(0, c + 1, size=(e, g)).astype(np.int32)
    counts[0, 0], counts[-1, -1] = 0, c
    wg = (rng.standard_normal((e, h, i)) * 0.1).astype(np.float32)
    wu = (rng.standard_normal((e, h, i)) * 0.1).astype(np.float32)
    wd = (rng.standard_normal((e, i, h)) * 0.1).astype(np.float32)
    dout = np.random.default_rng(seed + 9).standard_normal(
        x.shape).astype(np.float32)
    return (x, counts, wg, wu, wd), dout


def torch_grads(args, dout):
    x, counts, wg, wu, wd = (torch.from_numpy(a) for a in args)
    leaves = [t.requires_grad_() for t in (x, wg, wu, wd)]
    out = tgm.grouped_swiglu_mlp(x, counts, wg, wu, wd)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    return out.detach().numpy(), [g.numpy() for g in grads]


def jax_grads(args, dout, fn):
    x, counts, wg, wu, wd = map(jnp.asarray, args)
    out, vjp = jax.vjp(lambda x, wg, wu, wd: fn(x, counts, wg, wu, wd),
                       x, wg, wu, wd)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def pallas(x, counts, wg, wu, wd):
    return jgm.grouped_swiglu_mlp(x, counts, wg, wu, wd, 4, 16, True)


def test_forward_matches_the_pallas_kernel():
    args, _ = problem()
    want = np.asarray(pallas(*map(jnp.asarray, args)))
    got = tgm.grouped_swiglu_mlp(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    counts = args[1]
    for e in range(counts.shape[0]):
        for g in range(counts.shape[1]):
            assert not got[e, g, counts[e, g]:].any()  # structural zeros
    assert not got[0, 0].any()


def test_vjp_matches_the_pallas_kernels():
    """The Pallas backward (K6, K7) in interpret mode, dense cotangent."""
    args, dout = problem(seed=3)
    out, grads = torch_grads(args, dout)
    want_out, want = jax_grads(args, dout, pallas)
    np.testing.assert_allclose(out, want_out, atol=ATOL, rtol=0)
    for name, a, b in zip(("dx", "dwg", "dwu", "dwd"), grads, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("seed", [1, 2, 5])
def test_vjp_matches_the_masked_reference(seed):
    args, dout = problem(seed=seed)
    out, grads = torch_grads(args, dout)
    want_out, want = jax_grads(args, dout, jgm.masked_grouped_mlp)
    np.testing.assert_allclose(out, want_out, atol=ATOL, rtol=0)
    for name, a, b in zip(("dx", "dwg", "dwu", "dwd"), grads, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=name)


def test_plain_versions_agree_with_their_autograd():
    """K6/K7's plain versions equal autograd through K5's plain version,
    and an expert whose counts are all 0 gets zero weight gradients."""
    args, dout = problem(seed=6)
    args[1][1] = 0
    x, counts, wg, wu, wd = (torch.from_numpy(a) for a in args)
    leaves = [t.clone().requires_grad_() for t in (x, wg, wu, wd)]
    out = tgm.masked_grouped_mlp(leaves[0], counts, *leaves[1:])
    auto = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    d = torch.from_numpy(dout)
    dx = tgm.grouped_mlp_dx(x, counts, wg, wu, wd, d)
    dws = tgm.grouped_mlp_dw(x, counts, wg, wu, wd, d)
    for a, b in zip((dx, *dws), auto):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)
    assert all(not w[1].any() for w in dws)


def test_bf16_rounds_h_like_the_kernel():
    """In bf16 the plain version rounds h to bf16 before the down product
    (the TPU kernel's ``.astype(x.dtype)``), nowhere else."""
    args, _ = problem(seed=7)
    x, counts, wg, wu, wd = (torch.from_numpy(a).to(torch.bfloat16)
                             if a.dtype == np.float32 else torch.from_numpy(a)
                             for a in args)
    got = tgm.grouped_swiglu_mlp(x, counts, wg, wu, wd)
    assert got.dtype == torch.bfloat16
    mask = (torch.arange(8)[None, None] < counts[..., None])[..., None]
    xf = torch.where(mask, x.float(), 0.0)
    h = (torch.nn.functional.silu(xf @ wg.float()[:, None])
         * (xf @ wu.float()[:, None])).to(torch.bfloat16)
    want = torch.where(mask, h.float() @ wd.float()[:, None], 0.0)
    assert torch.equal(got, want.to(torch.bfloat16))


def test_slot_fill_counts_match():
    disp = np.zeros((2, 4, 3, 2), np.float32)
    disp[0, 0, 1, 0] = 1
    disp[0, 2, 1, 1] = 1
    disp[1, 3, 2, 0] = 1
    got = tgm.slot_fill_counts(torch.from_numpy(disp))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jgm.slot_fill_counts(jnp.asarray(disp))))
    assert got.dtype == torch.int32


def test_wrappers_check_what_the_kernels_take():
    args, _ = problem()
    x, counts, wg, wu, wd = (torch.from_numpy(a) for a in args)
    with pytest.raises(ValueError, match="multiples of 64"):
        tgm._check(x, counts, wg, wu, wd)
    with pytest.raises(TypeError, match="int32"):
        tgm._check(x, counts.long(), wg, wu, wd)
    with pytest.raises(ValueError, match="wd is"):
        tgm._check(x, counts, wg, wu, wd.transpose(1, 2))
