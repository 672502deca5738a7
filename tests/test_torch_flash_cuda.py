"""PyTorch port, the hand-written CUDA flash-attention kernels on the card.

K1 (forward), K2 (dQ) and K3 (dK, dV) against their plain PyTorch
versions on the same inputs, at head_dim 64 and 128, n_rep 1, 2, 4 and 8
(Qwen3-30B-A3B's 32 query over 4 KV heads), fp32 and bf16, causal and not, with a sequence that is a multiple of the
kernels' 64-row tiles and one that is not. Every test needs a CUDA card
and skips without one (decided in a fixture, at run time). The file
imports no JAX, so it runs on the GPU machine, where the repository's
conftest (which sets JAX up) cannot load:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_flash_cuda.py

Tolerances, the limits of chip_smoke.py's kernel_flash phase: max abs of
the output and the LSE; relative L2 error of the output and of each
gradient; and the largest relative L2 error of one 64-row tile of one
head, where a fault confined to one tile shows. fp32: the kernels sum in
another order than the plain versions. bf16: a probability or dS that
lands on the other side of a bf16 rounding step moves by one bf16 ulp.
"""

import pytest
import torch
import torch.nn.functional as F

from scaletorch_tpu_torch.ops import _build
from scaletorch_tpu_torch.ops import flash as tf

pytestmark = pytest.mark.cuda

OUT_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-4}
OUT_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-3}
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
OUT_TILE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
GRAD_TILE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1.5e-3}
TILE = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels are CUDA C++ built "
                    "with nvcc for sm_90a and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(dev, dtype, head_dim, n_rep, seq, b=2, hkv=2, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 100 * n_rep + head_dim + seq)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    q = rnd(b, hkv * n_rep, seq, head_dim)
    k = rnd(b, hkv, seq, head_dim)
    v = rnd(b, hkv, seq, head_dim)
    dout = rnd(b, hkv * n_rep, seq, head_dim)
    return q, k, v, dout


def rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def tile_rel(a, b):
    """The largest relative L2 error of one TILE-row tile of one head."""
    batch, heads, seq, _ = b.shape

    def per_tile(x):
        rows = F.pad(x.float().square().sum(-1), (0, (-seq) % TILE))
        return rows.view(batch, heads, -1, TILE).sum(-1)

    return float((per_tile(a.float() - b.float()) / per_tile(b)).sqrt().max())


def assert_close(dtype, got, want, *, out=False):
    got = got.detach()
    if out:
        assert float((got.float() - want.float()).abs().max()) <= OUT_TOL[dtype]
    assert rel(got, want) <= (OUT_REL_TOL if out else GRAD_TOL)[dtype]
    assert tile_rel(got, want) <= (OUT_TILE_TOL if out
                                   else GRAD_TILE_TOL)[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("seq", [256, 200])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_kernels_match_plain_versions(cuda, dtype, head_dim, n_rep, seq,
                                      causal):
    q, k, v, dout = inputs(cuda, dtype, head_dim, n_rep, seq)
    before = dict(_build.launch_counts)
    out, lse = tf.flash_forward(q, k, v, causal=causal)
    ref_out, ref_lse = tf.flash_forward_ref(q, k, v, causal=causal)
    delta = tf.attention_delta(ref_out, dout)
    dq = tf.flash_dq(q, k, v, dout, ref_lse, delta, causal=causal)
    dk, dv = tf.flash_dkv(q, k, v, dout, ref_lse, delta, causal=causal)
    ref_dq = tf.flash_dq_ref(q, k, v, dout, ref_lse, delta, causal=causal)
    ref_dk, ref_dv = tf.flash_dkv_ref(q, k, v, dout, ref_lse, delta,
                                      causal=causal)
    torch.cuda.synchronize()
    for name in (tf.K1_NAME, tf.K2_NAME, tf.K3_NAME):
        assert _build.launch_counts[name] == before.get(name, 0) + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    assert dk.shape == k.shape and dv.shape == v.shape
    for t in (out, lse, dq, dk, dv):
        assert torch.isfinite(t).all()
    assert_close(dtype, out, ref_out, out=True)
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL[dtype]
    assert_close(dtype, dq, ref_dq)
    assert_close(dtype, dk, ref_dk)
    assert_close(dtype, dv, ref_dv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_autograd_runs_the_three_kernels(cuda, dtype):
    q, k, v, dout = inputs(cuda, dtype, 128, 2, 192)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    _build.reset_launch_counts()
    out = tf.flash_attention(*leaves, causal=True)
    out.backward(dout)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {
        tf.K1_NAME: 1, tf.K2_NAME: 1, tf.K3_NAME: 1}
    ref_out, _ = tf.flash_forward_ref(q, k, v, causal=True)
    assert_close(dtype, out, ref_out, out=True)
    # the backward's plain versions from the statistics the VJP saved
    saved_out, saved_lse = tf.flash_forward(q, k, v, causal=True)
    delta = tf.attention_delta(saved_out, dout)
    ref_dq = tf.flash_dq_ref(q, k, v, dout, saved_lse, delta, causal=True)
    ref_dk, ref_dv = tf.flash_dkv_ref(q, k, v, dout, saved_lse, delta,
                                      causal=True)
    for got, want in zip((l.grad for l in leaves), (ref_dq, ref_dk, ref_dv)):
        assert_close(dtype, got, want)


def test_transposed_inputs_are_made_contiguous(cuda):
    q, k, v, _ = inputs(cuda, torch.bfloat16, 64, 2, 128)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)  # a strided view
    out, _ = tf.flash_forward(qt, k, v, causal=True)
    ref, _ = tf.flash_forward_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert_close(torch.bfloat16, out, ref, out=True)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_block_backward_against_a_global_statistic(cuda, causal):
    """Two key blocks: the block gradients against the merged (out, lse)
    add up to the whole sequence's gradients."""
    q, k, v, dout = inputs(cuda, torch.float32, 128, 2, 256)
    out, lse = tf.flash_forward_with_lse(q, k, v, causal=causal)
    whole = tf.flash_block_backward(q, k, v, out, lse, dout, causal=causal)
    # the second key block seen by the second query half, without a mask
    h = 128
    qb, kb, vb = q[:, :, h:], k[:, :, :h], v[:, :, :h]
    part = tf.flash_block_backward(qb, kb, vb, out[:, :, h:],
                                   lse[:, :, h:].contiguous(),
                                   dout[:, :, h:], causal=False)
    ref = tf.flash_dq_ref(qb, kb, vb, dout[:, :, h:], lse[:, :, h:],
                          tf.attention_delta(out[:, :, h:], dout[:, :, h:]),
                          causal=False)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in whole + part)
    assert_close(torch.float32, part[0], ref)


def test_unsupported_inputs_raise_before_launch(cuda):
    q, k, v, _ = inputs(cuda, torch.float32, 64, 2, 64)
    with pytest.raises(ValueError, match="head_dim"):
        tf.flash_forward(q[..., :32], k[..., :32], v[..., :32], causal=True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tf.flash_forward(q.half(), k.half(), v.half(), causal=True)
    with pytest.raises(TypeError, match="want"):
        tf.flash_forward(q, k.bfloat16(), v, causal=True)
