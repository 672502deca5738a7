"""PyTorch port, the hand-written CUDA flash-attention kernels on the card.

K1 (forward), K2 (dQ) and K3 (dK, dV) against their plain PyTorch
versions on the same inputs, at head_dim 16, 32, 64 and 128 and n_rep 1,
2, 4, 5 and 8 (every preset's geometry: dense-tiny's D 32, qwen3-14b's 40
query over 8 KV heads, Qwen3-30B-A3B's 32 over 4; and the D 16 of the moe,
pipeline and long-context examples), fp32 and bf16, causal and
not, at sequences on both sides of the kernels' 64-row tiles and 32-row
register chunks (1, 63, 127, 129, 200, 256, 1000); Sq != Skv through
``flash_block_backward``; bf16 K1, K2 and K3 at Qwen3-30B-A3B's training
shape; two runs of K2/K3 that must agree bit for bit (no atomics); and
the dQ of one-row tiles against float64, as close as the plain version.
Every test needs a CUDA card and skips without one (decided in a
fixture, at run time). The file imports no JAX, so it runs on the GPU machine, where
the repository's conftest (which sets JAX up) cannot load:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_flash_cuda.py

Tolerances, the limits of chip_smoke.py's kernel_flash phase: max abs of
the output and the LSE; relative L2 error of the output and of each
gradient; and the largest relative L2 error of one 64-row tile of one
head, where a fault confined to one tile shows. fp32: the kernels sum in
another order than the plain versions. bf16: a probability or dS that
lands on the other side of a bf16 rounding step moves by one bf16 ulp.
"""

import json

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
# |dQ|, |dK| where they are exactly 0 (one key); the noise is ~1e-7
ZERO_GRAD_TOL = 1e-5
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
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 5, 8])
@pytest.mark.parametrize("seq", [1, 63, 127, 129, 200, 256, 1000])
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
    if seq == 1:
        # one key: the softmax is constant, so dS, dQ and dK are exactly 0
        # and both sides hold rounding noise, which no relative limit can
        # compare; both are held to 0 instead
        for got in (dq, ref_dq, dk, ref_dk):
            assert float(got.abs().max()) <= ZERO_GRAD_TOL
    else:
        assert_close(dtype, dq, ref_dq)
        assert_close(dtype, dk, ref_dk)
    assert_close(dtype, dv, ref_dv)


def row_rel(a, b):
    """Relative L2 error of each row of [B, H, D] tensors."""
    return (a - b).norm(dim=-1) / b.norm(dim=-1)


@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
def test_single_row_tile_dq_is_as_close_to_float64_as_the_plain_version(
        cuda, head_dim):
    """At S 129 the last 64-row tile of a head holds one query row, and a
    bf16 dQ row carries two roundings to bf16 (dS before its product, the
    output after it) in the kernel and in the plain version alike. Held
    against float64 (dS unrounded), the kernel's rows are as close as the
    plain version's: the mean and the largest relative error of those
    rows within 5% of the plain version's."""
    q, k, v, dout = inputs(cuda, torch.bfloat16, head_dim, 8, 129)
    ref_out, ref_lse = tf.flash_forward_ref(q, k, v, causal=True)
    delta = tf.attention_delta(ref_out, dout)
    args = (q, k, v, dout, ref_lse, delta)
    dq = tf.flash_dq(*args, causal=True)
    dq_ref = tf.flash_dq_ref(*args, causal=True)
    qd, kd, vd, od = (t.double() for t in (q, k, v, dout))
    kd, vd = kd.repeat_interleave(8, 1), vd.repeat_interleave(8, 1)
    scale = head_dim ** -0.5
    s = (qd @ kd.transpose(-1, -2) * scale).masked_fill(
        torch.ones(129, 129, dtype=torch.bool, device=cuda).triu(1), -1e30)
    p = torch.exp(s - ref_lse.double()[..., None])
    ds = p * (od @ vd.transpose(-1, -2) - delta.double()[..., None]) * scale
    exact = (ds @ kd)[:, :, 128]
    torch.cuda.synchronize()
    kernel = row_rel(dq.double()[:, :, 128], exact)
    plain = row_rel(dq_ref.double()[:, :, 128], exact)
    # the one-row tiles' readings (shown with pytest -rP): how far the
    # kernel's rows lie from the plain version's, and in how many elements,
    # by how many bf16 steps of the plain value, they differ
    got, want = dq.double()[:, :, 128], dq_ref.double()[:, :, 128]
    step = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                      - 7)
    print(json.dumps({
        "head_dim": head_dim,
        "kernel_vs_plain_row_rel_max": float(row_rel(got, want).max()),
        "elements_differing": int((got != want).sum()),
        "elements": got.numel(),
        "max_bf16_steps": float(((got - want).abs() / step).max()),
        "kernel_vs_float64_mean_max": [float(kernel.mean()),
                                       float(kernel.max())],
        "plain_vs_float64_mean_max": [float(plain.mean()),
                                      float(plain.max())]}))
    assert float(kernel.mean()) <= 1.05 * float(plain.mean())
    assert float(kernel.max()) <= 1.05 * float(plain.max())


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("split", [128, 100, 200])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_block_backward_against_a_global_statistic(cuda, causal, split,
                                                   dtype):
    """The gradients of one key block (the first ``split`` keys) seen by
    the query rows from ``split`` on, without a mask, against the whole
    sequence's merged (out, lse): Sq = 256 - split and Skv = split differ
    unless split is 128."""
    q, k, v, dout = inputs(cuda, dtype, 128, 2, 256)
    out, lse = tf.flash_forward_with_lse(q, k, v, causal=causal)
    whole = tf.flash_block_backward(q, k, v, out, lse, dout, causal=causal)
    qb, kb, vb = q[:, :, split:], k[:, :, :split], v[:, :, :split]
    ob, lb, dob = out[:, :, split:], lse[:, :, split:].contiguous(), \
        dout[:, :, split:]
    part = tf.flash_block_backward(qb, kb, vb, ob, lb, dob, causal=False)
    delta = tf.attention_delta(ob, dob)
    ref_dq = tf.flash_dq_ref(qb, kb, vb, dob, lb, delta, causal=False)
    ref_dk, ref_dv = tf.flash_dkv_ref(qb, kb, vb, dob, lb, delta,
                                      causal=False)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in whole + part)
    assert part[0].shape == qb.shape and part[1].shape == kb.shape
    for got, want in zip(part, (ref_dq, ref_dk, ref_dv)):
        assert_close(dtype, got, want)


def test_forward_at_the_moe_training_shape(cuda):
    """bf16 K1 at Qwen3-30B-A3B's attention in its training cell (B 1, Hq
    32 over Hkv 4, S 4096, D 128, causal): out and LSE against the plain
    version under chip_smoke.py's bf16 limits, the per-tile check
    included."""
    q, k, v, _ = inputs(cuda, torch.bfloat16, 128, 8, 4096, b=1, hkv=4)
    before = _build.launch_counts[tf.K1_NAME]
    out, lse = tf.flash_forward(q, k, v, causal=True)
    ref_out, ref_lse = tf.flash_forward_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _build.launch_counts[tf.K1_NAME] == before + 1
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert_close(torch.bfloat16, out, ref_out, out=True)
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL[torch.bfloat16]


def test_backward_at_the_moe_training_shape(cuda):
    """bf16 K2 and K3 at Qwen3-30B-A3B's attention in its training cell:
    B 1, Hq 32 over Hkv 4 (n_rep 8), S 4096, D 128, causal."""
    q, k, v, dout = inputs(cuda, torch.bfloat16, 128, 8, 4096, b=1, hkv=4)
    ref_out, ref_lse = tf.flash_forward_ref(q, k, v, causal=True)
    delta = tf.attention_delta(ref_out, dout)
    args = (q, k, v, dout, ref_lse, delta)
    dq = tf.flash_dq(*args, causal=True)
    dk, dv = tf.flash_dkv(*args, causal=True)
    ref_dq = tf.flash_dq_ref(*args, causal=True)
    ref_dk, ref_dv = tf.flash_dkv_ref(*args, causal=True)
    torch.cuda.synchronize()
    for got, want in zip((dq, dk, dv), (ref_dq, ref_dk, ref_dv)):
        assert torch.isfinite(got).all()
        assert_close(torch.bfloat16, got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("head_dim", [16, 128])
def test_backward_is_bitwise_deterministic(cuda, dtype, causal, head_dim):
    """No atomics: two runs of K2 and K3 on the same inputs agree bit for
    bit (n_rep 4, so K3 sums query heads; a ragged last tile)."""
    q, k, v, dout = inputs(cuda, dtype, head_dim, 4, 1000, b=1)
    out, lse = tf.flash_forward(q, k, v, causal=causal)
    delta = tf.attention_delta(out, dout)
    args = (q, k, v, dout, lse, delta)
    runs = [(tf.flash_dq(*args, causal=causal),
             *tf.flash_dkv(*args, causal=causal)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_unsupported_inputs_raise_before_launch(cuda):
    q, k, v, _ = inputs(cuda, torch.float32, 64, 2, 64)
    with pytest.raises(ValueError, match="head_dim"):
        tf.flash_forward(q[..., :48], k[..., :48], v[..., :48], causal=True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tf.flash_forward(q.half(), k.half(), v.half(), causal=True)
    with pytest.raises(TypeError, match="want"):
        tf.flash_forward(q, k.bfloat16(), v, causal=True)
