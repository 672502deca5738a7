"""PyTorch port, the hand-written CUDA grouped-MLP kernels on the card.

K5 (forward), K6 (dx) and K7 (dWg, dWu, dWd), with the grads pass they
share, against their plain PyTorch versions on the same inputs: a small
width (H 128, I 192) and Qwen3-30B-A3B's (H 2048, I 768), capacities 1,
16, 17, 40, 64, 65, 200 and 320 (both sides of K5's 16-row decode tiles
and of the 64-row slot tiles, and the training cell's C), fill counts 0,
partial and C (an expert whose counts are all 0 among them), fp32 and
bf16, random rows past the counts (which must come out exactly 0) and a
dense random cotangent (so the masks matter); experts whose counts are all
0 among full ones (zero gradients, zero dx); bf16 K7 with an expert's rows
inside and past the buffer it keeps resident (320 rows: the streaming
path); and two runs of K7 that must agree bit for bit (no atomics). Every test needs a CUDA card and
skips without one (decided in a fixture, at run time). The file imports
no JAX, so it runs on the GPU machine without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_grouped_mlp_cuda.py

Tolerances, the limits of chip_smoke.py's kernel_grouped_mlp phase: the
relative L2 error of each whole tensor, of its worst 64-row slot tile of
one (expert, group) (dx, out) or of its worst expert (dW), and a coarse
max abs over the tensor's largest magnitude. fp32: the kernels sum in another order than the plain versions.
bf16: both round h, s, dG and dU to bf16; an fp32 sum that lands on the
other side of a rounding step moves that entry by one bf16 ulp.
"""

import pytest
import torch

from scaletorch_tpu_torch.ops import _build
from scaletorch_tpu_torch.ops import grouped_mlp as gm

pytestmark = pytest.mark.cuda

TOL = {
    torch.float32: {"max_abs_rel": 1e-5, "rel": 1e-5, "tile_rel": 1e-4},
    torch.bfloat16: {"max_abs_rel": 1e-2, "rel": 3e-3, "tile_rel": 1e-2},
}
TILE = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grouped-MLP kernels are CUDA C++ "
                    "built with nvcc for sm_90a and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def problem(dev, dtype, e, g, c, h, i, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + c + h)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    x = rnd(e, g, c, h)
    wg, wu = rnd(e, h, i, scale=h ** -0.5), rnd(e, h, i, scale=h ** -0.5)
    wd = rnd(e, i, h, scale=i ** -0.5)
    dout = rnd(e, g, c, h)
    counts = torch.randint(0, c + 1, (e, g), generator=gen, device=dev)
    counts[0] = 0                       # an expert with no rows at all
    counts[1, 0] = c                    # a full (expert, group)
    counts[-1, -1] = max(1, c // 3)     # a partial one
    return x, counts.to(torch.int32), wg, wu, wd, dout


def rel(a, b):
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


def tile_rel(a, b):
    """The largest relative L2 error of one 64-row slot tile of one
    (expert, group) of [E, G, C, H] tensors (tiles of zeros skipped)."""
    e, g, c, _ = b.shape
    pad = (-c) % TILE

    def per_tile(t):
        rows = torch.nn.functional.pad(t.float().square().sum(-1), (0, pad))
        return rows.view(e, g, -1, TILE).sum(-1)

    return _worst(per_tile(a.float() - b.float()), per_tile(b))


def _worst(num, den):
    ratios = (num[den > 0] / den[den > 0]).sqrt()
    return float(ratios.max()) if ratios.numel() else 0.0


def expert_rel(a, b):
    """The largest relative L2 error of one expert's weight gradient."""
    return _worst((a.float() - b.float()).square().flatten(1).sum(-1),
                  b.float().square().flatten(1).sum(-1))


def assert_close(dtype, got, want, per_weight=False):
    tol = TOL[dtype]
    got = got.detach()
    assert torch.isfinite(got).all()
    scale = float(want.float().abs().max().clamp_min(1e-30))
    assert float((got.float() - want.float()).abs().max()) <= (
        tol["max_abs_rel"] * scale)
    assert rel(got, want) <= tol["rel"]
    worst = expert_rel(got, want) if per_weight else tile_rel(got, want)
    assert worst <= tol["tile_rel"]


def structural_zeros(t, counts):
    c = t.shape[2]
    past = torch.arange(c, device=t.device)[None, None] >= counts[..., None]
    return bool((t[past] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("width", [(128, 192), (2048, 768)],
                         ids=["small", "full"])
@pytest.mark.parametrize("cap", [1, 16, 17, 40, 64, 65, 200, 320])
def test_kernels_match_plain_versions(cuda, dtype, width, cap):
    h, i = width
    x, counts, wg, wu, wd, dout = problem(cuda, dtype, 6, 3, cap, h, i)
    before = dict(_build.launch_counts)
    out = gm.grouped_mlp_forward(x, counts, wg, wu, wd)
    grads = gm.grouped_mlp_block_grads(x, counts, wg, wu, wd, dout)
    dx = gm.grouped_mlp_dx(x, counts, wg, wu, wd, dout, grads)
    dws = gm.grouped_mlp_dw(x, counts, wg, wu, wd, dout, grads)
    torch.cuda.synchronize()
    for name in (gm.K5_NAME, gm.GRADS_NAME, gm.K6_NAME, gm.K7_NAME):
        assert _build.launch_counts[name] == before.get(name, 0) + 1
    assert_close(dtype, out, gm.masked_grouped_mlp(x, counts, wg, wu, wd))
    assert_close(dtype, dx, gm.grouped_mlp_dx_ref(x, counts, wg, wu, wd,
                                                  dout))
    for got, want in zip(dws, gm.grouped_mlp_dw_ref(x, counts, wg, wu, wd,
                                                    dout)):
        assert_close(dtype, got, want, per_weight=True)
    assert structural_zeros(out, counts) and structural_zeros(dx, counts)
    assert all(not w[0].any() for w in dws)  # expert 0 has no rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_autograd_runs_the_kernels(cuda, dtype):
    x, counts, wg, wu, wd, dout = problem(cuda, dtype, 4, 2, 70, 256, 128)
    leaves = [t.clone().requires_grad_() for t in (x, wg, wu, wd)]
    _build.reset_launch_counts()
    out = gm.grouped_swiglu_mlp(leaves[0], counts, *leaves[1:])
    out.backward(dout)
    torch.cuda.synchronize()
    assert dict(_build.launch_counts) == {
        gm.K5_NAME: 1, gm.GRADS_NAME: 1, gm.K6_NAME: 1, gm.K7_NAME: 1}
    assert_close(dtype, out, gm.masked_grouped_mlp(x, counts, wg, wu, wd))
    want = (gm.grouped_mlp_dx_ref(x, counts, wg, wu, wd, dout),
            *gm.grouped_mlp_dw_ref(x, counts, wg, wu, wd, dout))
    for k, (leaf, w) in enumerate(zip(leaves, want)):
        assert_close(dtype, leaf.grad, w, per_weight=k > 0)


def test_unsupported_inputs_raise_before_launch(cuda):
    x, counts, wg, wu, wd, _ = problem(cuda, torch.float32, 2, 2, 8, 64, 64)
    with pytest.raises(ValueError, match="multiples of 64"):
        gm.grouped_mlp_forward(x[..., :32], counts, wg[:, :32], wu[:, :32],
                               wd[..., :32])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gm.grouped_mlp_forward(x.half(), counts, wg.half(), wu.half(),
                               wd.half())
    with pytest.raises(TypeError, match="int32"):
        gm.grouped_mlp_forward(x, counts.long(), wg, wu, wd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_experts_without_rows_get_zero_gradients(cuda, dtype):
    """Every other expert has all its counts at 0, the rest are full."""
    x, counts, wg, wu, wd, dout = problem(cuda, dtype, 6, 2, 96, 2048, 768)
    counts[0::2] = 0
    counts[1::2] = 96
    grads = gm.grouped_mlp_block_grads(x, counts, wg, wu, wd, dout)
    dx = gm.grouped_mlp_dx(x, counts, wg, wu, wd, dout, grads)
    dws = gm.grouped_mlp_dw(x, counts, wg, wu, wd, dout, grads)
    torch.cuda.synchronize()
    assert not dx[0::2].any() and structural_zeros(dx, counts)
    for got, want in zip(dws, gm.grouped_mlp_dw_ref(x, counts, wg, wu, wd,
                                                    dout)):
        assert not got[0::2].any()
        assert_close(dtype, got, want, per_weight=True)


@pytest.mark.parametrize("groups,cap", [(1, 320), (2, 320), (3, 200)],
                         ids=["resident", "streams_640", "streams_3x200"])
def test_dw_inside_and_past_the_resident_buffer(cuda, groups, cap):
    """bf16 K7 keeps an expert's rows resident up to dw_resident_rows() and
    streams them past it; both paths against the plain version, at
    Qwen3-30B-A3B's width, with full, partial and empty experts."""
    x, counts, wg, wu, wd, dout = problem(cuda, torch.bfloat16, 5, groups,
                                          cap, 2048, 768)
    counts[2] = cap  # an expert at every slot of every group
    rows = ((counts.long() + 63) // 64 * 64).sum(1)  # whole slot tiles
    assert int(rows[2]) == groups * ((cap + 63) // 64 * 64)
    assert (int(rows.max()) > gm.dw_resident_rows()) == (groups > 1)
    dws = gm.grouped_mlp_dw(x, counts, wg, wu, wd, dout)
    torch.cuda.synchronize()
    for got, want in zip(dws, gm.grouped_mlp_dw_ref(x, counts, wg, wu, wd,
                                                    dout)):
        assert_close(torch.bfloat16, got, want, per_weight=True)
    assert all(not w[0].any() for w in dws)  # expert 0 has no rows


@pytest.mark.parametrize("groups,cap", [(1, 320), (2, 320)],
                         ids=["resident", "streams"])
def test_dw_is_bitwise_deterministic(cuda, groups, cap):
    """No atomics: two runs of K7 (and of the grads pass and K6) on the
    same inputs agree bit for bit, on both K7 paths."""
    args = problem(cuda, torch.bfloat16, 4, groups, cap, 2048, 768)
    runs = []
    for _ in range(2):
        grads = gm.grouped_mlp_block_grads(*args)
        runs.append((*grads, gm.grouped_mlp_dx(*args, grads),
                     *gm.grouped_mlp_dw(*args, grads)))
    torch.cuda.synchronize()
    counts = args[1]
    past = (torch.arange(args[0].shape[2], device=cuda)[None, None]
            >= counts[..., None])
    for k, (a, b) in enumerate(zip(*runs)):
        if k < 3:  # workspace rows past the counts are never written
            a, b = a[~past], b[~past]
        assert torch.equal(a, b)
