"""PyTorch port, the parallel path on the card.

On one card: K1 (forward) and K2/K3 (backward) at the cp ring's full
blocks of the headline row (Qwen3-0.6B's Hq 16 / Hkv 8 / D 128 at S 8192
over cp 4: the contiguous layout's 2048 x 2048 off-diagonal block and
the zigzag layout's 2048 x 1024 and 1024 x 2048 blocks), fp32 and bf16,
against their plain versions; the contiguous ring and Ulysses over a
one-rank mesh equal to ``flash_attention`` bit for bit (the diagonal
block is K1 alone), the zigzag ring (three half blocks merged in fp32)
within ``ZIGZAG_REL``. On four cards (skipped, in a fixture, without
them): ``torch.distributed.run`` of the training entry point at
dense-tiny's width under ``cp4`` (zigzag ring), ``cp4`` Ulysses and
``dp2 x tp2`` with SP, fp32: exit 0, finite losses, and the first
step's loss (the batch of one row, or of two rows for dp 2) against a
one-card run within 1e-4.

The file imports no JAX, so it runs on the GPU machine, where the
repository's conftest cannot load:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_parallel_cuda.py

Tolerances, those of chip_smoke.py's kernel_flash phase: relative L2
error of the output and of each gradient, and the largest relative L2
error of one 64-row tile of one head (fp32 1e-5 / 1e-4; bf16 3e-3 for
the output, 1e-3 for the gradients, 1e-2 / 1.5e-3 a tile).
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from scaletorch_tpu_torch.ops import flash as tf

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
OUT_REL = {torch.float32: 1e-5, torch.bfloat16: 3e-3}
GRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
OUT_TILE = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
GRAD_TILE = {torch.float32: 1e-4, torch.bfloat16: 1.5e-3}
TILE = 64
BLOCKS = {"contiguous_offdiag": (2048, 2048), "zigzag_older": (2048, 1024),
          "zigzag_newer": (1024, 2048)}
TIMEOUT_S = 600
# one rank's zigzag ring against flash_attention: the same function
# summed in another order; bf16 rounds at other places (an ulp is 7.8e-3)
ZIGZAG_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels are CUDA C++ built "
                    "with nvcc for sm_90a and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def four_cards(cuda):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards: one rank a card over NCCL")
    return cuda


def rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def tile_rel(a, b):
    batch, heads, seq, _ = b.shape

    def per_tile(x):
        rows = x.float().square().sum(-1)
        rows = torch.nn.functional.pad(rows, (0, (-seq) % TILE))
        return rows.view(batch, heads, -1, TILE).sum(-1)

    return float((per_tile(a.float() - b.float()) / per_tile(b)).sqrt().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_ring_blocks_match_their_plain_versions(cuda, dtype, block):
    sq, skv = BLOCKS[block]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sq + 7 * skv)

    def rnd(heads, seq):
        return torch.randn(1, heads, seq, 128, generator=gen,
                           device=cuda).to(dtype)

    q, k, v, dout = rnd(16, sq), rnd(8, skv), rnd(8, skv), rnd(16, sq)
    out, lse = tf.flash_forward(q, k, v, causal=False)
    ref_out, ref_lse = tf.flash_forward_ref(q, k, v, causal=False)
    delta = tf.attention_delta(ref_out, dout)
    args = (q, k, v, dout, ref_lse, delta)
    dq = tf.flash_dq(*args, causal=False)
    dk, dv = tf.flash_dkv(*args, causal=False)
    ref_dq = tf.flash_dq_ref(*args, causal=False)
    ref_dk, ref_dv = tf.flash_dkv_ref(*args, causal=False)
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    assert rel(out, ref_out) <= OUT_REL[dtype]
    assert tile_rel(out, ref_out) <= OUT_TILE[dtype]
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert rel(got, want) <= GRAD_REL[dtype]
        assert tile_rel(got, want) <= GRAD_TILE[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_one_rank_cp_backends_are_flash(cuda, dtype):
    from scaletorch_tpu_torch.ops.ring_attention import ring_attention
    from scaletorch_tpu_torch.ops.ulysses import ulysses_attention
    from scaletorch_tpu_torch.parallel.mesh import (
        MeshManager,
        using_mesh_manager,
    )

    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    q = torch.randn(1, 16, 512, 128, generator=gen, device=cuda).to(dtype)
    k = torch.randn(1, 8, 512, 128, generator=gen, device=cuda).to(dtype)
    v = torch.randn(1, 8, 512, 128, generator=gen, device=cuda).to(dtype)
    dout = torch.randn_like(q)

    def run(fn):
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*x)
        return [out, *torch.autograd.grad(out, x, dout)]

    want = run(lambda a, b, c: tf.flash_attention(a, b, c, causal=True))
    with using_mesh_manager(MeshManager(cp=1)):
        got = run(lambda a, b, c: ring_attention(a, b, c,
                                                 layout="contiguous"))
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        got = run(lambda a, b, c: ulysses_attention(a, b, c))
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        # the zigzag schedule's three half blocks, merged in fp32
        got = run(lambda a, b, c: ring_attention(a, b, c, layout="zigzag"))
        for x, y in zip(got, want):
            assert rel(x, y) <= ZIGZAG_REL[dtype]


TINY = ["--model_type", "qwen3", "--vocab_size", "4096", "--hidden_size",
        "256", "--intermediate_size", "512", "--num_hidden_layers", "4",
        "--num_attention_heads", "8", "--num_key_value_heads", "4",
        "--head_dim", "32", "--rope_theta", "1e6", "--synthetic_data", "true",
        "--sequence_length", "512", "--dtype", "float32",
        "--total_train_steps", "3", "--log_frequency", "1"]


def train(tmp_path, nproc, *flags):
    logs = tmp_path / f"logs{nproc}{'_'.join(flags)}"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", "-m", "scaletorch_tpu_torch.train",
           *TINY, "--performance_log_dir", str(logs), *flags]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{flags}: over {TIMEOUT_S} s\n{out[-3000:]}")
    assert proc.returncode == 0, out[-3000:]
    with open(logs / "performance_log_step3.json") as f:
        return [r["loss"] for r in json.load(f)["records"]]


@pytest.mark.parametrize("layout,rows", [
    (("--context_parallel_size", "4", "--attention_backend", "ring",
      "--cp_layout", "zigzag"), 1),
    (("--context_parallel_size", "4", "--attention_backend", "ulysses"), 1),
    (("--data_parallel_size", "2", "--tensor_parallel_size", "2",
      "--sequence_parallel", "true"), 2),
], ids=["cp4_ring_zigzag", "cp4_ulysses", "dp2_tp2_sp"])
def test_four_ranks_train_like_one_card(four_cards, tmp_path, layout, rows):
    one = train(tmp_path, 1, "--micro_batch_size", str(rows))
    four = train(tmp_path, 4, *layout)
    assert all(x == x and abs(x) < 1e3 for x in four)
    assert abs(four[0] - one[0]) <= 1e-4
