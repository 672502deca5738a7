"""PyTorch port, pipeline and expert parallelism and the int8 wire on the
card.

On one card: K5, the grads pass, K6 and K7 on the slabs the ep exchange
hands one rank of Qwen3-30B-A3B's train cell under ep 4 ([E/ep, ep·G, C,
H] = [32, 4, 320, 2048], I 768, fill counts per (expert, source rank)
from a seeded routing of four ranks' tokens), fp32 and bf16, against
their plain versions under ``chip_smoke.py``'s ``kernel_grouped_mlp``
limits (the relative L2 error of each tensor: fp32 1e-5, bf16 3e-3), the
rows past each count zero, the backward twice equal bit for bit. On four
cards (skipped, in a fixture, without them): ``torch.distributed.run`` of
the training entry point at dense-tiny's and moe-tiny's width, fp32, under
``pp4`` afab, ``pp2 x dp2`` memory_chunked, ``pp2 x tp2`` + SP
interleaved (vpp 2), ``ep4``, ``pp2 x ep2`` and ``dp4`` with the int8
wire: exit 0, finite losses, and the first step's loss against a one-card
run on the same global batch within 1e-4 (the int8 wire changes no loss
before the first update).

The file imports no JAX, so it runs on the GPU machine, where the
repository's conftest cannot load:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_pp_ep_cuda.py
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from scaletorch_tpu_torch.ops import grouped_mlp as gm
from scaletorch_tpu_torch.parallel.expert_parallel import (
    expert_capacity,
    slot_fill_counts_indexed,
    top_k_routing_indexed,
)

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
E, K, H, I, SEQ, EP = 128, 8, 2048, 768, 4096, 4
REL = {torch.float32: 1e-5, torch.bfloat16: 3e-3}
TIMEOUT_S = 600


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5-K7 are CUDA C++ built with nvcc "
                    "for sm_90a and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def four_cards(cuda):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards: one rank a card over NCCL")
    return cuda


def rel(a, b):
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_grouped_mlp_kernels_on_the_exchanged_slabs(cuda, dtype):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(13)
    cap = expert_capacity(SEQ, E, K, 1.25)
    hidden = torch.randn(EP, SEQ, H, generator=gen, device=cuda)
    router = torch.randn(H, E, generator=gen, device=cuda) * 0.02
    routing, _ = top_k_routing_indexed(hidden @ router, K, cap)
    counts = slot_fill_counts_indexed(routing, E, cap)[:E // EP].contiguous()
    assert counts.shape == (E // EP, EP)
    assert int(counts.sum(0).max()) > int(counts.sum(0).min())

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=cuda)
                * scale).to(dtype)

    x = rnd(E // EP, EP, cap, H)
    wg, wu = rnd(E // EP, H, I, scale=H ** -0.5), rnd(E // EP, H, I,
                                                      scale=H ** -0.5)
    wd = rnd(E // EP, I, H, scale=I ** -0.5)
    dout = rnd(E // EP, EP, cap, H)
    args = (x, counts, wg, wu, wd, dout)
    out = gm.grouped_mlp_forward(*args[:5])
    assert rel(out, gm.masked_grouped_mlp(*args[:5])) <= REL[dtype]
    past = torch.arange(cap, device=cuda)[None, None] >= counts[..., None]
    assert bool((out[past] == 0).all())
    grads = gm.grouped_mlp_block_grads(*args)
    dx = gm.grouped_mlp_dx(*args, grads)
    dws = gm.grouped_mlp_dw(*args, grads)
    ref_grads = gm.grouped_mlp_block_grads_ref(*args)
    assert rel(dx, gm.grouped_mlp_dx_ref(*args, ref_grads)) <= REL[dtype]
    for got, want in zip(dws, gm.grouped_mlp_dw_ref(*args, ref_grads)):
        assert rel(got, want) <= REL[dtype]
    again = gm.grouped_mlp_block_grads(*args)
    assert torch.equal(gm.grouped_mlp_dx(*args, again), dx)
    assert all(torch.equal(a, b) for a, b in
               zip(gm.grouped_mlp_dw(*args, again), dws))


DENSE = ["--model_type", "qwen3", "--vocab_size", "4096", "--hidden_size",
         "256", "--intermediate_size", "512", "--num_hidden_layers", "4",
         "--num_attention_heads", "8", "--num_key_value_heads", "4",
         "--head_dim", "32", "--rope_theta", "1e6"]
MOE = ["--model_type", "qwen3_moe", "--vocab_size", "4096", "--hidden_size",
       "256", "--intermediate_size", "512", "--moe_intermediate_size", "192",
       "--num_hidden_layers", "4", "--num_attention_heads", "8",
       "--num_key_value_heads", "4", "--head_dim", "32", "--rope_theta",
       "1e6", "--num_experts", "8", "--num_experts_per_tok", "2"]
COMMON = ["--synthetic_data", "true", "--sequence_length", "512",
          "--dtype", "float32", "--total_train_steps", "3",
          "--log_frequency", "1"]


def train(tmp_path, nproc, model, *flags):
    logs = tmp_path / f"logs{nproc}{'_'.join(flags)}"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", "-m", "scaletorch_tpu_torch.train",
           *model, *COMMON, "--performance_log_dir", str(logs), *flags]
    env = {**os.environ, "SCALETORCH_TPU_GROUPED_MLP_KERNEL": "1"}
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
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


# (model, the layout's flags, its rows a microbatch, its microbatches)
LAYOUTS = {
    "pp4_afab": (DENSE, ("--pipeline_parallel_size", "4"), 1, 4),
    "pp2_dp2_memory_chunked": (
        DENSE, ("--pipeline_parallel_size", "2", "--data_parallel_size", "2",
                "--pp_engine", "memory_chunked"), 2, 3),
    "pp2_tp2_sp_interleaved": (
        DENSE, ("--pipeline_parallel_size", "2", "--tensor_parallel_size",
                "2", "--sequence_parallel", "true", "--pp_engine",
                "interleaved", "--pp_virtual_stages", "2"), 1, 4),
    "ep4": (MOE, ("--expert_parallel_size", "4"), 4, 1),
    "pp2_ep2": (MOE, ("--pipeline_parallel_size", "2",
                      "--expert_parallel_size", "2"), 2, 2),
    "dp4_int8": (DENSE, ("--data_parallel_size", "4",
                         "--grad_allreduce_dtype", "int8"), 4, 1),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_four_ranks_train_like_one_card(four_cards, tmp_path, name):
    model, layout, rows, micro = LAYOUTS[name]
    accum = ("--gradient_accumulation_steps", str(micro))
    one = train(tmp_path, 1, model, "--micro_batch_size", str(rows), *accum)
    four = train(tmp_path, 4, model, *layout, *accum)
    assert all(x == x and abs(x) < 1e3 for x in four)
    assert abs(four[0] - one[0]) <= 1e-4
