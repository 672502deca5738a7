#!/usr/bin/env python3
"""Build and drive the PyTorch port on one CUDA card; fail on any fault.

Run from the root of a checkout, with one visible card:

    python3 chip_smoke.py

It takes no arguments. One phase alone, e.g. the grouped-MLP kernels in
bf16 (copied into a checkout of another commit and run there, this times
that commit's kernels by the same yardstick):

    python -c "import torch, chip_smoke as c; c.phase_device(); \
c.phase_build(); c.phase_kernel_grouped_mlp(dtypes=(torch.bfloat16,))"

Phases, each printing one JSON line (any failure raises and the exit code
is non-zero; no phase catches an exception):

  1. device   — the card's name and power limit (nvidia-smi) and
                torch.cuda.get_device_name(0); no card, no run.
  2. build    — nvcc builds every kernel source in
                scaletorch_tpu_torch/csrc/ (paged_decode, flash_fwd,
                flash_bwd, grouped_mlp_fwd, grouped_mlp_bwd) into
                build/kernels/, all compiles started together; prints
                each kernel's registers, stack frame and spill bytes from
                ptxas's report in build/kernels/<source>.log and fails if
                a tensor-core (mma.sync) kernel uses local memory.
  3. kernel_paged_decode — the paged-decode kernel (K4) against its plain
                PyTorch version at the serving shapes of Qwen3-0.6B
                (Hq 16, Hkv 8, D 128, 8 slots, page 16, 128 pages per
                slot), fp32 and bf16: max abs and the worst slot's
                relative error against stated limits, beside a control
                (the plain version with one page of the longest slot
                dropped, which must fail them); two calls equal bit for
                bit; its time, the plain version's, a library
                yardstick's (gather + scaled_dot_product_attention, which
                the port never calls), the memory bound and the share of
                it reached; beside the kernel's time, its time with the
                host's enqueue kept out of the span (`time_ms`'s
                ``spin``) and the wrapper's host µs per call; the same
                at Qwen3-30B-A3B's heads (Hq 32, Hkv 4, n_rep 8) and at
                one slot of 32768 keys; then at qwen3-14b's heads (n_rep
                5, D 128) and dense-tiny's (n_rep 2, D 32).
  4. kernel_flash — the flash kernels K1 (forward), K2 (dQ) and K3 (dK,
                dV) against their plain versions at the training shape of
                Qwen3-0.6B (B 1, Hq 16, Hkv 8, S 8192, D 128, causal),
                fp32 and bf16: max abs, whole-tensor and per-tile
                relative errors against stated limits, beside the readings
                of two controls (kernels that skip one tile, which must
                fail the checks, and a lower-precision plain version); each
                kernel's time, its plain version's, the library yardstick
                (scaled_dot_product_attention forward, and its autograd
                backward for K2 + K3 together), the bound, the share of
                the bound reached and the TFLOP/s. K2 and K3 run twice and
                must agree bit for bit; bf16 K2 and K3 run again at
                Qwen3-30B-A3B's training shape (Hq 32, Hkv 4, S 4096),
                checked against their plain versions and timed; K1-K3
                also at qwen3-14b's heads (Hq 40, Hkv 8, D 128) and
                dense-tiny's (Hq 8, Hkv 4, D 32), S 2048, against their
                plain versions under the same limits.
  5. decode_parity — Qwen3-0.6B at full width, fp32, random weights from
                a seeded generator: teacher-forced paged decode of
                2 x 64 tokens through the kernel and through the gather
                path; max |logit difference| <= 1e-3.
  6. serve    — the paged engine at Qwen3-0.6B width in bf16 serves 16
                greedy requests (half behind a shared 256-token prefix)
                with the kernel counted: every outcome ok, prefix hits,
                page conservation, pools updated in place, and 28 kernel
                launches per decode step. The same traffic through the
                gather path gives the greedy agreement (printed, not
                asserted: bf16 can diverge late in a sequence).
  7. profile  — torch.profiler over 16 steady decode ticks of the same
                engine: wall and device time per step, the device's busy
                share, K4's device time and kernel launches per step, and
                the kernels that take the device time.
  8. geometry_serve — the presets' other head geometries through K4: a
                paged engine at dense-tiny (head_dim 32), fp32, whose
                greedy tokens must equal the dense engine's, K4 launched
                once a layer a decode step; and a 2-layer cut of
                qwen3-14b's width (n_rep 5), fp32, teacher-forced paged
                decode of 2 x 64 tokens through K4 and through the gather
                path, max |logit difference| <= 1e-3.
  9. train_parity — Qwen3-0.6B at full width and depth, fp32, random
                weights from a seeded generator, 2 x 1024 tokens, gradient
                checkpointing: the loss and every gradient through the
                flash backend (K1-K3) and through sdpa.
 10. train    — the port's benchmark entry (benchmark_config) on the
                bench headline row (qwen3-0.6b, seq 8192, micro-batch 1,
                gradient checkpointing, bf16 compute, fp32 masters, AdamW):
                its Trainer takes 2 warm-up and 5 timed steps on synthetic
                data with the kernels counted: finite losses, no skipped
                update, and 56 / 28 / 28 launches of K1 / K2 / K3 per step;
                tokens/s, MFU and peak memory as the entry reports them.
 11. train_profile — torch.profiler over 2 steady steps of the same
                trainer.
     The Qwen3-0.6B models are freed here; the Qwen3-30B-A3B phases follow
     (full width, random weights from a seeded generator, the grouped-MLP
     kernels switched on through the config or the environment):
 12. kernel_grouped_mlp — K5 (forward), K6 (dx) and K7 (dW) against their
                plain versions in fp32 and bf16 at three shapes: train (E
                128, G 1, C 320, H 2048, I 768, counts from a real routing
                of seeded tokens plus one expert at 0 and one at C; K5-K7),
                prefill (G 8, C 512, dropless; K5) and decode (G 8, C 1;
                K5). Max abs, whole-tensor and worst-tile (worst-expert for
                dW) relative errors against stated limits (s, dG and dU of
                the backward's grads pass too), beside two controls that
                must fail them (one filled slot tile skipped; K7 with dO
                unmasked past the count); two runs of the backward must
                agree bit for bit; each launch's time (the grads pass, K6
                and K7 each alone, and the whole backward as
                _GroupedSwiGLU.backward runs it), its plain version's, the
                library's (cuBLAS bmm of the launch's own products for K6
                and K7; the einsum path for K5 and the whole backward;
                several calls, not one) and the bound of its own work.
 13. moe_decode_parity — 4 layers, fp32, dropless: teacher-forced paged
                decode of 2 x 64 tokens through K4 + K5 and through the
                gather path + einsum path; max |logit difference| <= 1e-3.
 14. moe_serve — the engine at full width and depth (48 layers), bf16,
                dropless, the traffic of phase 6: every outcome ok, page
                conservation, 48 K4 and 48 K5 launches per decode step,
                peak memory; the same traffic through the gather path +
                einsum path gives the greedy agreement (printed); then
                torch.profiler over 16 steady decode ticks, as phase 7.
 15. moe_train_parity — 2 layers, fp32, 2 x 1024 tokens, GC: the loss (CE
                + aux) and every gradient with the kernels on (K5-K7 and
                K1-K3) against the einsum path (K1-K3).
 16. moe_train — benchmark_config on make_bench_args("qwen3-30b-a3b",
                seq=4096, gc=True) cut to 4 layers, kernels on: 2 warm-up
                and 5 timed steps, finite losses, no skipped update, and
                8 / 4 / 4 / 8 / 4 / 4 launches of K1 / K2 / K3 / K5 / K6 /
                K7 per step, and 4 grads passes; tokens/s, MFU over the
                active parameters, peak memory, the routing statistics and
                the rows routed per layer.
 17. moe_train_profile — torch.profiler over 2 steady steps of it.
 18. kernels  — every Pallas kernel of the JAX package, ported or not.

Then the seconds each phase took, the per-kernel contract line (K1-K7,
and the grads pass that K6 and K7 share), the nvidia-smi line, and last:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from scaletorch_tpu_torch.benchmark import benchmark_config, make_bench_args
from scaletorch_tpu_torch.inference import (
    InferenceEngine,
    SamplingParams,
    teacher_forced_decode,
    teacher_forced_decode_paged,
)
from scaletorch_tpu_torch.models import (
    LlamaForCausalLM,
    Qwen3MoEForCausalLM,
    init_params,
    model_config,
)
from scaletorch_tpu_torch.models import qwen3_moe
from scaletorch_tpu_torch.ops import _build
from scaletorch_tpu_torch.ops import flash as tf
from scaletorch_tpu_torch.ops import grouped_mlp as gm
from scaletorch_tpu_torch.parallel.expert_parallel import (
    expert_capacity,
    moe_mlp,
    slot_fill_counts_indexed,
    top_k_routing_indexed,
)
from scaletorch_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_ref,
    paged_gather_kv,
)
from scaletorch_tpu_torch.trainer.optimizer import tree_leaves
from scaletorch_tpu_torch.trainer.train_step import make_loss_fn
from scaletorch_tpu_torch.utils.device import card_name_and_power_limit

MODEL = "qwen3-0.6b"
# the presets' other head geometries: n_rep 5 at D 128, D 32 at n_rep 2
GEOMETRY_MODELS = ("qwen3-14b", "dense-tiny")
GEOMETRY_SEQ = 2048  # K1-K3 at those heads
GEOMETRY_PARITY_LAYERS = 2  # the qwen3-14b decode-parity cut
# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 / fp32 flop/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# serving shapes of the paged engine at Qwen3-0.6B width
SLOTS, PAGE_SIZE, MAX_SEQ, PREFILL_LEN = 8, 16, 2048, 512
PAGES_PER_SLOT = MAX_SEQ // PAGE_SIZE
TOLERANCE = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# K4 vs its plain version: the worst slot's relative L2 error, which sits
# below the reading of the one-page-dropped control (bf16's max abs limit
# cannot see a dropped page among 2048 keys; phase 3 prints both). At
# 32768 keys a dropped page moves a slot by ~2%, so that row's bf16 limit
# is tighter.
DECODE_SLOT_REL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
LONG_CONTEXT = 32768  # keys of the one-slot K4 row
LONG_CONTEXT_SLOT_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# time_ms's spin: ~2 ms at the H100's ~1.98 GHz, longer than the host
# takes to enqueue any call timed here
SPIN_CYCLES = 4_000_000
PARITY_TOLERANCE = 1e-3
# the bench headline row: qwen3-0.6b, seq 8192, micro-batch 1, GC
TRAIN_SEQ = 8192
TRAIN_WARMUP, TRAIN_STEPS, PROFILE_STEPS = 2, 5, 2
# kernel vs plain version, on each of out, lse, dQ, dK, dV: max abs, the
# relative L2 error of the whole tensor ("rel"), and the largest relative
# L2 error of one TILE-row tile of one head ("tile_rel": a fault confined
# to one tile, which the whole tensor's norm dilutes, shows there). Each
# limit sits above the sound kernels' reading and below the reading of a
# kernel that skips one tile (phase 4 prints both, and a lower-precision
# control beside them).
TILE = 64
FLASH_TOLERANCE = {
    torch.float32: {"out_max_abs": 2e-5, "lse_max_abs": 1e-4,
                    "out_rel": 1e-5, "grad_rel": 1e-5,
                    "out_tile_rel": 1e-4, "grad_tile_rel": 1e-4},
    torch.bfloat16: {"out_max_abs": 2e-2, "lse_max_abs": 1e-4,
                     "out_rel": 3e-3, "grad_rel": 1e-3,
                     "out_tile_rel": 1e-2, "grad_tile_rel": 1.5e-3},
}
# flash vs sdpa through the whole fp32 model: two attention algorithms,
# the same function; fp32 rounding across 28 layers
TRAIN_PARITY = {"loss_abs": 1e-4, "grad_rel": 1e-3}

TPU_KERNELS = [
    ("K1", "_fwd_kernel", "scaletorch_tpu/ops/pallas/flash.py:76"),
    ("K2", "_dq_kernel", "scaletorch_tpu/ops/pallas/flash.py:181"),
    ("K3", "_dkv_kernel", "scaletorch_tpu/ops/pallas/flash.py:223"),
    ("K4", "_paged_decode_kernel",
     "scaletorch_tpu/ops/pallas/paged_attention.py:131"),
    ("K5", "_kernel", "scaletorch_tpu/ops/pallas/grouped_mlp.py:72"),
    ("K6", "_dx_kernel", "scaletorch_tpu/ops/pallas/grouped_mlp.py:132"),
    ("K7", "_dw_kernel", "scaletorch_tpu/ops/pallas/grouped_mlp.py:162"),
]
PORTED = {
    "K1": {"name": tf.K1_NAME, "route": "cuda",
           "source": "scaletorch_tpu_torch/csrc/flash_fwd.cu"},
    "K2": {"name": tf.K2_NAME, "route": "cuda",
           "source": "scaletorch_tpu_torch/csrc/flash_bwd.cu"},
    "K3": {"name": tf.K3_NAME, "route": "cuda",
           "source": "scaletorch_tpu_torch/csrc/flash_bwd.cu"},
    "K4": {"name": "paged_decode", "route": "cuda",
           "source": "scaletorch_tpu_torch/csrc/paged_decode.cu"},
    "K5": {"name": gm.K5_NAME, "route": "cuda",
           "source": "scaletorch_tpu_torch/csrc/grouped_mlp_fwd.cu"},
    "K6": {"name": gm.K6_NAME, "route": "cuda",
           "source": "scaletorch_tpu_torch/csrc/grouped_mlp_bwd.cu"},
    "K7": {"name": gm.K7_NAME, "route": "cuda",
           "source": "scaletorch_tpu_torch/csrc/grouped_mlp_bwd.cu"},
}
# the pass that computes _block_grads once for K6 and K7 (the TPU kernels
# each recompute it): a launch of its own on the main path
GRADS_PASS = {"name": gm.GRADS_NAME, "route": "cuda",
              "source": "scaletorch_tpu_torch/csrc/grouped_mlp_bwd.cu",
              "replaces": "scaletorch_tpu/ops/pallas/grouped_mlp.py:110"}

# ---- Qwen3-30B-A3B ---------------------------------------------------------------
MOE_MODEL = "qwen3-30b-a3b"
DROPLESS_CF = 16.0  # E / k: every (token, choice) keeps its slot
MOE_TRAIN_SEQ, MOE_TRAIN_LAYERS = 4096, 4
MOE_DECODE_PARITY_LAYERS, MOE_TRAIN_PARITY_LAYERS = 4, 2
# K5-K7 vs plain versions: the relative L2 error of the whole tensor
# ("rel"), of its worst 64-row slot tile of one (expert, group) for out
# and dx or of its worst expert for dW ("tile_rel"), and the max abs
# error over the tensor's largest magnitude ("max_abs_rel", coarse).
# Each limit sits above the sound kernels' reading and below the readings
# of the controls (phase 11 prints all three).
GMLP_TOLERANCE = {
    torch.float32: {"max_abs_rel": 1e-5, "rel": 1e-5, "tile_rel": 1e-4},
    torch.bfloat16: {"max_abs_rel": 1e-2, "rel": 3e-3, "tile_rel": 1e-2},
}
GMLP_SHAPES = {  # name: (groups, tokens per group, capacity factor, bwd)
    "train": (1, MOE_TRAIN_SEQ, 1.25, True),
    "prefill": (8, PREFILL_LEN, DROPLESS_CF, False),
    "decode": (8, 1, DROPLESS_CF, False),
}
# kernels on vs the einsum path through the whole fp32 model (the
# limits of the flash vs sdpa training parity)
MOE_TRAIN_PARITY = {"loss_abs": 1e-4, "grad_rel": 1e-3}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, flush: torch.Tensor, reps: int = 20,
            spin: bool = False) -> float:
    """Median time of one call, each call timed alone with CUDA events
    after a write of ``flush`` (larger than the 50 MB L2), so every call
    finds its inputs cold, as a decode step's layer does. The span holds
    whatever part of the host's enqueue of the call outlasts the flush.
    With ``spin`` the card spins (``torch.cuda._sleep``) after the
    flush, so the call is enqueued before the start event and the span
    is the card's work alone."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def host_us(fn, calls: int = 100, reps: int = 5) -> float:
    """Median host µs per call over ``reps`` runs of ``calls`` calls back
    to back: the card queues them, nothing waits for it."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return statistics.median(runs)


# ---- 1. device --------------------------------------------------------------
def phase_device() -> dict:
    smi = card_name_and_power_limit()
    check(smi is not None, "nvidia-smi is missing")
    info = {"nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit("device", **info)
    return info


# ---- 2. build ---------------------------------------------------------------
def phase_build() -> None:
    t0 = time.monotonic()
    seconds = _build.build()
    resources = _build.build_resources()
    emit("build", sources=list(_build.KERNEL_SOURCES),
         compile_s=seconds, seconds=time.monotonic() - t0,
         build_dir=str(_build.BUILD_DIR), resources=resources)
    # the mma.sync kernels keep their accumulators in registers: no spill
    # and no stack frame (an array indexed at run time lands there)
    local = [f"{src}: {kernel} {res}" for src, kernels in resources.items()
             for kernel, res in kernels.items()
             if "mma" in kernel and any(res.get(key, 0) for key in (
                 "stack_frame", "spill_stores", "spill_loads"))]
    check(not local, f"tensor-core kernels use local memory: {local}")


# ---- 3. the paged-decode kernel against its plain version --------------------
def decode_inputs(dtype: torch.dtype, seed: int, model: str = MODEL,
                  slots: int = SLOTS, max_seq: int = MAX_SEQ,
                  positions=None):
    """Serving-shaped inputs at ``model``'s heads: shuffled physical
    pages of PAGE_SIZE, ``max_seq // PAGE_SIZE`` per slot; positions that
    include 0, both sides of a page boundary and the last position
    (``positions`` replaces them)."""
    cfg = model_config(model)
    b, hq, hkv = slots, cfg.num_attention_heads, cfg.num_key_value_heads
    d = cfg.actual_head_dim
    pages = max_seq // PAGE_SIZE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_pages = b * pages + 1
    pool_k = torch.randn(n_pages, hkv, PAGE_SIZE, d, generator=gen,
                         device=dev).to(dtype)
    pool_v = torch.randn(n_pages, hkv, PAGE_SIZE, d, generator=gen,
                         device=dev).to(dtype)
    q = torch.randn(b, hq, d, generator=gen, device=dev).to(dtype)
    tables = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1)
    tables = tables.to(torch.int32).view(b, pages).contiguous()
    if positions is None:
        rest = torch.randint(1, max_seq, (b - 4,), generator=gen, device=dev)
        positions = torch.cat([
            torch.tensor([0, PAGE_SIZE - 1, PAGE_SIZE, max_seq - 1],
                         device=dev), rest])
    positions = torch.as_tensor(positions, device=dev).to(torch.int32)
    return q, pool_k, pool_v, tables, positions


def decode_bound_ms(q, pool_k, positions) -> float:
    """The least time for the function on these inputs: the larger of its
    bytes (q, the visible K and V rows, their table entries, positions,
    the output) over HBM bandwidth and its flops over the dtype's peak."""
    b, hq, d = q.shape
    hkv = pool_k.shape[1]
    keys = int((positions.long() + 1).sum())
    elem = q.element_size()
    kv_bytes = 2 * keys * hkv * d * elem
    table_bytes = 4 * int(((positions.long() // PAGE_SIZE) + 1).sum())
    nbytes = 2 * q.numel() * elem + kv_bytes + table_bytes + 4 * b
    flops = 4 * hq * d * keys  # q.k and p.v
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q.dtype])


def library_attention(q, pool_k, pool_v, tables, positions):
    """Yardstick only, never called by the port: gather the pages and run
    PyTorch's fused scaled_dot_product_attention with GQA."""
    k = paged_gather_kv(pool_k, tables)
    v = paged_gather_kv(pool_v, tables)
    visible = (torch.arange(k.shape[2], device=q.device)[None, :]
               <= positions[:, None].long())
    out = F.scaled_dot_product_attention(
        q[:, :, None, :], k, v, attn_mask=visible[:, None, None, :],
        enable_gqa=True)
    return out[:, :, 0, :]


def slot_rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest relative L2 error of one slot's output [Hq, D]: a fault
    confined to one slot, which the batch's max abs can miss, shows here."""
    diff = (a.float() - b.float()).flatten(1).norm(dim=1)
    return float((diff / b.float().flatten(1).norm(dim=1)).max())


def drop_one_page(tables, positions):
    """The control's inputs: the longest slot without its middle live page
    (its later pages move up one, its position falls by a page), so the
    plain version on them attends every key but that page's."""
    slot = int(positions.argmax())
    pos = int(positions[slot])
    drop = (pos // PAGE_SIZE + 1) // 2
    tables, positions = tables.clone(), positions.clone()
    row = tables[slot]
    row[drop:-1] = row[drop + 1:].clone()
    positions[slot] = pos - PAGE_SIZE
    return tables, positions


def decode_row(inputs, flush, slot_rel_limits=DECODE_SLOT_REL) -> dict:
    """K4 against its plain version on ``inputs``: max abs and worst-slot
    relative error, beside the one-page-dropped control's readings; two
    calls bit for bit; the kernel's time (also with the host's enqueue
    kept out of the span), the wrapper's host µs per call, the plain
    version's and the library's time, and the bound."""
    q, pool_k, pool_v, tables, positions = inputs
    dtype = q.dtype
    out = paged_decode_attention(*inputs)
    again = paged_decode_attention(*inputs)
    ref = paged_decode_attention_ref(*inputs)
    dropped = paged_decode_attention_ref(
        q, pool_k, pool_v, *drop_one_page(tables, positions))
    lib = library_attention(*inputs)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"{dtype}: non-finite output")
    check(torch.equal(out, again), f"{dtype}: two calls differ")

    def kernel():
        return paged_decode_attention(*inputs)

    row = {
        "dtype": str(dtype).replace("torch.", ""),
        "shape": {"q": list(q.shape), "pool": list(pool_k.shape),
                  "page_tables": list(tables.shape)},
        "n_rep": q.shape[1] // pool_k.shape[1],
        "max_abs_err": max_abs(out, ref), "tolerance": TOLERANCE[dtype],
        "slot_rel_err": slot_rel_max(out, ref),
        "slot_rel_tolerance": slot_rel_limits[dtype],
        "control_one_page_dropped": {
            "max_abs_err": max_abs(out, dropped),
            "slot_rel_err": slot_rel_max(out, dropped)},
        "library_max_abs_err": max_abs(lib, ref),
        "two_calls_equal": True,
        "kernel_ms": time_ms(kernel, flush),
        "kernel_ms_spin": time_ms(kernel, flush, spin=True),
        "host_us": host_us(kernel),
        "plain_ms": time_ms(lambda: paged_decode_attention_ref(*inputs),
                            flush),
        "library_ms": time_ms(lambda: library_attention(*inputs), flush),
        "bound_ms": decode_bound_ms(q, pool_k, positions),
        "bound_by": "bytes",
    }
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    row["bound_share_spin"] = row["bound_ms"] / row["kernel_ms_spin"]
    return row


def check_decode_row(row: dict, what: str) -> None:
    check(row["max_abs_err"] <= row["tolerance"],
          f"{what}: kernel vs plain max abs {row['max_abs_err']} > "
          f"{row['tolerance']}")
    check(row["slot_rel_err"] <= row["slot_rel_tolerance"],
          f"{what}: kernel vs plain worst slot rel {row['slot_rel_err']} > "
          f"{row['slot_rel_tolerance']}")
    control = row["control_one_page_dropped"]
    check(control["max_abs_err"] > row["tolerance"]
          or control["slot_rel_err"] > row["slot_rel_tolerance"],
          f"{what}: the one-page-dropped control passes the checks "
          f"{control}")


def phase_kernel() -> dict:
    """The serving shape of Qwen3-0.6B, then Qwen3-30B-A3B's heads (n_rep
    8), one slot at 32768 keys, qwen3-14b's heads (n_rep 5) and
    dense-tiny's (D 32). On each of the first three, a control: the
    plain version with one page of the longest slot dropped must fail the
    checks (both readings are printed)."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        inputs = decode_inputs(dtype, seed=1234)
        row = decode_row(inputs, flush)
        row["positions"] = inputs[4].tolist()
        check_decode_row(row, str(dtype))
        row["rows"] = {
            "qwen3_30b_a3b_heads": decode_row(
                decode_inputs(dtype, seed=1236, model=MOE_MODEL), flush),
            "b1_32768_keys": decode_row(
                decode_inputs(dtype, seed=1237, slots=1,
                              max_seq=LONG_CONTEXT,
                              positions=[LONG_CONTEXT - 1]), flush,
                LONG_CONTEXT_SLOT_REL),
        }
        row["geometries"] = {m: paged_geometry(m, dtype, flush)
                             for m in GEOMETRY_MODELS}
        results[row["dtype"]] = row
        emit("kernel_paged_decode", **row)
        for name, r in row["rows"].items():
            check_decode_row(r, f"{dtype} {name}")
        for m, g in row["geometries"].items():
            check(g["max_abs_err"] <= TOLERANCE[dtype],
                  f"{dtype} {m}: kernel vs plain max abs "
                  f"{g['max_abs_err']} > {TOLERANCE[dtype]}")
    return results


def paged_geometry(model: str, dtype: torch.dtype, flush) -> dict:
    """K4 against its plain version at another preset's heads."""
    inputs = decode_inputs(dtype, seed=1235, model=model)
    q, pool_k, _, _, positions = inputs
    out = paged_decode_attention(*inputs)
    ref = paged_decode_attention_ref(*inputs)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"{dtype} {model}: non-finite")
    kernel_ms = time_ms(lambda: paged_decode_attention(*inputs), flush)
    bound = decode_bound_ms(q, pool_k, positions)
    return {"q": list(q.shape), "pool": list(pool_k.shape),
            "n_rep": q.shape[1] // pool_k.shape[1],
            "max_abs_err": max_abs(out, ref), "kernel_ms": kernel_ms,
            "kernel_ms_spin": time_ms(
                lambda: paged_decode_attention(*inputs), flush, spin=True),
            "bound_ms": bound, "bound_share": bound / kernel_ms}


# ---- 4. the flash kernels against their plain versions -----------------------
def flash_inputs(dtype: torch.dtype, seed: int, model: str = MODEL,
                 seq: int = TRAIN_SEQ):
    """q, k, v, dO at the training shape of ``model``'s cell."""
    cfg = model_config(model)
    hq, hkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.actual_head_dim)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(heads):
        return torch.randn(1, heads, seq, d, generator=gen,
                           device="cuda").to(dtype)

    return rnd(hq), rnd(hkv), rnd(hkv), rnd(hq)


def flash_work(kernel: str, q, k):
    """(flops, bytes) of one causal call: 2 flops per multiply-add of its
    products over the visible (query, key) pairs; each input read once,
    each output written once."""
    b, hq, s, d = q.shape
    elem = q.element_size()
    q_bytes = b * hq * s * d * elem
    kv_bytes = b * k.shape[1] * s * d * elem
    row_bytes = 4 * b * hq * s  # one fp32 per query row: lse or delta
    pairs = b * hq * s * (s + 1) // 2
    return {
        # O, LSE from Q, K, V: Q K^T and P V
        "K1": (4 * d * pairs, 2 * q_bytes + 2 * kv_bytes + row_bytes),
        # dQ from Q, K, V, dO, LSE, delta: Q K^T, dO V^T, dS K
        "K2": (6 * d * pairs, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
        # dK, dV from the same: Q K^T, dO V^T, P^T dO, dS^T Q
        "K3": (8 * d * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
    }[kernel]


def flash_timing(kid: str, q, k, kernel_ms: float) -> dict:
    """One causal call's time beside its bound (the larger of its bytes
    over HBM bandwidth and its flops over the dtype's peak), what bounds
    it, the share of the bound the kernel reaches and its TFLOP/s."""
    flops, nbytes = flash_work(kid, q, k)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    bound_ms = 1e3 * max(t_bytes, t_ops)
    return {"kernel_ms": kernel_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_share": bound_ms / kernel_ms,
            "tflops": flops / kernel_ms / 1e9}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def tile_rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest relative L2 error of one TILE-row tile of one head of
    [B, H, S, D] tensors (a ragged last tile is padded with zeros)."""
    batch, heads, seq, _ = b.shape

    def per_tile(x):
        rows = x.float().square().sum(-1)
        rows = F.pad(rows, (0, (-seq) % TILE))
        return rows.view(batch, heads, -1, TILE).sum(-1)

    return float((per_tile(a.float() - b.float()) / per_tile(b)).sqrt().max())


def flash_plain(q, k, v, dout, lse, delta):
    """(out, lse, dQ, dK, dV) of the plain versions."""
    out, out_lse = tf.flash_forward_ref(q, k, v, causal=True)
    dq = tf.flash_dq_ref(q, k, v, dout, lse, delta, causal=True)
    dk, dv = tf.flash_dkv_ref(q, k, v, dout, lse, delta, causal=True)
    return out, out_lse, dq, dk, dv


def flash_errors(got, ref) -> dict:
    """Every reading of (out, lse, dQ, dK, dV) ``got`` against ``ref``."""
    errs = {"lse_max_abs": max_abs(got[1], ref[1])}
    for name, a, b in zip(("out", "dq", "dk", "dv"), got[:1] + got[2:],
                          ref[:1] + ref[2:]):
        errs[f"{name}_max_abs"] = max_abs(a, b)
        errs[f"{name}_rel"] = rel_err(a, b)
        errs[f"{name}_tile_rel"] = tile_rel_max(a, b)
    return errs


def flash_violations(errs: dict, tol: dict) -> list:
    """The readings over their limits, as text (empty when all hold)."""
    limits = {"out_max_abs": tol["out_max_abs"],
              "lse_max_abs": tol["lse_max_abs"], "out_rel": tol["out_rel"]}
    limits["out_tile_rel"] = tol["out_tile_rel"]
    for name in ("dq", "dk", "dv"):
        limits[f"{name}_rel"] = tol["grad_rel"]
        limits[f"{name}_tile_rel"] = tol["grad_tile_rel"]
    return [f"{key} {errs[key]} > {limit}" for key, limit in limits.items()
            if not errs[key] <= limit]


def skip_one_tile(got, q, k, v, dout, lse, delta, scale: float):
    """``got`` (out, lse, dQ, dK, dV) as kernels that skip one tile would
    give it: q head 0's last query tile against key tile 0, where a skip is
    hardest to see (64 of those rows' 8192 keys, 64 of those keys' 8192
    queries), is left out of out (renormalised), dQ, dK and dV."""
    out, out_lse, dq, dk, dv = (t.clone() for t in got)
    seq = q.shape[2]
    rows, cols = slice(seq - TILE, seq), slice(0, TILE)
    qb, dob = q[0, 0, rows].float(), dout[0, 0, rows].float()
    kb, vb = k[0, 0, cols].float(), v[0, 0, cols].float()
    p = torch.exp(qb @ kb.T * scale - lse[0, 0, rows, None])
    ds = p * (dob @ vb.T - delta[0, 0, rows, None]) * scale
    kept = out[0, 0, rows].float() - p @ vb
    out[0, 0, rows] = (kept / (1 - p.sum(-1, keepdim=True))).to(out.dtype)
    dq[0, 0, rows] = (dq[0, 0, rows].float() - ds @ kb).to(dq.dtype)
    dk[0, 0, cols] = (dk[0, 0, cols].float() - ds.T @ qb).to(dk.dtype)
    dv[0, 0, cols] = (dv[0, 0, cols].float() - p.T @ dob).to(dv.dtype)
    return out, out_lse, dq, dk, dv


def lower_precision(q, k, v, dout, lse, delta):
    """The plain versions one step less precise than the kernels: fp32
    with its products in TF32; bf16 with p and dS left unrounded (fp32
    throughout, outputs rounded to bf16)."""
    if q.dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return flash_plain(q, k, v, dout, lse, delta)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    wide = [t.float() for t in (q, k, v, dout)]
    out, out_lse, dq, dk, dv = flash_plain(*wide, lse, delta)
    return (out.to(q.dtype), out_lse, dq.to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def phase_kernel_flash() -> dict:
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = FLASH_TOLERANCE[dtype]
        q, k, v, dout = flash_inputs(dtype, seed=4321)
        scale = 1.0 / q.shape[-1] ** 0.5
        out, lse = tf.flash_forward(q, k, v, causal=True)
        ref_out, ref_lse = tf.flash_forward_ref(q, k, v, causal=True)
        delta = tf.attention_delta(ref_out, dout)
        bwd_args = (q, k, v, dout, ref_lse, delta)
        ref = flash_plain(*bwd_args)
        dq = tf.flash_dq(*bwd_args, causal=True)
        dk, dv = tf.flash_dkv(*bwd_args, causal=True)
        got = (out, lse, dq, dk, dv)
        lib_in = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                                 enable_gqa=True)
        torch.cuda.synchronize()
        for t in got:
            check(bool(torch.isfinite(t).all()), f"{dtype}: non-finite")
        errs = flash_errors(got, ref)
        errs["library_out_max_abs"] = max_abs(lib_out.detach(), ref[0])
        controls = {}
        for name, faulty in (
                ("skip_one_tile",
                 skip_one_tile(got, q, k, v, dout, ref[1], delta, scale)),
                ("lower_precision", lower_precision(*bwd_args))):
            c_errs = flash_errors(faulty, ref)
            controls[name] = {**c_errs,
                              "over_limit": flash_violations(c_errs, tol)}

        def lib_bwd():
            return torch.autograd.grad(lib_out, lib_in, dout,
                                       retain_graph=True)

        reps = 5
        times = {
            "K1": (lambda: tf.flash_forward(q, k, v, causal=True),
                   lambda: tf.flash_forward_ref(q, k, v, causal=True),
                   lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=True, enable_gqa=True)),
            "K2": (lambda: tf.flash_dq(*bwd_args, causal=True),
                   lambda: tf.flash_dq_ref(*bwd_args, causal=True),
                   lib_bwd),
            "K3": (lambda: tf.flash_dkv(*bwd_args, causal=True),
                   lambda: tf.flash_dkv_ref(*bwd_args, causal=True),
                   lib_bwd),
        }
        row = {"dtype": str(dtype).replace("torch.", ""),
               "shape": {"q": list(q.shape), "kv": list(k.shape)},
               "causal": True, "tolerance": tol, **errs,
               "controls": controls, "kernels": {}}
        lib_bwd_ms = None
        for kid, (kernel_fn, plain_fn, lib_fn) in times.items():
            if kid == "K3" and lib_bwd_ms is not None:
                lib_ms = lib_bwd_ms  # one backward call computes dQ, dK, dV
            else:
                lib_ms = time_ms(lib_fn, flush, reps)
            if kid == "K2":
                lib_bwd_ms = lib_ms
            row["kernels"][kid] = {
                **flash_timing(kid, q, k, time_ms(kernel_fn, flush, reps)),
                "plain_ms": time_ms(plain_fn, flush, reps),
                "library_ms": lib_ms,
            }
        # no atomics: a second run of K2 and K3 gives the same bits
        again = (tf.flash_dq(*bwd_args, causal=True),
                 *tf.flash_dkv(*bwd_args, causal=True))
        row["bitwise_deterministic"] = all(
            bool(torch.equal(a, b)) for a, b in zip(again, (dq, dk, dv)))
        del again
        if dtype == torch.bfloat16:
            row["moe_shape"] = flash_moe_shape(flush, reps)
        row["geometries"] = {m: flash_geometry(m, dtype)
                             for m in GEOMETRY_MODELS}
        del lib_out, lib_in
        results[row["dtype"]] = row
        emit("kernel_flash", **row)
        violations = flash_violations(errs, tol)
        check(not violations, f"{dtype}: kernels vs plain: {violations}")
        seen = {v.split()[0] for v in controls["skip_one_tile"]["over_limit"]}
        want = {"out_tile_rel", "dq_tile_rel", "dk_tile_rel", "dv_tile_rel"}
        check(want <= seen, f"{dtype}: a skipped tile passes the checks of "
                            f"{sorted(want - seen)}")
        check(row["bitwise_deterministic"],
              f"{dtype}: two runs of K2 and K3 differ")
        if "moe_shape" in row:
            check(not row["moe_shape"]["over_limit"],
                  f"{dtype}: K1-K3 vs plain at the MoE shape: "
                  f"{row['moe_shape']['over_limit']}")
        for m, g in row["geometries"].items():
            check(not g["over_limit"],
                  f"{dtype}: K1-K3 vs plain at {m}'s heads: "
                  f"{g['over_limit']}")
    return results


def flash_geometry(model: str, dtype: torch.dtype) -> dict:
    """K1, K2 and K3 against their plain versions at another preset's
    heads (B 1, S GEOMETRY_SEQ, causal), under FLASH_TOLERANCE."""
    q, k, v, dout = flash_inputs(dtype, seed=4323, model=model,
                                 seq=GEOMETRY_SEQ)
    out, lse = tf.flash_forward(q, k, v, causal=True)
    ref_out, ref_lse = tf.flash_forward_ref(q, k, v, causal=True)
    bwd_args = (q, k, v, dout, ref_lse, tf.attention_delta(ref_out, dout))
    got = (out, lse, tf.flash_dq(*bwd_args, causal=True),
           *tf.flash_dkv(*bwd_args, causal=True))
    ref = flash_plain(*bwd_args)
    torch.cuda.synchronize()
    for t in got:
        check(bool(torch.isfinite(t).all()), f"{dtype} {model}: non-finite")
    errs = flash_errors(got, ref)
    return {"q": list(q.shape), "kv": list(k.shape), **errs,
            "over_limit": flash_violations(errs, FLASH_TOLERANCE[dtype])}


def flash_moe_shape(flush, reps: int) -> dict:
    """bf16 K1, K2 and K3 at Qwen3-30B-A3B's training shape (B 1, Hq 32,
    Hkv 4, S 4096, D 128, causal) against their plain versions, with their
    times beside the plain versions' and the SDPA forward's (K1) and
    backward's (K2, K3)."""
    tol = FLASH_TOLERANCE[torch.bfloat16]
    q, k, v, dout = flash_inputs(torch.bfloat16, seed=4322, model=MOE_MODEL,
                                 seq=MOE_TRAIN_SEQ)
    ref_out, ref_lse = tf.flash_forward_ref(q, k, v, causal=True)
    bwd_args = (q, k, v, dout, ref_lse, tf.attention_delta(ref_out, dout))
    out, lse = tf.flash_forward(q, k, v, causal=True)
    got = (tf.flash_dq(*bwd_args, causal=True),
           *tf.flash_dkv(*bwd_args, causal=True))
    ref = (tf.flash_dq_ref(*bwd_args, causal=True),
           *tf.flash_dkv_ref(*bwd_args, causal=True))
    torch.cuda.synchronize()
    row = {"shape": {"q": list(q.shape), "kv": list(k.shape)},
           "causal": True}
    check(bool(torch.isfinite(out).all() and torch.isfinite(lse).all()),
          "MoE shape: non-finite out or lse")
    row["lse_max_abs"] = max_abs(lse, ref_lse)
    row["out_max_abs"] = max_abs(out, ref_out)
    row["out_rel"] = rel_err(out, ref_out)
    row["out_tile_rel"] = tile_rel_max(out, ref_out)
    limits = {key: tol[key] for key in ("lse_max_abs", "out_max_abs",
                                        "out_rel", "out_tile_rel")}
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        check(bool(torch.isfinite(a).all()), f"MoE shape: non-finite {name}")
        row[f"{name}_max_abs"] = max_abs(a, b)
        row[f"{name}_rel"] = rel_err(a, b)
        row[f"{name}_tile_rel"] = tile_rel_max(a, b)
        limits[f"{name}_rel"] = tol["grad_rel"]
        limits[f"{name}_tile_rel"] = tol["grad_tile_rel"]
    row["over_limit"] = [f"{key} {row[key]} > {limit}"
                         for key, limit in limits.items()
                         if not row[key] <= limit]
    del out, lse, got, ref
    lib_in = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                             enable_gqa=True)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(lib_out, lib_in, dout,
                                                     retain_graph=True),
                         flush, reps)
    lib_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), flush, reps)
    calls = {
        "K1": (lambda: tf.flash_forward(q, k, v, causal=True),
               lambda: tf.flash_forward_ref(q, k, v, causal=True),
               lib_fwd_ms),
        "K2": (lambda: tf.flash_dq(*bwd_args, causal=True),
               lambda: tf.flash_dq_ref(*bwd_args, causal=True), lib_bwd_ms),
        "K3": (lambda: tf.flash_dkv(*bwd_args, causal=True),
               lambda: tf.flash_dkv_ref(*bwd_args, causal=True), lib_bwd_ms),
    }
    row["kernels"] = {
        kid: {**flash_timing(kid, q, k, time_ms(kernel, flush, reps)),
              "plain_ms": time_ms(plain, flush, reps), "library_ms": lib_ms}
        for kid, (kernel, plain, lib_ms) in calls.items()}
    return row


# ---- 5. full-width decode parity, kernel vs gather path ----------------------
def phase_decode_parity() -> LlamaForCausalLM:
    cfg = model_config(MODEL, dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = LlamaForCausalLM.from_params(init_params(cfg, gen, "cuda"), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        t0 = time.monotonic()
        via_kernel = teacher_forced_decode_paged(
            model, cfg, tokens, page_size=PAGE_SIZE)
        torch.cuda.synchronize()
        kernel_s = time.monotonic() - t0
        via_gather = teacher_forced_decode_paged(
            model, cfg, tokens, page_size=PAGE_SIZE, kernel=False)
        dense = teacher_forced_decode(model, cfg, tokens)
    err = float((via_kernel - via_gather).abs().max())
    check(bool(torch.isfinite(via_kernel).all()), "non-finite logits")
    check(err <= PARITY_TOLERANCE,
          f"kernel vs gather max |dlogit| {err} > {PARITY_TOLERANCE}")
    emit("decode_parity", model=MODEL, layers=cfg.num_hidden_layers,
         dtype="float32", tokens=list(tokens.shape),
         max_abs_logit_diff=err, tolerance=PARITY_TOLERANCE,
         gather_equals_dense=bool(torch.equal(via_gather, dense)),
         kernel_run_s=kernel_s)
    return model


# ---- 6. serving ---------------------------------------------------------------
def traffic(vocab: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 256).tolist()
    prompts = []
    for i in range(16):
        if i % 2 == 0:
            tail = int(rng.integers(1, 400 - 256 + 1))
            prompts.append(prefix + rng.integers(0, vocab, tail).tolist())
        else:
            n = int(rng.integers(100, 401))
            prompts.append(rng.integers(0, vocab, n).tolist())
    return prompts


def serve(model, cfg, prompts, paged_kernel):
    eng = InferenceEngine(
        model, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
        prefill_len=PREFILL_LEN, sampling=SamplingParams(temperature=0.0),
        cache_layout="paged", page_size=PAGE_SIZE, prefix_cache=True,
        paged_kernel=paged_kernel)
    ptrs = (eng.cache.k.data_ptr(), eng.cache.v.data_ptr())
    ids = [eng.submit(p, max_new_tokens=64) for p in prompts]
    decode_tokens, decode_s = 0, 0.0
    t0 = time.monotonic()
    while eng.pending:
        prefills, emitted = eng.metrics.prefill_calls, \
            eng.metrics.tokens_generated
        ts = time.monotonic()
        eng.step()  # ends in the host copy of the sampled tokens
        if eng.metrics.prefill_calls == prefills:
            decode_s += time.monotonic() - ts
            decode_tokens += eng.metrics.tokens_generated - emitted
    wall = time.monotonic() - t0
    results = [eng.result(i) for i in ids]
    stats = {
        "wall_s": wall,
        "tokens_generated": eng.metrics.tokens_generated,
        "decode_steps": eng.metrics.decode_steps,
        "tokens_per_s": eng.metrics.tokens_generated / wall,
        "decode_tokens_per_s": decode_tokens / decode_s if decode_s else None,
        "mean_ttft_s": eng.metrics.snapshot()["mean_ttft_s"],
        "tpot_p50_s": eng.metrics.hist["tpot"].quantile(0.5),
        "prefix_hits": eng.metrics.prefix_hits,
        "prefill_tokens_saved": eng.metrics.prefill_tokens_saved,
    }
    return eng, results, ptrs, stats


def phase_serve(model32) -> int:
    cfg = model_config(MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM.from_params(dict(model32.named_parameters()),
                                         cfg)
    prompts = traffic(cfg.vocab_size)
    with torch.inference_mode():
        _build.reset_launch_counts()
        eng, results, ptrs, stats = serve(model, cfg, prompts, None)
        launches = _build.launch_counts["paged_decode"]
        _, ref_results, _, ref_stats = serve(model, cfg, prompts, False)
    outcomes = [r.outcome for r in results]
    check(all(o == "ok" for o in outcomes), f"outcomes {outcomes}")
    check(stats["prefix_hits"] > 0, "no prefix hit")
    eng.allocator.check_conservation()
    check((eng.cache.k.data_ptr(), eng.cache.v.data_ptr()) == ptrs,
          "the page pools moved")
    want = cfg.num_hidden_layers * stats["decode_steps"]
    check(launches == want,
          f"paged_decode launched {launches} times, want {want}")
    same_req = sum(a.tokens == b.tokens for a, b in zip(results, ref_results))
    same_tok = sum(x == y for a, b in zip(results, ref_results)
                   for x, y in zip(a.tokens, b.tokens))
    emit("serve", model=MODEL, dtype="bfloat16", slots=SLOTS,
         max_seq=MAX_SEQ, prefill_len=PREFILL_LEN, page_size=PAGE_SIZE,
         requests=len(prompts), prompt_lens=[len(p) for p in prompts],
         outcomes=sorted(set(outcomes)), kernel_launches=launches,
         launches_per_decode_step=launches / stats["decode_steps"],
         **stats,
         gather_path={k: ref_stats[k] for k in
                      ("wall_s", "tokens_per_s", "decode_tokens_per_s",
                       "mean_ttft_s", "decode_steps")},
         greedy_agreement={"requests": f"{same_req}/{len(results)}",
                           "tokens": same_tok / sum(len(r.tokens)
                                                    for r in results)})
    return launches


def profiled(run, steps: int) -> dict:
    """torch.profiler over ``run()`` (``steps`` steps, ending in a
    synchronise): wall and device ms per step, the device's busy share
    (the kernels' summed device time over the window's wall time; one
    stream, so no overlap), launches per step and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    k4 = [e for e in kernels if "paged_decode" in e.key]
    return dict(
        wall_ms_per_step=1e3 * wall / steps,
        device_ms_per_step=1e-3 * device_us / steps,
        device_busy_share=(1e-6 * device_us / wall) if wall else None,
        kernel_launches_per_step=sum(e.count for e in kernels) / steps,
        k4_device_ms_per_step=1e-3 * sum(e.self_device_time_total
                                         for e in k4) / steps,
        k4_kernel_launches_per_step=sum(e.count for e in k4) / steps,
        top_kernels=[{"name": e.key[:80], "calls_per_step": e.count / steps,
                      "ms_per_step": 1e-3 * e.self_device_time_total / steps}
                     for e in top])


def phase_profile(model32) -> None:
    cfg = model_config(MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM.from_params(dict(model32.named_parameters()),
                                         cfg)
    profile_decode(model, cfg, "profile")


def profile_decode(model, cfg, phase: str) -> None:
    """Where a decode step's time goes: torch.profiler over a steady
    window of decode ticks of the serving engine (8 active slots, no
    admission inside the window). Device busy share = the kernels' summed
    device time over the window's wall time (one stream: no overlap)."""
    window = 16
    with torch.inference_mode():
        eng = InferenceEngine(
            model, cfg, max_slots=SLOTS, max_seq=MAX_SEQ,
            prefill_len=PREFILL_LEN,
            sampling=SamplingParams(temperature=0.0), cache_layout="paged",
            page_size=PAGE_SIZE)
        for p in traffic(cfg.vocab_size)[:SLOTS]:
            eng.submit(p, max_new_tokens=64)
        for _ in range(4):  # admission and warm decode ticks
            eng.step()
        torch.cuda.synchronize()

        def run():
            for _ in range(window):
                eng.step()

        stats = profiled(run, window)
    check(eng.metrics.prefill_calls == 1, "admission inside the window")
    emit(phase, window_decode_steps=window, **stats)


# ---- 8. the presets' other head geometries through K4 --------------------------
def phase_geometry_serve() -> dict:
    """dense-tiny (head_dim 32): the paged engine through K4 against the
    dense engine, greedy tokens equal. qwen3-14b's width cut to 2 layers
    (n_rep 5): teacher-forced paged decode through K4 against the gather
    path. Both fp32, random weights from a seeded generator."""
    cfg = model_config("dense-tiny", dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = LlamaForCausalLM.from_params(init_params(cfg, gen, "cuda"), cfg)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(3, 120, 12)]
    runs = {}
    with torch.inference_mode():
        for layout in ("paged", "dense"):
            eng = InferenceEngine(
                model, cfg, max_slots=4, max_seq=256, prefill_len=128,
                sampling=SamplingParams(temperature=0.0),
                cache_layout=layout, page_size=PAGE_SIZE)
            _build.reset_launch_counts()
            ids = [eng.submit(p, max_new_tokens=32) for p in prompts]
            results = eng.run()
            runs[layout] = ([results[i] for i in ids],
                            _build.launch_counts["paged_decode"],
                            eng.metrics.decode_steps)
            if layout == "paged":
                eng.allocator.check_conservation()
    (paged, k4, steps), (dense, k4_dense, _) = runs["paged"], runs["dense"]
    outcomes = [r.outcome for r in paged + dense]
    check(all(o == "ok" for o in outcomes), f"outcomes {outcomes}")
    same = [a.tokens == b.tokens for a, b in zip(paged, dense)]
    check(all(same), f"dense-tiny: paged (K4) vs dense greedy tokens differ "
                     f"in {same.count(False)} of {len(same)} requests")
    layers = cfg.num_hidden_layers
    check(k4 == layers * steps and k4_dense == 0,
          f"dense-tiny: K4 launched {k4} times over {steps} decode steps "
          f"(dense: {k4_dense}), want {layers} a step")
    row = {"dense_tiny": {
        "heads": [cfg.num_attention_heads, cfg.num_key_value_heads],
        "head_dim": cfg.actual_head_dim, "layers": layers,
        "dtype": "float32", "requests": len(prompts),
        "paged_equals_dense": True, "decode_steps": steps,
        "k4_launches": k4}}
    del model

    cfg = model_config("qwen3-14b", dtype=torch.float32,
                       num_hidden_layers=GEOMETRY_PARITY_LAYERS)
    gen.manual_seed(0)
    model = LlamaForCausalLM.from_params(init_params(cfg, gen, "cuda"), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        _build.reset_launch_counts()
        via_kernel = teacher_forced_decode_paged(model, cfg, tokens,
                                                 page_size=PAGE_SIZE)
        torch.cuda.synchronize()
        k4 = _build.launch_counts["paged_decode"]
        via_gather = teacher_forced_decode_paged(
            model, cfg, tokens, page_size=PAGE_SIZE, kernel=False)
    err = float((via_kernel - via_gather).abs().max())
    check(bool(torch.isfinite(via_kernel).all()), "qwen3-14b: non-finite")
    # prefill_len 1: each of the 64 calls is one token a slot, through K4
    check(k4 == cfg.num_hidden_layers * tokens.shape[1],
          f"qwen3-14b: K4 launched {k4} times")
    check(err <= PARITY_TOLERANCE,
          f"qwen3-14b: K4 vs gather max |dlogit| {err} > {PARITY_TOLERANCE}")
    row["qwen3_14b"] = {
        "heads": [cfg.num_attention_heads, cfg.num_key_value_heads],
        "head_dim": cfg.actual_head_dim, "hidden": cfg.hidden_size,
        "layers": cfg.num_hidden_layers, "dtype": "float32",
        "tokens": list(tokens.shape), "max_abs_logit_diff": err,
        "tolerance": PARITY_TOLERANCE, "k4_launches": k4}
    del model
    emit("geometry_serve", **row)
    return row


# ---- 9. full-width training parity, flash kernels vs sdpa --------------------
def phase_train_parity() -> None:
    cfg = model_config(MODEL, dtype=torch.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, "cuda", requires_grad=True)
    b, s = 2, 1024
    tokens = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                           device="cuda")
    mb = {"input_ids": tokens[:, :-1], "target_ids": tokens[:, 1:],
          "position_ids": torch.arange(s, device="cuda")}
    leaves = tree_leaves(params)
    runs = {}
    for backend in ("flash", "sdpa"):
        loss_fn = make_loss_fn(cfg, attention_backend=backend,
                               gradient_checkpointing=True)
        _build.reset_launch_counts()
        t0 = time.monotonic()
        loss, _ = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[backend] = (float(loss.detach()), grads, dict(_build.launch_counts),
                         time.monotonic() - t0)
    (loss_f, g_f, launches_f, s_f), (loss_s, g_s, launches_s, s_s) = (
        runs["flash"], runs["sdpa"])
    norm_f = float(torch.sqrt(sum((g.float() ** 2).sum() for g in g_f)))
    norm_s = float(torch.sqrt(sum((g.float() ** 2).sum() for g in g_s)))
    diff = float(torch.sqrt(sum(((a - c).float() ** 2).sum()
                                for a, c in zip(g_f, g_s))))
    per_leaf = max(rel_err(a, c) for a, c in zip(g_f, g_s))
    d_loss = abs(loss_f - loss_s)
    check(all(bool(torch.isfinite(g).all()) for g in g_f), "non-finite grad")
    layers = cfg.num_hidden_layers
    want = {tf.K1_NAME: 2 * layers, tf.K2_NAME: layers, tf.K3_NAME: layers}
    check(launches_f == want, f"flash launches {launches_f}, want {want}")
    check(not launches_s, f"sdpa launched kernels {launches_s}")
    check(d_loss <= TRAIN_PARITY["loss_abs"],
          f"|dloss| {d_loss} > {TRAIN_PARITY['loss_abs']}")
    check(abs(norm_f - norm_s) / norm_s <= TRAIN_PARITY["grad_rel"],
          f"grad norms {norm_f} vs {norm_s}")
    check(diff / norm_s <= TRAIN_PARITY["grad_rel"],
          f"|g_flash - g_sdpa| / |g_sdpa| {diff / norm_s}")
    emit("train_parity", model=MODEL, layers=layers, dtype="float32",
         tokens=[b, s], gradient_checkpointing=True,
         loss_flash=loss_f, loss_sdpa=loss_s, loss_abs_diff=d_loss,
         grad_norm_flash=norm_f, grad_norm_sdpa=norm_s,
         grad_norm_rel_diff=abs(norm_f - norm_s) / norm_s,
         grad_rel_l2_diff=diff / norm_s, worst_leaf_rel_diff=per_leaf,
         tolerance=TRAIN_PARITY, flash_launches=launches_f,
         flash_s=s_f, sdpa_s=s_s)


# ---- 10. training on the headline row ------------------------------------------
def phase_train():
    cfg = make_bench_args(MODEL, seq=TRAIN_SEQ, gc=True)
    res = benchmark_config(cfg, warmup=TRAIN_WARMUP, steps=TRAIN_STEPS,
                           before_window=_build.reset_launch_counts)
    launches = dict(_build.launch_counts)
    trainer = res.pop("trainer")
    check(trainer.attention_backend == "flash",
          f"attention backend {trainer.attention_backend}")
    losses = res["warmup_losses"] + res["losses"]
    check(all(np.isfinite(losses)), f"losses {losses}")
    check(not any(res["update_skipped"]),
          f"update_skipped {res['update_skipped']}")
    layers = trainer.model_cfg.num_hidden_layers
    per_step = {name: launches.get(name, 0) / TRAIN_STEPS
                for name in (tf.K1_NAME, tf.K2_NAME, tf.K3_NAME)}
    want = {tf.K1_NAME: 2 * layers, tf.K2_NAME: layers, tf.K3_NAME: layers}
    check(per_step == want, f"launches per step {per_step}, want {want}")
    emit("train", model=MODEL, sequence_length=cfg.sequence_length,
         micro_batch_size=cfg.micro_batch_size,
         gradient_checkpointing=cfg.gradient_checkpointing,
         dtype=cfg.dtype, attention_backend=trainer.attention_backend,
         warmup_steps=TRAIN_WARMUP, timed_steps=TRAIN_STEPS,
         peak_flops=trainer.peak_flops(), launches=launches,
         launches_per_step=per_step, **res)
    return trainer, launches


def phase_train_profile(trainer, phase: str = "train_profile") -> None:
    def run():
        for _ in range(PROFILE_STEPS):
            trainer.step()

    emit(phase, window_train_steps=PROFILE_STEPS,
         **profiled(run, PROFILE_STEPS))


# ---- 12. the grouped-MLP kernels against their plain versions -----------------
def gmlp_inputs(shape: str, dtype: torch.dtype, seed: int):
    """(x, counts, wg, wu, wd, dO) at one of GMLP_SHAPES. Counts come from
    routing seeded hidden states through a seeded router, as a layer
    routes them; the train shape also gets one expert at 0 and one at C.
    x and dO are random in every row, past the counts too, so the
    kernels' masks are what keeps those rows out."""
    cfg = model_config(MOE_MODEL)
    e, k, h, i = (cfg.num_experts, cfg.num_experts_per_tok,
                  cfg.hidden_size, cfg.moe_intermediate_size)
    groups, tokens, cf, _ = GMLP_SHAPES[shape]
    cap = expert_capacity(tokens, e, k, cf)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device="cuda") * scale).to(
            dtype)

    hidden = torch.randn(groups, tokens, h, generator=gen, device="cuda")
    router = torch.randn(h, e, generator=gen, device="cuda") * 0.02
    routing, _ = top_k_routing_indexed(hidden @ router, k, cap)
    counts = slot_fill_counts_indexed(routing, e, cap)
    if shape == "train":
        counts[0], counts[1] = 0, cap
    x = rnd(e, groups, cap, h)
    wg, wu = rnd(e, h, i, scale=h ** -0.5), rnd(e, h, i, scale=h ** -0.5)
    wd = rnd(e, i, h, scale=i ** -0.5)
    return x, counts.contiguous(), wg, wu, wd, rnd(e, groups, cap, h)


def slot_tile_rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest relative L2 error of one TILE-row slot tile of one
    (expert, group) of [E, G, C, H] tensors (all-zero tiles skipped)."""
    e, g, c, _ = b.shape
    pad = (-c) % TILE

    def per_tile(x):
        rows = F.pad(x.float().square().sum(-1), (0, pad))
        return rows.view(e, g, -1, TILE).sum(-1)

    return worst_ratio(per_tile(a.float() - b.float()), per_tile(b))


def expert_rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest relative L2 error of one expert's weight gradient."""
    return worst_ratio((a.float() - b.float()).square().flatten(1).sum(-1),
                       b.float().square().flatten(1).sum(-1))


def worst_ratio(num: torch.Tensor, den: torch.Tensor) -> float:
    ratios = (num[den > 0] / den[den > 0]).sqrt()
    return float(ratios.max()) if ratios.numel() else 0.0


def gmlp_errors(got: dict, ref: dict) -> dict:
    """Every reading of the tensors ``got`` against ``ref`` (same keys)."""
    errs = {}
    for name, want in ref.items():
        a = got[name]
        errs[f"{name}_max_abs"] = max_abs(a, want)
        errs[f"{name}_max_abs_rel"] = max_abs(a, want) / max(
            float(want.float().abs().max()), 1e-30)
        errs[f"{name}_rel"] = rel_err(a, want)
        errs[f"{name}_tile_rel"] = (expert_rel_max(a, want)
                                    if name.startswith("dw")
                                    else slot_tile_rel_max(a, want))
    return errs


def gmlp_violations(errs: dict, tol: dict) -> list:
    return [f"{key} {v} > {tol[key.split('_', 1)[1]]}"
            for key, v in errs.items()
            if not key.endswith("_max_abs") and not v <= tol[
                key.split("_", 1)[1]]]


def gmlp_work(kid: str, x, counts, wg) -> tuple:
    """(flops, bytes) of one launch's own work (2 flops per multiply-add;
    each input read once: the counted rows of x, dO, s, dG, dU, the
    weights of the experts that have rows; each output written once):
      K5:    x Wg, x Wu, h Wd (6 H I a row); out over every slot;
      grads: x Wg, x Wu, dO Wd^T (6 H I a row); s, dG, dU over the rows;
      K6:    dG Wg^T, dU Wu^T (4 H I a row) from dG, dU and two weights;
             dx over every slot;
      K7:    x^T dG, x^T dU, s^T dO (6 H I a row) from x, dO, s, dG, dU;
             the three gradients of every expert;
      backward: grads + K6 + K7, what _GroupedSwiGLU.backward launches."""
    if kid == "backward":
        parts = [gmlp_work(k, x, counts, wg) for k in ("grads", "K6", "K7")]
        return tuple(sum(p[n] for p in parts) for n in range(2))
    e, g, c, h = x.shape
    i = wg.shape[-1]
    elem = x.element_size()
    rows = int(counts.sum())
    weight = h * i * elem * int((counts.sum(1) > 0).sum())
    x_rows = rows * h * elem
    i_rows = rows * i * elem
    full = e * g * c * h * elem
    flops, nbytes = {
        "K5": (6 * h * i * rows, 3 * weight + x_rows + full),
        "grads": (6 * h * i * rows, 3 * weight + 2 * x_rows + 3 * i_rows),
        "K6": (4 * h * i * rows, 2 * weight + 2 * i_rows + full),
        "K7": (6 * h * i * rows,
               2 * x_rows + 3 * i_rows + 3 * e * h * i * elem),
    }[kid]
    return flops, nbytes + 4 * e * g  # counts


def gmlp_bound(kid: str, x, counts, wg) -> tuple:
    """(bound ms, what bounds it): the larger of the launch's bytes over
    HBM bandwidth and its flops over the dtype's peak (gmlp_work)."""
    flops, nbytes = gmlp_work(kid, x, counts, wg)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[x.dtype]
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def skip_one_slot_tile(got: dict, args, counts) -> dict:
    """``got`` as kernels that skip one filled slot tile would give it:
    the last (partial) tile of the (expert, group) with the most rows,
    where the skip is least visible in the weight gradients, is left out
    of out and dx (zero rows) and of dWg, dWu, dWd."""
    x, _, wg, wu, wd, dout = args
    flat = int(torch.argmax(counts.flatten()))
    e, g = divmod(flat, counts.shape[1])
    n = int(counts[e, g])
    t0 = (n - 1) // TILE * TILE
    out = {k: v.clone() for k, v in got.items()}
    for name in ("out", "dx"):
        if name in out:
            out[name][e, g, t0:n] = 0
    if "dwg" in out:
        cut = counts.clone()
        cut[e, g] = t0
        full = gm.grouped_mlp_dw_ref(x, counts, wg, wu, wd, dout)
        part = gm.grouped_mlp_dw_ref(x, cut, wg, wu, wd, dout)
        for name, a, b in zip(("dwg", "dwu", "dwd"), full, part):
            out[name] = (out[name].float() - (a.float() - b.float())).to(
                a.dtype)
    return out


def gmlp_backward(args):
    """What _GroupedSwiGLU.backward launches: the grads pass, K6, K7."""
    grads = gm.grouped_mlp_block_grads(*args)
    return (*grads, gm.grouped_mlp_dx(*args, grads),
            *gm.grouped_mlp_dw(*args, grads))


def gmlp_case(shape: str, dtype: torch.dtype, flush) -> dict:
    args = gmlp_inputs(shape, dtype, seed=2024)
    x, counts, wg, wu, wd, dout = args
    fwd_args = args[:5]
    bwd = GMLP_SHAPES[shape][3]
    tol = GMLP_TOLERANCE[dtype]
    past = (torch.arange(x.shape[2], device="cuda")[None, None]
            >= counts[..., None])
    got = {"out": gm.grouped_mlp_forward(*fwd_args)}
    ref = {"out": gm.masked_grouped_mlp(*fwd_args)}
    deterministic = None
    if bwd:
        backward = gmlp_backward(args)
        grads = backward[:3]
        ref_grads = gm.grouped_mlp_block_grads_ref(*args)
        # the workspace rows of slot tiles past a count are never written
        # (K6 and K7 never read them): both sides compare as zeros there
        for name, a, b in zip(("s", "dg", "du"), grads, ref_grads):
            got[name] = a.masked_fill(past[..., None], 0)
            ref[name] = b.masked_fill(past[..., None], 0)
        got["dx"] = backward[3]
        got["dwg"], got["dwu"], got["dwd"] = backward[4:]
        ref["dx"] = gm.grouped_mlp_dx_ref(*args, ref_grads)
        ref["dwg"], ref["dwu"], ref["dwd"] = gm.grouped_mlp_dw_ref(
            *args, ref_grads)
        # no atomics: a second backward gives the same bits
        again = gmlp_backward(args)
        deterministic = all(
            bool(torch.equal(a, b)) for a, b in zip(
                [got[n] for n in ("dx", "dwg", "dwu", "dwd")], again[3:]))
        deterministic &= all(
            bool(torch.equal(a.masked_fill(past[..., None], 0), got[n]))
            for a, n in zip(again[:3], ("s", "dg", "du")))
        del backward, again, ref_grads
    torch.cuda.synchronize()
    for name, t in got.items():
        check(bool(torch.isfinite(t).all()), f"{shape} {dtype}: {name}")
    zeros = all(bool((got[n][past] == 0).all()) for n in ("out", "dx")
                if n in got)
    errs = gmlp_errors(got, ref)
    controls = {}
    faulty = {"skip_one_tile": skip_one_slot_tile(got, args, counts)}
    if bwd:
        # a K7 that forgets the dO mask sums the covering tiles' rows
        tiles = torch.clamp((counts + TILE - 1) // TILE * TILE,
                            max=x.shape[2]).to(torch.int32)
        unmasked = dict(got)
        unmasked["dwg"], unmasked["dwu"], unmasked["dwd"] = (
            gm.grouped_mlp_dw_ref(x, tiles, wg, wu, wd, dout))
        faulty["dw_unmasked_dout"] = unmasked
    for name, f in faulty.items():
        c_errs = gmlp_errors(f, ref)
        controls[name] = {**c_errs, "over_limit": gmlp_violations(c_errs,
                                                                  tol)}
    reps = 5
    row = {"shape": shape, "dtype": str(dtype).replace("torch.", ""),
           "x": list(x.shape), "hidden_intermediate": list(wg.shape[1:]),
           "rows": int(counts.sum()), "filled_experts": int(
               (counts.sum(1) > 0).sum()),
           "structural_zeros": zeros, "bitwise_deterministic": deterministic,
           "tolerance": tol, **errs, "controls": controls, "kernels": {}}
    e, g, c, h = x.shape
    lib_in = [t.detach().clone().requires_grad_() for t in
              (x.view(e, g * c, h), wg, wu, wd)]
    lib_out = moe_mlp(*lib_in)

    def lib_bwd():
        return torch.autograd.grad(lib_out, lib_in, dout.view(e, g * c, h),
                                   retain_graph=True)

    timed = {"K5": (lambda: gm.grouped_mlp_forward(*fwd_args),
                    lambda: gm.masked_grouped_mlp(*fwd_args),
                    lambda: moe_mlp(x.view(e, g * c, h), wg, wu, wd))}
    if bwd:
        # each launch alone, from the grads pass's (s, dG, dU); then the
        # three together, as the autograd backward runs them. Each launch's
        # library yardstick is the cuBLAS batched products of its own
        # function over every slot; the einsum path's one autograd backward
        # (dx and dW) is the yardstick of the whole backward.
        gc = g * c
        s_, dg_, du_ = (got[n].view(e, gc, -1) for n in ("s", "dg", "du"))
        x_, do_ = x.view(e, gc, h), dout.view(e, gc, h)

        def lib_dx():
            return torch.baddbmm(torch.bmm(dg_, wg.mT), du_, wu.mT)

        def lib_dw():
            return (torch.bmm(x_.mT, dg_), torch.bmm(x_.mT, du_),
                    torch.bmm(s_.mT, do_))

        timed["grads"] = (lambda: gm.grouped_mlp_block_grads(*args),
                          lambda: gm.grouped_mlp_block_grads_ref(*args),
                          None)
        timed["K6"] = (lambda: gm.grouped_mlp_dx(*args, grads),
                       lambda: gm.grouped_mlp_dx_ref(*args, grads), lib_dx)
        timed["K7"] = (lambda: gm.grouped_mlp_dw(*args, grads),
                       lambda: gm.grouped_mlp_dw_ref(*args, grads), lib_dw)
        timed["backward"] = (lambda: gmlp_backward(args),
                             lambda: (gm.grouped_mlp_dx_ref(*args),
                                      gm.grouped_mlp_dw_ref(*args)),
                             lib_bwd)
    lib_ms = {}
    for kid, (kernel_fn, plain_fn, lib_fn) in timed.items():
        bound_ms, bound_by = gmlp_bound(kid, x, counts, wg)
        if lib_fn is not None and lib_fn not in lib_ms:
            lib_ms[lib_fn] = time_ms(lib_fn, flush, reps)
        row["kernels"][kid] = {
            "kernel_ms": time_ms(kernel_fn, flush, reps),
            "plain_ms": time_ms(plain_fn, flush, reps),
            "library_ms": lib_ms.get(lib_fn), "bound_ms": bound_ms,
            "bound_by": bound_by}
        row["kernels"][kid]["bound_share"] = (
            bound_ms / row["kernels"][kid]["kernel_ms"])
    if bwd:
        k = row["kernels"]
        row["grads_pass_ms"] = k["grads"]["kernel_ms"]
        row["grads_pass_bound_ms"] = k["grads"]["bound_ms"]
        row["backward_ms"] = k["backward"]["kernel_ms"]
        row["backward_bound_ms"] = k["backward"]["bound_ms"]
    row["library"] = ("K5: the einsum path (three cuBLAS bmm calls and "
                      "the swiglu kernels); K6: bmm + baddbmm (dG Wg^T + "
                      "dU Wu^T); K7: three bmm (x^T dG, x^T dU, s^T dO); "
                      "backward: the einsum path's autograd; every slot, "
                      "several calls, not one")
    del lib_out, lib_in
    emit("kernel_grouped_mlp", **row)
    violations = gmlp_violations(errs, tol)
    check(zeros, f"{shape} {dtype}: rows past the counts are not zero")
    check(not violations, f"{shape} {dtype}: kernels vs plain: {violations}")
    check(deterministic is not False,
          f"{shape} {dtype}: two runs of the backward differ")
    for name, c in controls.items():
        check(bool(c["over_limit"]),
              f"{shape} {dtype}: the {name} control passes every check")
    if bwd:
        check(any(v.startswith("dw") for v in
                  controls["dw_unmasked_dout"]["over_limit"]),
              f"{shape} {dtype}: unmasked dO passes the dW checks")
    return row


def phase_kernel_grouped_mlp(dtypes=(torch.float32, torch.bfloat16)) -> dict:
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    results = {}
    for shape in GMLP_SHAPES:
        for dtype in dtypes:
            row = gmlp_case(shape, dtype, flush)
            results[(shape, row["dtype"])] = row
            torch.cuda.empty_cache()
    return results


# ---- 13. Qwen3-30B-A3B decode parity, K4 + K5 vs gather + einsum -------------------
def moe_model(dtype: torch.dtype, layers=None, **overrides):
    """(config, model) of Qwen3-30B-A3B with random weights drawn in place
    from a seeded generator, the grouped-MLP kernels on."""
    cfg = model_config(MOE_MODEL, dtype=dtype, use_grouped_mlp_kernel=True,
                       **({"num_hidden_layers": layers} if layers else {}),
                       **overrides)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return cfg, Qwen3MoEForCausalLM(cfg, "cuda").init_weights_(gen)


def phase_moe_decode_parity() -> None:
    cfg, model = moe_model(torch.float32, MOE_DECODE_PARITY_LAYERS,
                           capacity_factor=DROPLESS_CF)
    off = dataclasses.replace(cfg, use_grouped_mlp_kernel=False)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        _build.reset_launch_counts()
        via_kernels = teacher_forced_decode_paged(model, cfg, tokens,
                                                  page_size=PAGE_SIZE)
        torch.cuda.synchronize()
        launches = dict(_build.launch_counts)
        via_plain = teacher_forced_decode_paged(
            model, off, tokens, page_size=PAGE_SIZE, kernel=False)
    err = float((via_kernels - via_plain).abs().max())
    layers = cfg.num_hidden_layers
    # prefill_len 1: every one of the 64 calls is one token a slot, so K4
    # serves the prefill too
    want = {"paged_decode": layers * 64, gm.K5_NAME: layers * 64}
    check(bool(torch.isfinite(via_kernels).all()), "non-finite logits")
    check(launches == want, f"launches {launches}, want {want}")
    check(err <= PARITY_TOLERANCE,
          f"K4 + K5 vs gather + einsum max |dlogit| {err} > "
          f"{PARITY_TOLERANCE}")
    emit("moe_decode_parity", model=MOE_MODEL, layers=layers,
         dtype="float32", capacity_factor=cfg.capacity_factor,
         tokens=list(tokens.shape), max_abs_logit_diff=err,
         tolerance=PARITY_TOLERANCE, launches=launches)


# ---- 14. serving Qwen3-30B-A3B at full depth -------------------------------------
def phase_moe_serve() -> dict:
    cfg, model = moe_model(torch.bfloat16, capacity_factor=DROPLESS_CF)
    off = dataclasses.replace(cfg, use_grouped_mlp_kernel=False)
    prompts = traffic(cfg.vocab_size)
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        eng, results, ptrs, stats = serve(model, cfg, prompts, None)
        launches = dict(_build.launch_counts)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prefills = eng.metrics.prefill_calls
        outcomes = [r.outcome for r in results]
        check(all(o == "ok" for o in outcomes), f"outcomes {outcomes}")
        eng.allocator.check_conservation()
        check((eng.cache.k.data_ptr(), eng.cache.v.data_ptr()) == ptrs,
              "the page pools moved")
        del eng
        torch.cuda.empty_cache()
        _, ref_results, _, ref_stats = serve(model, off, prompts, False)
    torch.cuda.empty_cache()
    profile_decode(model, cfg, "moe_serve_profile")
    layers, steps = cfg.num_hidden_layers, stats["decode_steps"]
    k4 = launches.get("paged_decode", 0)
    k5_decode = launches.get(gm.K5_NAME, 0) - layers * prefills
    check(k4 == layers * steps and k5_decode == layers * steps,
          f"K4 {k4}, K5 {launches.get(gm.K5_NAME, 0)} over {steps} decode "
          f"steps and {prefills} prefills: want {layers} each per step")
    same_req = sum(a.tokens == b.tokens for a, b in zip(results, ref_results))
    same_tok = sum(x == y for a, b in zip(results, ref_results)
                   for x, y in zip(a.tokens, b.tokens))
    emit("moe_serve", model=MOE_MODEL, layers=layers, dtype="bfloat16",
         capacity_factor=cfg.capacity_factor, slots=SLOTS, max_seq=MAX_SEQ,
         prefill_len=PREFILL_LEN, page_size=PAGE_SIZE,
         requests=len(prompts), outcomes=sorted(set(outcomes)),
         launches=launches, prefill_calls=prefills,
         k4_per_decode_step=k4 / steps, k5_per_decode_step=k5_decode / steps,
         peak_memory_gb=peak_gb, **stats,
         gather_einsum_path={k: ref_stats[k] for k in
                             ("wall_s", "tokens_per_s", "decode_tokens_per_s",
                              "mean_ttft_s", "tpot_p50_s", "decode_steps")},
         greedy_agreement={"requests": f"{same_req}/{len(results)}",
                           "tokens": same_tok / sum(len(r.tokens)
                                                    for r in results)})
    return launches


# ---- 15. training parity, kernels on vs the einsum path ---------------------------
def phase_moe_train_parity() -> None:
    cfg = model_config(MOE_MODEL, dtype=torch.float32,
                       num_hidden_layers=MOE_TRAIN_PARITY_LAYERS,
                       use_grouped_mlp_kernel=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = qwen3_moe.init_params(cfg, gen, "cuda", requires_grad=True)
    b, s = 2, 1024
    tokens = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                           device="cuda")
    mb = {"input_ids": tokens[:, :-1], "target_ids": tokens[:, 1:],
          "position_ids": torch.arange(s, device="cuda")}
    leaves = tree_leaves(params)
    runs = {}
    for kernel in (True, False):
        loss_fn = make_loss_fn(
            dataclasses.replace(cfg, use_grouped_mlp_kernel=kernel),
            attention_backend="flash", gradient_checkpointing=True)
        _build.reset_launch_counts()
        loss, stats = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[kernel] = (float(loss.detach()), grads,
                        dict(_build.launch_counts),
                        {k: float(v) for k, v in stats.items()})
    (loss_k, g_k, launches_k, stats_k), (loss_e, g_e, launches_e, _) = (
        runs[True], runs[False])
    norm_k = float(torch.sqrt(sum((g.float() ** 2).sum() for g in g_k)))
    norm_e = float(torch.sqrt(sum((g.float() ** 2).sum() for g in g_e)))
    diff = float(torch.sqrt(sum(((a - c).float() ** 2).sum()
                                for a, c in zip(g_k, g_e))))
    worst = max(rel_err(a, c) for a, c in zip(g_k, g_e))
    layers = cfg.num_hidden_layers
    flash = {tf.K1_NAME: 2 * layers, tf.K2_NAME: layers, tf.K3_NAME: layers}
    want = {**flash, gm.K5_NAME: 2 * layers, gm.GRADS_NAME: layers,
            gm.K6_NAME: layers, gm.K7_NAME: layers}
    check(all(bool(torch.isfinite(g).all()) for g in g_k), "non-finite grad")
    check(launches_k == want, f"kernel launches {launches_k}, want {want}")
    check(launches_e == flash, f"einsum-path launches {launches_e}")
    d_loss = abs(loss_k - loss_e)
    check(d_loss <= MOE_TRAIN_PARITY["loss_abs"],
          f"|dloss| {d_loss} > {MOE_TRAIN_PARITY['loss_abs']}")
    check(diff / norm_e <= MOE_TRAIN_PARITY["grad_rel"],
          f"|g_kernel - g_einsum| / |g_einsum| {diff / norm_e}")
    emit("moe_train_parity", model=MOE_MODEL, layers=layers,
         dtype="float32", tokens=[b, s], gradient_checkpointing=True,
         loss_kernels=loss_k, loss_einsum=loss_e, loss_abs_diff=d_loss,
         grad_norm_kernels=norm_k, grad_norm_einsum=norm_e,
         grad_rel_l2_diff=diff / norm_e, worst_leaf_rel_diff=worst,
         routing=stats_k, tolerance=MOE_TRAIN_PARITY,
         kernel_launches=launches_k)


# ---- 16. training Qwen3-30B-A3B cut to 4 layers ------------------------------------
def phase_moe_train():
    cfg = make_bench_args(MOE_MODEL, seq=MOE_TRAIN_SEQ, gc=True,
                          extra={"num_hidden_layers": MOE_TRAIN_LAYERS})
    before = os.environ.get(qwen3_moe.GROUPED_MLP_ENV)
    os.environ[qwen3_moe.GROUPED_MLP_ENV] = "1"  # read once, by the config
    try:
        res = benchmark_config(cfg, warmup=TRAIN_WARMUP, steps=TRAIN_STEPS,
                               before_window=_build.reset_launch_counts)
    finally:
        if before is None:
            del os.environ[qwen3_moe.GROUPED_MLP_ENV]
        else:
            os.environ[qwen3_moe.GROUPED_MLP_ENV] = before
    launches = dict(_build.launch_counts)
    trainer = res.pop("trainer")
    check(trainer.model_cfg.use_grouped_mlp_kernel, "the kernel is off")
    losses = res["warmup_losses"] + res["losses"]
    check(all(np.isfinite(losses)), f"losses {losses}")
    check(not any(res["update_skipped"]),
          f"update_skipped {res['update_skipped']}")
    layers = trainer.model_cfg.num_hidden_layers
    names = (tf.K1_NAME, tf.K2_NAME, tf.K3_NAME, gm.K5_NAME, gm.K6_NAME,
             gm.K7_NAME, gm.GRADS_NAME)
    per_step = {n: launches.get(n, 0) / TRAIN_STEPS for n in names}
    want = dict(zip(names, (2 * layers, layers, layers, 2 * layers, layers,
                            layers, layers)))
    check(per_step == want, f"launches per step {per_step}, want {want}")
    # the counts' sum of a layer: every kept (token, choice), averaged over
    # the layers and the timed steps (the kernel cell routes 32593 rows)
    mcfg = trainer.model_cfg
    routed = [cfg.sequence_length * cfg.micro_batch_size
              * mcfg.num_experts_per_tok * (1.0 - d)
              for d in res["moe_dropped_fraction"]]
    emit("moe_train", model=MOE_MODEL, layers=layers,
         sequence_length=cfg.sequence_length,
         micro_batch_size=cfg.micro_batch_size,
         gradient_checkpointing=cfg.gradient_checkpointing, dtype=cfg.dtype,
         capacity_factor=trainer.model_cfg.capacity_factor,
         attention_backend=trainer.attention_backend,
         warmup_steps=TRAIN_WARMUP, timed_steps=TRAIN_STEPS,
         active_params=trainer.mfu_params, peak_flops=trainer.peak_flops(),
         launches=launches, launches_per_step=per_step,
         rows_routed_per_layer=statistics.mean(routed), **res)
    return trainer, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        seconds[name] = time.monotonic() - t0
        return out

    info = timed("device", phase_device)
    timed("build", phase_build)
    kernel = timed("kernel_paged_decode", phase_kernel)
    flash = timed("kernel_flash", phase_kernel_flash)
    model32 = timed("decode_parity", phase_decode_parity)
    launches = timed("serve", phase_serve, model32)
    timed("profile", phase_profile, model32)
    del model32
    torch.cuda.empty_cache()
    timed("geometry_serve", phase_geometry_serve)
    torch.cuda.empty_cache()
    timed("train_parity", phase_train_parity)
    torch.cuda.empty_cache()
    trainer, train_launches = timed("train", phase_train)
    timed("train_profile", phase_train_profile, trainer)
    del trainer
    torch.cuda.empty_cache()
    gmlp = timed("kernel_grouped_mlp", phase_kernel_grouped_mlp)
    torch.cuda.empty_cache()
    timed("moe_decode_parity", phase_moe_decode_parity)
    torch.cuda.empty_cache()
    timed("moe_serve", phase_moe_serve)
    torch.cuda.empty_cache()
    timed("moe_train_parity", phase_moe_train_parity)
    torch.cuda.empty_cache()
    moe_trainer, moe_launches = timed("moe_train", phase_moe_train)
    timed("moe_train_profile", phase_train_profile, moe_trainer,
          "moe_train_profile")
    emit("timing", seconds=seconds, total_s=sum(seconds.values()))
    emit("kernels", kernels=[
        {"id": kid, "function": fn, "at": at,
         "status": "ported" if kid in PORTED else "not_ported"}
        for kid, fn, at in TPU_KERNELS])
    at = {kid: where for kid, _, where in TPU_KERNELS}
    bf16 = kernel["bfloat16"]
    flash16 = flash["bfloat16"]
    flash_err = {"K1": flash16["out_max_abs"], "K2": flash16["dq_max_abs"],
                 "K3": max(flash16["dk_max_abs"], flash16["dv_max_abs"])}
    rows = []
    for kid in ("K1", "K2", "K3"):
        t = flash16["kernels"][kid]
        rows.append({
            **PORTED[kid], "replaces": at[kid],
            "launches": train_launches.get(PORTED[kid]["name"], 0),
            "max_abs_err": flash_err[kid], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    rows.append({
        **PORTED["K4"], "replaces": at["K4"],
        "launches": launches,
        "max_abs_err": bf16["max_abs_err"],
        "ms": bf16["kernel_ms"],
        "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"],
    })
    # K5-K7 and the grads pass at the train shape in bf16 (K6 and K7 each
    # alone), launches from the moe_train window
    train16 = gmlp[("train", "bfloat16")]
    gmlp_err = {"K5": train16["out_max_abs"], "K6": train16["dx_max_abs"],
                "K7": max(train16[f"{n}_max_abs"]
                          for n in ("dwg", "dwu", "dwd"))}
    gmlp_err["grads"] = max(train16[f"{n}_max_abs"] for n in ("s", "dg", "du"))
    for kid, entry in (("K5", {**PORTED["K5"], "replaces": at["K5"]}),
                       ("grads", GRADS_PASS),
                       ("K6", {**PORTED["K6"], "replaces": at["K6"]}),
                       ("K7", {**PORTED["K7"], "replaces": at["K7"]})):
        t = train16["kernels"][kid]
        rows.append({
            **entry, "launches": moe_launches.get(entry["name"], 0),
            "max_abs_err": gmlp_err[kid], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
