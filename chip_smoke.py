#!/usr/bin/env python3
"""Build and drive the PyTorch port on one CUDA card; fail on any fault.

Run from the root of a checkout, with one visible card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and the exit code
is non-zero; no phase catches an exception):

  1. device   — the card's name and power limit (nvidia-smi) and
                torch.cuda.get_device_name(0); no card, no run.
  2. build    — nvcc builds every kernel source in
                scaletorch_tpu_torch/csrc/ into build/kernels/, all
                compiles started together.
  3. kernel_paged_decode — the paged-decode kernel against its plain
                PyTorch version at the serving shapes of Qwen3-0.6B
                (Hq 16, Hkv 8, D 128, 8 slots, page 16, 128 pages per
                slot), fp32 and bf16; its time, the plain version's, a
                library yardstick's (gather + scaled_dot_product_attention,
                which the port never calls) and the memory bound.
  4. decode_parity — Qwen3-0.6B at full width, fp32, random weights from
                a seeded generator: teacher-forced paged decode of
                2 x 64 tokens through the kernel and through the gather
                path; max |logit difference| <= 1e-3.
  5. serve    — the paged engine at Qwen3-0.6B width in bf16 serves 16
                greedy requests (half behind a shared 256-token prefix)
                with the kernel counted: every outcome ok, prefix hits,
                page conservation, pools updated in place, and 28 kernel
                launches per decode step. The same traffic through the
                gather path gives the greedy agreement (printed, not
                asserted: bf16 can diverge late in a sequence).
  6. profile  — torch.profiler over 16 steady decode ticks of the same
                engine: wall and device time per step, the device's busy
                share, and the kernels that take the device time.
  7. kernels  — every Pallas kernel of the JAX package, ported or not.

Then the per-kernel contract line, the nvidia-smi line, and last:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from scaletorch_tpu_torch.inference import (
    InferenceEngine,
    SamplingParams,
    teacher_forced_decode,
    teacher_forced_decode_paged,
)
from scaletorch_tpu_torch.models import (
    LlamaForCausalLM,
    init_params,
    model_config,
)
from scaletorch_tpu_torch.ops import _build
from scaletorch_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_ref,
    paged_gather_kv,
)
from scaletorch_tpu_torch.utils.device import card_name_and_power_limit

MODEL = "qwen3-0.6b"
# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 / fp32 flop/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# serving shapes of the paged engine at Qwen3-0.6B width
SLOTS, PAGE_SIZE, MAX_SEQ, PREFILL_LEN = 8, 16, 2048, 512
PAGES_PER_SLOT = MAX_SEQ // PAGE_SIZE
TOLERANCE = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
PARITY_TOLERANCE = 1e-3

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
    "K4": {"name": "paged_decode", "route": "cuda",
           "source": "scaletorch_tpu_torch/csrc/paged_decode.cu"},
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    """Median device time of one call, each call timed alone with CUDA
    events after a write of ``flush`` (larger than the 50 MB L2), so
    every call finds its inputs cold, as a decode step's layer does."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


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
    emit("build", sources=list(_build.KERNEL_SOURCES),
         compile_s=seconds, seconds=time.monotonic() - t0,
         build_dir=str(_build.BUILD_DIR))


# ---- 3. the paged-decode kernel against its plain version --------------------
def decode_inputs(dtype: torch.dtype, seed: int):
    """Serving-shaped inputs: shuffled physical pages, positions that
    include 0, both sides of a page boundary and the last position."""
    cfg = model_config(MODEL)
    b, hq, hkv = SLOTS, cfg.num_attention_heads, cfg.num_key_value_heads
    d = cfg.actual_head_dim
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_pages = b * PAGES_PER_SLOT + 1
    pool_k = torch.randn(n_pages, hkv, PAGE_SIZE, d, generator=gen,
                         device=dev).to(dtype)
    pool_v = torch.randn(n_pages, hkv, PAGE_SIZE, d, generator=gen,
                         device=dev).to(dtype)
    q = torch.randn(b, hq, d, generator=gen, device=dev).to(dtype)
    tables = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1)
    tables = tables.to(torch.int32).view(b, PAGES_PER_SLOT).contiguous()
    rest = torch.randint(1, MAX_SEQ, (b - 4,), generator=gen, device=dev)
    positions = torch.cat([
        torch.tensor([0, PAGE_SIZE - 1, PAGE_SIZE, MAX_SEQ - 1], device=dev),
        rest]).to(torch.int32)
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


def phase_kernel() -> dict:
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        inputs = decode_inputs(dtype, seed=1234)
        q, pool_k, pool_v, tables, positions = inputs
        out = paged_decode_attention(*inputs)
        ref = paged_decode_attention_ref(*inputs)
        lib = library_attention(*inputs)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        lib_err = float((lib.float() - ref.float()).abs().max())
        check(bool(torch.isfinite(out).all()), f"{dtype}: non-finite output")
        check(err <= TOLERANCE[dtype],
              f"{dtype}: kernel vs plain max abs {err} > {TOLERANCE[dtype]}")
        row = {
            "dtype": str(dtype).replace("torch.", ""),
            "shape": {"q": list(q.shape), "pool": list(pool_k.shape),
                      "page_tables": list(tables.shape)},
            "positions": positions.tolist(),
            "max_abs_err": err, "tolerance": TOLERANCE[dtype],
            "library_max_abs_err": lib_err,
            "kernel_ms": time_ms(lambda: paged_decode_attention(*inputs),
                                 flush),
            "plain_ms": time_ms(lambda: paged_decode_attention_ref(*inputs),
                                flush),
            "library_ms": time_ms(lambda: library_attention(*inputs), flush),
            "bound_ms": decode_bound_ms(q, pool_k, positions),
            "bound_by": "bytes",
        }
        results[row["dtype"]] = row
        emit("kernel_paged_decode", **row)
    return results


# ---- 4. full-width decode parity, kernel vs gather path ----------------------
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


# ---- 5. serving ---------------------------------------------------------------
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


def phase_profile(model32) -> None:
    """Where a decode step's time goes: torch.profiler over a steady
    window of decode ticks of the serving engine (8 active slots, no
    admission inside the window). Device busy share = the kernels' summed
    device time over the window's wall time (one stream: no overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = model_config(MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM.from_params(dict(model32.named_parameters()),
                                         cfg)
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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(window):
                eng.step()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    check(eng.metrics.prefill_calls == 1, "admission inside the window")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    emit("profile", window_decode_steps=window,
         wall_ms_per_step=1e3 * wall / window,
         device_ms_per_step=1e-3 * device_us / window,
         device_busy_share=(1e-6 * device_us / wall) if wall else None,
         kernel_launches_per_step=sum(e.count for e in kernels) / window,
         top_kernels=[{"name": e.key[:80], "calls_per_step": e.count / window,
                       "ms_per_step": 1e-3 * e.self_device_time_total / window}
                      for e in top])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = phase_device()
    phase_build()
    kernel = phase_kernel()
    model32 = phase_decode_parity()
    launches = phase_serve(model32)
    phase_profile(model32)
    emit("kernels", kernels=[
        {"id": kid, "function": fn, "at": at,
         "status": "ported" if kid in PORTED else "not_ported"}
        for kid, fn, at in TPU_KERNELS])
    bf16 = kernel["bfloat16"]
    print(json.dumps({"kernels": [{
        **PORTED["K4"],
        "replaces": "scaletorch_tpu/ops/pallas/paged_attention.py:131",
        "launches": launches,
        "max_abs_err": bf16["max_abs_err"],
        "ms": bf16["kernel_ms"],
        "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"],
    }]}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
