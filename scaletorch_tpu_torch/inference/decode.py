"""The engine steps: prefill and one-token decode over static buffers.

Counterpart of scaletorch_tpu/inference/decode.py (PyTorch port). A step
function is a plain function of device tensors with static shapes: the
prompt buffer is always ``[B, P]``, the decode batch always ``[B]``, and
admissions change data, never shapes. The KV buffers are updated IN
PLACE (the counterpart of the JAX package's cache donation), so a step
returns no cache.

  * prefill(model, tokens [B, P] i32, lengths [B] i32, write_mask [B]
    bool, cache, seeds [B] i64) -> (first [B] i64, last_logits [B, V]
    f32, finite [B] bool)
  * decode(model, tokens [B] i32, positions [B] i32, active [B] bool,
    cache, seeds [B] i64) -> (next [B] i64, logits [B, V] f32, finite
    [B] bool)
  * the paged twins take ``tail_lens``/``starts`` (prefill) and the page
    tables (both) and route the cache through ``PagedKVIO``.

``StaticStep`` is what the engine runs: one step function bound to
static input buffers, which each call fills from host arrays. On the
card it is captured once as a CUDA graph and only replayed after that
(the counterpart of the reference's one jit compile per step); on the
CPU, which the caller must ask for, the same function runs eagerly over
the same buffers.

Over a serving mesh the model runs its tensor-parallel path (its
collectives inside the step, so inside the captured graph), and a dense
step with ``batch_axis`` computes this rank's rows of the batch only and
all-gathers the sampled tokens, the logits and the finite mask over that
axis, so every rank returns the whole batch's.

``donate_cache`` is accepted for the reference's signatures and changes
nothing: the buffers are written in place whatever it says, the
counterpart of donation (the reference turns donation off only on the
CPU, to silence a warning).
"""

from __future__ import annotations

import collections
import gc
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from scaletorch_tpu_torch.inference.kv_cache import (
    PagedKVIO,
    ceil_div,
    init_kv_cache,
    init_paged_kv_cache,
)
from scaletorch_tpu_torch.inference.sampling import (
    SamplingParams,
    finite_mask,
    sample,
)
from scaletorch_tpu_torch.ops import _build

Tensor = torch.Tensor
StepOutput = Tuple[Tensor, Tensor, Tensor]


def resolve_forward_cached(cfg) -> Callable:
    """The cached forward for a model config: ``Qwen3MoEConfig`` and
    ``GPTMoEConfig`` have their own; every other ``LlamaConfig`` (Llama,
    Qwen3) shares the Llama one."""
    from scaletorch_tpu_torch.models import gpt_moe, llama, qwen3_moe

    if isinstance(cfg, qwen3_moe.Qwen3MoEConfig):
        return qwen3_moe.forward_cached
    if isinstance(cfg, gpt_moe.GPTMoEConfig):
        return gpt_moe.forward_cached
    if isinstance(cfg, llama.LlamaConfig):
        return llama.forward_cached
    raise TypeError(
        f"no cache-aware forward known for config {type(cfg).__name__} "
        "(the PyTorch port serves the Llama family, Qwen3-MoE and GPT-MoE)"
    )


def _head(logits: Tensor, seeds: Tensor, positions: Tensor,
          sampling: SamplingParams) -> StepOutput:
    """(sampled token, fp32 logits, finite flag) of [B, V] logits."""
    return (sample(logits, seeds, positions, sampling), logits.float(),
            finite_mask(logits))


def _batch_split(batch_axis: Optional[str]):
    """(rows, gather) of a dense step over ``batch_axis``: ``rows(*xs)``
    keeps this rank's rows of each [B, ...] input, ``gather(out)``
    all-gathers a step's outputs back to [B, ...] (identities for None).
    The axis resolves in the current mesh manager."""
    if batch_axis is None:
        return (lambda *xs: xs), (lambda out: out)
    from scaletorch_tpu_torch.parallel.mesh import (
        all_gather_cat,
        axis_group,
        current_mesh_manager,
    )

    def rows(*xs):
        mm = current_mesh_manager()
        n, r = mm.axis_size(batch_axis), mm.axis_rank(batch_axis)
        w = xs[0].shape[0] // n
        return tuple(x[r * w:(r + 1) * w] for x in xs)

    def gather(out):
        group = axis_group(batch_axis)
        return tuple(all_gather_cat(t, group, 0) for t in out)

    return rows, gather


def make_prefill_step(cfg, sampling: SamplingParams, *,
                      forward_fn: Optional[Callable] = None,
                      batch_axis: Optional[str] = None,
                      donate_cache: Optional[bool] = None) -> Callable:
    """Dense prefill: the causal forward over the whole ``[B, P]`` buffer
    (positions [0, P) for every slot), writing cache [0, P) for the
    ``write_mask`` slots only; each slot's first token samples from the
    logits at ``lengths - 1``. ``batch_axis``: this rank's rows (its
    cache shard), the outputs all-gathered."""
    fwd = forward_fn or resolve_forward_cached(cfg)
    rows, gather = _batch_split(batch_axis)

    def prefill(model, tokens, lengths, write_mask, cache, seeds):
        tokens, lengths, write_mask, seeds = rows(tokens, lengths,
                                                  write_mask, seeds)
        b, p = tokens.shape
        positions = torch.arange(p, device=tokens.device,
                                 dtype=torch.int32).expand(b, p)
        logits, _ = fwd(model, tokens, cfg, tuple(cache),
                        positions=positions, write_mask=write_mask,
                        last_index=lengths - 1)
        return gather(_head(logits[:, 0, :], seeds, lengths - 1, sampling))

    return prefill


def make_decode_step(cfg, sampling: SamplingParams, *,
                     forward_fn: Optional[Callable] = None,
                     batch_axis: Optional[str] = None,
                     donate_cache: Optional[bool] = None) -> Callable:
    """Dense one-token decode: each slot's current token at its absolute
    position, K/V appended for ACTIVE slots only, next token sampled with
    the slot's (seed, position). ``batch_axis`` as the prefill's."""
    fwd = forward_fn or resolve_forward_cached(cfg)
    rows, gather = _batch_split(batch_axis)

    def decode(model, tokens, positions, active, cache, seeds):
        tokens, positions, active, seeds = rows(tokens, positions, active,
                                                seeds)
        logits, _ = fwd(model, tokens[:, None], cfg, tuple(cache),
                        positions=positions[:, None], write_mask=active)
        return gather(_head(logits[:, 0, :], seeds, positions, sampling))

    return decode


def make_fill_slots_step(donate_cache: Optional[bool] = None) -> Callable:
    """In-place masked fill over axis 1 of every cache buffer (the SLOT
    axis dense, the PAGE axis paged): ``fill_slots(cache, mask [n] bool,
    value)`` sets the masked lines to ``value`` and leaves every other
    byte untouched. Quarantine clears a poisoned slot's lines with it,
    outside the captured steps, as the reference's fill step stays out
    of its compile counts."""

    def fill_slots(cache, mask, value: float):
        m = torch.from_numpy(np.asarray(mask, bool)).to(cache[0].device)
        for buf in cache:
            buf.masked_fill_(m.view((1, -1) + (1,) * (buf.ndim - 2)), value)
        return cache

    return fill_slots


def make_paged_prefill_step(cfg, sampling: SamplingParams, *,
                            page_size: int,
                            seq_limit: Optional[int] = None,
                            forward_fn: Optional[Callable] = None,
                            donate_cache: Optional[bool] = None
                            ) -> Callable:
    """Paged prefill: each admitted slot prefills only its prompt TAIL,
    at rows [0, tail_len) of the buffer and absolute positions ``starts +
    row`` (``starts`` is the page-aligned radix prefix hit, 0 without
    one); the tail reads the shared prefix pages straight from the pool.
    Prefill always takes the gather path (S > 1)."""
    fwd = forward_fn or resolve_forward_cached(cfg)

    def prefill(model, tokens, tail_lens, starts, write_mask, page_tables,
                pool, seeds):
        p = tokens.shape[1]
        positions = starts[:, None] + torch.arange(
            p, device=tokens.device, dtype=torch.int32)
        kv_io = PagedKVIO(page_tables, page_size, seq_limit=seq_limit)
        logits, _ = fwd(model, tokens, cfg, tuple(pool), positions=positions,
                        write_mask=write_mask, kv_io=kv_io,
                        last_index=tail_lens - 1)
        return _head(logits[:, 0, :], seeds, starts + tail_lens - 1,
                     sampling)

    return prefill


def make_paged_decode_step(cfg, sampling: SamplingParams, *,
                           page_size: int,
                           seq_limit: Optional[int] = None,
                           forward_fn: Optional[Callable] = None,
                           kernel: Optional[bool] = None,
                           donate_cache: Optional[bool] = None) -> Callable:
    """Paged one-token decode: the K/V append is a scatter into each
    slot's current page, attention reads through its page table — the
    CUDA paged-decode kernel on the card (``kernel=None``), the gather
    path on the CPU or with ``kernel=False``."""
    fwd = forward_fn or resolve_forward_cached(cfg)

    def decode(model, tokens, positions, active, page_tables, pool, seeds):
        kv_io = PagedKVIO(page_tables, page_size, seq_limit=seq_limit,
                          kernel=kernel)
        logits, _ = fwd(model, tokens[:, None], cfg, tuple(pool),
                        positions=positions[:, None], write_mask=active,
                        kv_io=kv_io)
        return _head(logits[:, 0, :], seeds, positions, sampling)

    return decode


class StaticStep:
    """One engine step bound to static buffers, captured once on the card.

    ``fn(**inputs)`` runs the step over the named ``inputs`` (device
    tensors made from the host arrays given here, which fix their
    shapes and dtypes; their values must be safe to run, e.g. nothing
    written) and the tensors it closes over (the model, the KV cache,
    the page tables), and returns a tuple of tensors. A call
    ``step(**arrays)`` copies each host array into its input and runs
    the step; it returns the step's outputs, which on the card are the
    graph's static outputs, overwritten by the next call (``outputs``
    holds the last call's, on the CPU too).

    On the card the constructor captures ``fn`` as a CUDA graph, as
    ``torch.cuda.graphs`` prescribes: one warm-up run on a side stream
    first, which does the first-use work capture forbids (the kernels'
    build and load, cuBLAS's handle and workspace, K4's split counters
    for the capture stream, allocated outside the graph's pool), then
    the capture on the same stream into a memory pool of the graph's
    own, with Python's cyclic collector run before it and held off
    during it. A failed capture raises: there is no eager fallback.
    A step over a serving mesh holds NCCL collectives: the warm-up issues
    each of them once on the capture stream, so every communicator
    exists before the capture records it, and every rank captures (and
    later replays) the same sequence of collectives.

    The warm-up's kernel launches run and stay in
    ``_build.launch_counts``; the capture's only record, so they are
    taken out again, kept in ``captured_launches`` and added back on
    every replay. The host arrays reach the card through pinned staging
    twins, copied without a wait: every step ends in the host copy of
    its tokens, which waits for the card, so a twin is free again when
    the next call fills it.
    """

    def __init__(self, fn: Callable[..., Tuple[Tensor, ...]],
                 inputs: Dict[str, np.ndarray], device: torch.device) -> None:
        self.fn = fn
        self.device = device
        on_card = device.type == "cuda"
        self.inputs = {name: torch.from_numpy(np.array(a)).to(device)
                       for name, a in inputs.items()}
        self._staging = {
            name: (torch.empty_like(buf, device="cpu").pin_memory()
                   if on_card else buf)
            for name, buf in self.inputs.items()}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.outputs: Optional[Tuple[Tensor, ...]] = None
        self.captures = 0
        self.replays = 0
        self.warmup_launches: collections.Counter = collections.Counter()
        self.captured_launches: collections.Counter = collections.Counter()
        if on_card:
            self._capture()

    @property
    def compile_count(self) -> int:
        """Captures on the card; on the CPU, the one static step built."""
        return self.captures if self.device.type == "cuda" else 1

    def _capture(self) -> None:
        counts = _build.launch_counts
        before = collections.Counter(counts)
        self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.inference_mode(), torch.cuda.stream(self.stream):
            self.fn(**self.inputs)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        warm = collections.Counter(counts)
        self.warmup_launches = warm - before
        graph = torch.cuda.CUDAGraph()
        # an unreachable engine's graph freed by the cyclic collector
        # inside the capture would invalidate it: collect first, and keep
        # the collector off until the capture ends
        gc.collect()
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.inference_mode(), torch.cuda.graph(
                    graph, stream=self.stream):
                outputs = self.fn(**self.inputs)
        finally:
            if gc_was_enabled:
                gc.enable()
        self.captured_launches = collections.Counter(counts) - warm
        for name in self.captured_launches:
            counts[name] = warm[name]
            if not counts[name]:
                del counts[name]
        self.graph, self.outputs = graph, outputs
        self.captures += 1

    def load(self, **arrays: np.ndarray) -> None:
        """Copy host arrays into the named inputs."""
        for name, array in arrays.items():
            staging = self._staging[name]
            staging.numpy()[...] = array
            if staging is not self.inputs[name]:
                self.inputs[name].copy_(staging, non_blocking=True)

    def run_eager(self) -> Tuple[Tensor, ...]:
        """The step function itself over the current inputs (the CPU
        path; on the card, the reference a replay is held against)."""
        with torch.inference_mode():
            return self.fn(**self.inputs)

    def replay(self) -> Tuple[Tensor, ...]:
        self.graph.replay()
        self.replays += 1
        _build.launch_counts.update(self.captured_launches)
        return self.outputs

    def __call__(self, **arrays: np.ndarray) -> Tuple[Tensor, ...]:
        with torch.inference_mode():
            self.load(**arrays)
        if self.graph is None:
            self.outputs = self.run_eager()
            return self.outputs
        return self.replay()


def teacher_forced_decode(
    model,
    cfg,
    tokens: Tensor,
    *,
    max_seq: Optional[int] = None,
    prefill_len: int = 1,
    forward_fn: Optional[Callable] = None,
    dtype: Optional[torch.dtype] = None,
    sharding: Any = None,
) -> Tensor:
    """Prefill the first ``prefill_len`` tokens, then decode the rest one
    at a time with the GROUND-TRUTH token at each step. Returns [B, S, V]
    logits, position-aligned with a full-sequence forward. ``sharding``
    (``kv_cache_shardings``): the cache shard of a tensor-parallel
    model's rank."""
    fwd = forward_fn or resolve_forward_cached(cfg)
    b, s = tokens.shape
    dev = tokens.device
    cache = init_kv_cache(cfg, b, max_seq or s, dtype=dtype or cfg.dtype,
                          device=dev, sharding=sharding)
    p = prefill_len
    positions = torch.arange(p, device=dev, dtype=torch.int32).expand(b, p)
    logits_p, cache = fwd(model, tokens[:, :p], cfg, tuple(cache),
                          positions=positions)
    chunks = [logits_p]
    for t in range(p, s):
        logits_t, cache = fwd(
            model, tokens[:, t:t + 1], cfg, tuple(cache),
            positions=torch.full((b, 1), t, device=dev, dtype=torch.int32))
        chunks.append(logits_t)
    return torch.cat(chunks, dim=1)


def teacher_forced_decode_paged(
    model,
    cfg,
    tokens: Tensor,
    *,
    page_size: int,
    max_seq: Optional[int] = None,
    prefill_len: int = 1,
    forward_fn: Optional[Callable] = None,
    dtype: Optional[torch.dtype] = None,
    kernel: Optional[bool] = None,
    sharding: Any = None,
) -> Tensor:
    """Paged twin of ``teacher_forced_decode`` through an identity page
    table (slot ``b`` owns pages ``b*max_pages+1 ..``; page 0 is TRASH).
    ``kernel`` goes to the decode steps' dispatcher; ``sharding``
    (``paged_kv_cache_shardings``) as the dense twin's."""
    fwd = forward_fn or resolve_forward_cached(cfg)
    b, s = tokens.shape
    dev = tokens.device
    s_max = max_seq or s
    max_pages = ceil_div(s_max, page_size)
    pool = init_paged_kv_cache(cfg, b * max_pages + 1, page_size,
                               dtype=dtype or cfg.dtype, device=dev,
                               sharding=sharding)
    tables = (torch.arange(b * max_pages, dtype=torch.int32, device=dev)
              + 1).view(b, max_pages)
    p = prefill_len
    prefill_io = PagedKVIO(tables, page_size, seq_limit=s_max)
    decode_io = PagedKVIO(tables, page_size, seq_limit=s_max, kernel=kernel)
    positions = torch.arange(p, device=dev, dtype=torch.int32).expand(b, p)
    logits_p, pool = fwd(model, tokens[:, :p], cfg, tuple(pool),
                         positions=positions, kv_io=prefill_io)
    chunks = [logits_p]
    for t in range(p, s):
        logits_t, pool = fwd(
            model, tokens[:, t:t + 1], cfg, tuple(pool),
            positions=torch.full((b, 1), t, device=dev, dtype=torch.int32),
            kv_io=decode_io)
        chunks.append(logits_t)
    return torch.cat(chunks, dim=1)


# ---- the analyzer's audit entries ------------------------------------------------
# Each builder returns a plain dict: the entry's pinned contract fields
# (``analysis/entry_audit.py`` reads them) and ``setup(device)``, which
# builds the step over its buffers and returns what one call needs. This
# module never imports the analyzer.
AUDIT_BATCH, AUDIT_MAX_SEQ, AUDIT_PAGE = 2, 32, 8


def audit_cfg(compute_dtype: str = "fp32"):
    """The audit entries' tiny Llama (the reference's): hidden 64, 2
    layers, 4 query over 2 KV heads of D 16, vocab 128. ``compute_dtype``
    "bf16" builds the bf16-contracted model of the precision-leak
    injection."""
    from scaletorch_tpu_torch.models.llama import LlamaConfig

    dt = torch.bfloat16 if compute_dtype in ("bf16", "bfloat16") \
        else torch.float32
    return LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=256, dtype=dt,
        param_dtype=torch.float32)


def audit_model(cfg, device):
    """The audit model on ``device``, weights drawn from seed 0."""
    from scaletorch_tpu_torch.models.llama import LlamaForCausalLM

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    return LlamaForCausalLM(cfg, dev).init_weights_(gen)


def audit_inputs(device, *, b: int = AUDIT_BATCH, s: int = AUDIT_MAX_SEQ
                 ) -> Dict[str, Tensor]:
    """Seeded step inputs: tokens, per-slot positions on both sides of a
    page (13 and the last key), every slot active, seeds."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    positions = np.array([13, s - 1] + [s // 2] * (b - 2), np.int32)[:b]
    return {
        "tokens": torch.from_numpy(
            rng.integers(0, 128, (b, s)).astype(np.int32)).to(dev),
        "positions": torch.from_numpy(positions).to(dev),
        "mask": torch.ones(b, dtype=torch.bool, device=dev),
        "seeds": torch.from_numpy(
            rng.integers(0, 2**31, b).astype(np.int64)).to(dev),
    }


def audit_page_tables(b: int, max_pages: int, num_pages: int, device
                      ) -> Tensor:
    """Slot ``b`` owns pages ``b * max_pages + 1 ..`` (page 0 is TRASH),
    wrapped into a smaller pool so a shrunken one still runs."""
    pages = torch.arange(b * max_pages, dtype=torch.int32) % (num_pages - 1)
    return (pages + 1).view(b, max_pages).to(torch.device(device))


def _audit_contract(name: str, file: str, cfg, kv_cache: Dict[str, Any],
                    cache_mb: float, compute_dtype: str = "fp32"
                    ) -> Dict[str, Any]:
    """The contract fields every single-device inference entry pins: no
    collective at all (an empty comm-budget row), the cache or pool
    updated in place (``inplace_min_mb``: ST702/ST1002), the engine's
    ``kv_cache_bytes`` equal to the allocated buffers (ST1005)."""
    return {
        "name": name, "file": file, "world_size": 1,
        "quantized_axis": None, "expect_inplace": True, "hoisted_axes": (),
        "max_collective_result_mb": 1.0, "compute_dtype": compute_dtype,
        "inplace_min_mb": round(0.9 * cache_mb, 4), "kv_cache": kv_cache,
    }


def audit_entry_prefill() -> Dict[str, Any]:
    """Audit entry: the dense prefill step on one device, as the engine
    captures it. Contract: the cache updated in place, zero collectives,
    ``kv_cache_bytes`` of the dense layout equal to the cache's bytes."""
    from scaletorch_tpu_torch.inference.kv_cache import (
        init_kv_cache,
        kv_cache_bytes,
    )

    cfg = audit_cfg()
    b, s_max = AUDIT_BATCH, AUDIT_MAX_SEQ

    def setup(device) -> Dict[str, Any]:
        model = audit_model(cfg, device)
        cache = init_kv_cache(cfg, b, s_max, device=torch.device(device))
        x = audit_inputs(device)
        fn = make_prefill_step(cfg, SamplingParams(temperature=0.0))
        lengths = x["positions"] + 1
        return {"call": lambda: fn(model, x["tokens"], lengths, x["mask"],
                                   cache, x["seeds"]),
                "inplace": {"cache.k": cache.k, "cache.v": cache.v},
                "arguments": [*model.parameters(), *cache, *x.values()],
                "cache": tuple(cache)}

    kv = {"cfg": cfg, "layout": "dense", "batch": b, "max_seq": s_max,
          "dtype": torch.float32}
    entry = _audit_contract(
        "prefill_step", "scaletorch_tpu_torch/inference/decode.py", cfg, kv,
        kv_cache_bytes(cfg, b, s_max, torch.float32) / 1e6)
    entry["setup"] = setup
    return entry


def audit_entry_decode(compute_dtype: str = "fp32",
                       fp32_residual: bool = False) -> Dict[str, Any]:
    """Audit entry: the dense one-token decode step on one device (the
    prefill's contract). ``compute_dtype="bf16"`` builds the
    bf16-contracted entry and ``fp32_residual=True`` routes the cache
    through a full fp32 round trip after the forward: the accidental
    upcast the precision-leak check (ST1003) must attribute to its
    source line."""
    from scaletorch_tpu_torch.inference.kv_cache import (
        init_kv_cache,
        kv_cache_bytes,
    )

    cfg = audit_cfg(compute_dtype)
    b, s_max = AUDIT_BATCH, AUDIT_MAX_SEQ
    forward_fn = None
    if fp32_residual:
        base_fwd = resolve_forward_cached(cfg)

        def forward_fn(model, tokens, c, cache, **kw):
            logits, cache = base_fwd(model, tokens, c, cache, **kw)
            for buf in cache:  # the injected leak: a whole-buffer fp32 copy
                buf.copy_((buf.float() + 0.0).to(buf.dtype))
            return logits, cache

    def setup(device) -> Dict[str, Any]:
        model = audit_model(cfg, device)
        cache = init_kv_cache(cfg, b, s_max, device=torch.device(device))
        x = audit_inputs(device)
        fn = make_decode_step(cfg, SamplingParams(temperature=0.0),
                              forward_fn=forward_fn)
        return {"call": lambda: fn(model, x["tokens"][:, 0],
                                   x["positions"], x["mask"], cache,
                                   x["seeds"]),
                "inplace": {"cache.k": cache.k, "cache.v": cache.v},
                "arguments": [*model.parameters(), *cache, *x.values()],
                "cache": tuple(cache)}

    kv = {"cfg": cfg, "layout": "dense", "batch": b, "max_seq": s_max,
          "dtype": cfg.dtype}
    entry = _audit_contract(
        "decode_step", "scaletorch_tpu_torch/inference/decode.py", cfg, kv,
        kv_cache_bytes(cfg, b, s_max, cfg.dtype) / 1e6, compute_dtype)
    # one cache buffer counts as large: the smallest fp32 intermediate
    # the leak injection materialises
    entry["fp32_large_elems"] = 2048
    entry["setup"] = setup
    return entry


def audit_entry_paged_decode(pool_pages: Optional[int] = None
                             ) -> Dict[str, Any]:
    """Audit entry: the paged one-token decode step on one device (K4 on
    the card, one launch a layer). Contract: the PAGE POOL updated in
    place and zero collectives. The ``kv_cache`` sizing is pinned to the
    default pool (``b * max_pages + 1`` pages) whatever ``pool_pages``
    says: the keyword builds a shrunken pool, the drift the sizing check
    (ST1005) must catch."""
    from scaletorch_tpu_torch.inference.kv_cache import (
        init_paged_kv_cache,
        kv_cache_bytes,
    )

    cfg = audit_cfg()
    b, s_max, page = AUDIT_BATCH, AUDIT_MAX_SEQ, AUDIT_PAGE
    max_pages = s_max // page
    num_pages = b * max_pages + 1
    built_pages = pool_pages if pool_pages is not None else num_pages

    def setup(device) -> Dict[str, Any]:
        model = audit_model(cfg, device)
        pool = init_paged_kv_cache(cfg, built_pages, page,
                                   device=torch.device(device))
        tables = audit_page_tables(b, max_pages, built_pages, device)
        x = audit_inputs(device)
        fn = make_paged_decode_step(cfg, SamplingParams(temperature=0.0),
                                    page_size=page, seq_limit=s_max)
        return {"call": lambda: fn(model, x["tokens"][:, 0], x["positions"],
                                   x["mask"], tables, pool, x["seeds"]),
                "inplace": {"pool.k": pool.k, "pool.v": pool.v},
                "arguments": [*model.parameters(), *pool, tables,
                              *x.values()],
                "cache": tuple(pool)}

    kv = {"cfg": cfg, "layout": "paged", "batch": b, "max_seq": s_max,
          "dtype": torch.float32, "page_size": page, "num_pages": num_pages}
    entry = _audit_contract(
        "paged_decode_step", "scaletorch_tpu_torch/inference/decode.py",
        cfg, kv, kv_cache_bytes(cfg, b, s_max, torch.float32,
                                layout="paged", page_size=page,
                                num_pages=num_pages) / 1e6)
    entry["setup"] = setup
    # K4 once a layer on the card
    entry["kernel_launches"] = {"paged_decode": cfg.num_hidden_layers}
    return entry
