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
