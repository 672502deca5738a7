"""Continuous-batching inference engine over a fixed-slot batch (PyTorch port).

Counterpart of scaletorch_tpu/inference/engine.py, with its contracts:

  * a FIXED number of slots (the decode batch) and a FIXED maximum
    sequence length — every device buffer keeps its shape for the whole
    engine lifetime; between decode steps the engine admits queued
    requests into freed slots by writing their row of the prompt buffer
    and flipping their ``write_mask`` bit;
  * per-slot lengths and stop state live on the HOST; each decode step
    brings the sampled tokens and the finite mask back in one copy;
  * each step runs over static device buffers (``StaticStep``): on the
    card the engine captures its prefill step and its decode step once
    each as CUDA graphs when it is built, and only replays them after
    that, through admissions, prefix hits, cancels, deadlines and
    quarantine (``prefill_compile_count`` / ``decode_compile_count``,
    the reference's one jit compile per step); on the CPU the same
    steps run eagerly. The sampler draws on the device;
  * the KV buffers, the page tables and every step input are written in
    place, so they keep their ``data_ptr()`` (the counterpart of
    donation);
  * ``cache_layout="paged"`` swaps the dense per-slot buffers for a
    global page pool + per-slot page tables: page-budget-aware
    admission, a radix tree sharing page-aligned prompt prefixes, and
    decode attention through the hand-written CUDA paged-decode kernel
    on the card (the gather path on the CPU) — greedy outputs of the
    gather path are bit-identical to the dense layout;
  * every submitted request ends in exactly one terminal ``outcome``
    (ok / timeout / shed / rejected / quarantined / aborted): bounded
    admission, per-request TTLs, quarantine of a slot whose logits go
    non-finite, ``drain()``.

  * the runtime hooks: a ``SystemMonitor`` sampled and a
    ``TelemetryExporter`` fed every ``monitor_every`` decode steps,
    ``tick``/``admission``/``prefill``/``decode`` spans and request async
    events on a ``SpanTracer``, a ``ServingFaultInjector`` (NaN logits,
    a slow decode, submit and deadline storms), a ``PreemptionHandler``
    that makes ``run()`` drain, and a serving watchdog
    (``make_serving_watchdog``) beaten each tick;
  * the warm prefix exchange: ``export_prefix_map`` /
    ``export_prefix_pages`` on a donor, ``import_prefix_pages`` on a
    fresh engine. Every write these make into the KV pool (a poisoned
    slot, imported pages) goes into the same storage in place, so the
    captured steps keep their buffers and are never captured again.

  * over a serving mesh (``mesh``: a ``parallel.mesh.MeshManager`` of tp
    and dp ranks, and for a Qwen3-MoE of ep ranks too, one process and
    one card each): the model holds this rank's tensor-parallel shards
    (and expert slices: ``models/qwen3_moe.py``; a GPT-MoE its heads and
    each expert's tp slices: ``models/gpt_moe.py``) and the cache its KV
    heads
    (``kv_cache_shardings``; dense slots also over ``batch_axis``), the
    steps run the tp path with its collectives inside the captured
    graphs, and every rank runs this engine. The host scheduler
    (admission, pages, radix tree, retirements) is replicated, so every
    rank must take the same decision on every tick: ``submit()``,
    ``cancel()``, ``drain()`` and ``stop_admissions()`` are called
    identically on every rank (the caller's contract), and the decisions
    that read a clock or a signal (which deadlines have passed, whether a
    preemption asks for a drain) are made once a tick on rank 0 and
    shared over a gloo group, so the card never waits for it.
"""

from __future__ import annotations

import functools
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from scaletorch_tpu_torch.inference.decode import (
    StaticStep,
    make_decode_step,
    make_fill_slots_step,
    make_paged_decode_step,
    make_paged_prefill_step,
    make_prefill_step,
)
from scaletorch_tpu_torch.inference.kv_cache import (
    TRASH_PAGE,
    PageAllocator,
    RadixPrefixCache,
    ceil_div,
    init_kv_cache,
    init_paged_kv_cache,
    kv_cache_bytes,
    kv_cache_shardings,
    paged_kv_cache_shardings,
)
from scaletorch_tpu_torch.inference.resilience import (
    TERMINAL_OUTCOMES,
    EngineDraining,
    ServingFaultInjector,
)
from scaletorch_tpu_torch.inference.sampling import SamplingParams
from scaletorch_tpu_torch.telemetry.spans import NOOP_SPAN
from scaletorch_tpu_torch.telemetry.histogram import LogHistogram
from scaletorch_tpu_torch.utils.device import DeviceLike, resolve_device
from scaletorch_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


@dataclass
class Request:
    """One generation request. ``eos_id`` stops the slot early;
    ``max_new_tokens`` always bounds it; the engine's ``max_seq`` caps
    prompt + generation regardless. ``deadline`` (absolute monotonic
    time, or None) retires the request with ``timeout`` wherever it is.
    ``trace_id`` (None = untraced) keys the request's lifecycle events on
    the tracer's async track. ``admit_time`` is stamped when the request
    enters a slot."""

    request_id: int
    prompt: List[int]
    max_new_tokens: int = 64
    eos_id: Optional[int] = None
    seed: int = 0
    submit_time: float = field(default_factory=time.monotonic)
    deadline: Optional[float] = None
    trace_id: Optional[str] = None
    admit_time: Optional[float] = None


@dataclass
class RequestResult:
    """The single terminal record of a request. ``finish_reason`` refines
    an ``ok`` outcome ('eos' | 'length' | 'max_seq') and repeats the
    outcome otherwise."""

    request_id: int
    prompt: List[int]
    tokens: List[int]               # generated tokens (prompt excluded)
    finish_reason: str
    outcome: str = "ok"             # one of TERMINAL_OUTCOMES
    detail: Optional[str] = None
    ttft_s: Optional[float] = None  # submit -> first generated token
    latency_s: Optional[float] = None
    queue_wait_s: Optional[float] = None
    prefill_s: Optional[float] = None
    prefix_hit: bool = False
    trace_id: Optional[str] = None


@dataclass
class EngineMetrics:
    """Serving counters/gauges; ``snapshot()`` is flat numeric. The
    per-outcome counters satisfy ``requests_submitted ==
    sum(requests_<outcome>)`` once the engine is drained."""

    requests_submitted: int = 0
    requests_completed: int = 0     # ok outcomes only
    requests_admitted: int = 0      # entered a slot (prefilled)
    tokens_generated: int = 0
    prefill_calls: int = 0
    decode_steps: int = 0
    queue_depth: int = 0
    active_slots: int = 0
    num_slots: int = 0
    # paged layout: pool occupancy and the radix prefix cache's yield
    pages_in_use: int = 0
    page_pool_free: int = 0
    prefix_hits: int = 0
    prefill_tokens_saved: int = 0
    prefix_pages: int = 0
    # radix pages this engine installed from a peer (import_prefix_pages)
    warm_pages_total: int = 0
    ttft_sum_s: float = 0.0
    ttft_count: int = 0
    outcomes: Dict[str, int] = field(
        default_factory=lambda: {o: 0 for o in TERMINAL_OUTCOMES})
    hist: Dict[str, LogHistogram] = field(default_factory=lambda: {
        name: LogHistogram()
        for name in ("ttft", "tpot", "queue_wait", "prefill", "e2e")})
    _window_start: float = field(default_factory=time.monotonic)
    _window_tokens: int = 0

    def record_ttft(self, ttft_s: float) -> None:
        self.ttft_sum_s += ttft_s
        self.ttft_count += 1
        self.hist["ttft"].observe(ttft_s)

    def histogram_state(self) -> Dict[str, Dict]:
        """Sparse JSON form of every latency histogram (the
        ``latency_histograms`` JSONL record shape, unlabeled)."""
        return {name: h.to_dict() for name, h in self.hist.items()
                if h.count}

    def record_outcome(self, outcome: str) -> None:
        self.outcomes[outcome] += 1
        if outcome == "ok":
            self.requests_completed += 1

    def tokens_per_second(self) -> float:
        dt = time.monotonic() - self._window_start
        return self._window_tokens / dt if dt > 0 else 0.0

    def reset_window(self) -> None:
        self._window_start = time.monotonic()
        self._window_tokens = 0

    def snapshot(self) -> Dict[str, float]:
        terminal = sum(self.outcomes.values())
        snap = {
            "requests_submitted": self.requests_submitted,
            "requests_completed": self.requests_completed,
            "tokens_generated": self.tokens_generated,
            "prefill_calls": self.prefill_calls,
            "decode_steps": self.decode_steps,
            "queue_depth": self.queue_depth,
            "num_slots": self.num_slots,
            "slot_occupancy": (
                self.active_slots / self.num_slots if self.num_slots else 0.0
            ),
            "tokens_per_second": self.tokens_per_second(),
            "mean_ttft_s": (
                self.ttft_sum_s / self.ttft_count if self.ttft_count else 0.0
            ),
            "deadline_miss_rate": (
                self.outcomes["timeout"] / terminal if terminal else 0.0
            ),
            "quarantine_rate": (
                self.outcomes["quarantined"] / terminal if terminal else 0.0
            ),
            "pages_in_use": self.pages_in_use,
            "page_pool_free": self.page_pool_free,
            "prefix_hit_rate": (
                self.prefix_hits / self.requests_admitted
                if self.requests_admitted else 0.0
            ),
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefix_pages": self.prefix_pages,
            "warm_pages_total": self.warm_pages_total,
        }
        for outcome, count in self.outcomes.items():
            snap[f"requests_{outcome}"] = count
        return snap


class _Slot:
    """Host-side state of one decode slot."""

    __slots__ = ("request", "tokens", "position", "generated",
                 "first_token_t", "last_token_t", "prefill_s", "prefix_hit")

    def __init__(self) -> None:
        self.request: Optional[Request] = None
        self.tokens: List[int] = []
        self.position = 0        # absolute position of the NEXT token to feed
        self.generated = 0
        self.first_token_t: Optional[float] = None
        self.last_token_t: Optional[float] = None
        self.prefill_s: Optional[float] = None
        self.prefix_hit = False

    @property
    def active(self) -> bool:
        return self.request is not None


def dtype_name(dtype: Any) -> str:
    """A dtype as the warm exchange names it: the reference's name
    (``"float32"``, ``"bfloat16"``), for a torch dtype or a name in
    either spelling."""
    return str(dtype).removeprefix("torch.")


def _page_bytes(page: torch.Tensor) -> bytes:
    """One page's bytes as laid out in the pool (any dtype, bf16 too)."""
    return page.contiguous().view(torch.uint8).numpy().tobytes()


def _in_mesh(fn: Callable, mesh) -> Callable:
    """``fn`` with ``mesh`` the current mesh manager while it runs."""
    from scaletorch_tpu_torch.parallel.mesh import using_mesh_manager

    def scoped(**kw):
        with using_mesh_manager(mesh):
            return fn(**kw)

    return scoped


def _to_host(out: Tuple[torch.Tensor, ...]) -> np.ndarray:
    """A step's [2, B] (token, finite) rows on the host: the step's one
    device-to-host copy, which waits for the card."""
    token, _logits, finite = out
    return torch.stack([token, finite.long()]).cpu().numpy()


class InferenceEngine:
    """KV-cache decode with continuous batching.

    Parameters
    ----------
    params : the model — a ``LlamaForCausalLM``, ``Qwen3MoEForCausalLM``
        or ``GPTMoEForCausalLM`` (or any module with ``forward_cached``),
        or a parameter tree in the reference layout (torch tensors or
        numpy arrays, e.g. ``init_params``' output or a JAX tree through
        ``np.asarray``), which is loaded into a new model of the config's
        family on ``device``.
    cfg : the model's config (``LlamaConfig``, ``Qwen3Config``,
        ``Qwen3MoEConfig`` or ``GPTMoEConfig``; a GPT-MoE engine's
        ``max_seq`` is at most the config's ``block_size``, the length of
        its position table).
    max_slots : decode batch size B (fixed).
    max_seq : cache length S_max (prompt + generation cap per slot).
    prefill_len : static prompt-buffer length P_max (default
        ``max_seq``); longer prompts are rejected.
    sampling : engine-wide sampling knobs.
    cache_dtype : KV dtype (default: the config's compute dtype).
    cache_layout : ``"dense"`` (per-slot [L,B,Hkv,S_max,D] buffers) or
        ``"paged"`` (a pool [L,n_pages,Hkv,page_size,D] plus per-slot
        page tables, page-budget-aware admission).
    page_size, num_pages, prefix_cache : paged layout only; ``num_pages``
        includes the reserved TRASH page (None: the dense-equivalent
        ``max_slots * ceil(max_seq / page_size) + 1``); ``prefix_cache``
        keeps the radix tree over page-aligned prompt prefixes.
    queue_capacity : with more queued requests than this, the OLDEST is
        shed (0 = unbounded).
    default_ttl_s : deadline for requests submitted without ``ttl_s``
        (0 = none).
    strict_submit : True raises on an invalid ``submit()``; False ends
        it as a ``rejected`` terminal result.
    forward_fn : override of the cached forward, with the signature
        ``(model, tokens, cfg, cache, **kw)``.
    monitor, monitor_every : a ``SystemMonitor`` sampled with the metrics
        snapshot every ``monitor_every`` decode steps.
    tracer : a ``SpanTracer``: ``tick``/``admission``/``prefill``/
        ``decode`` spans per tick (the decode span covers the replay and
        its one token copy back) and request async events.
    exporter : a ``TelemetryExporter`` fed an ``engine_metrics`` record
        every ``monitor_every`` decode steps when the counters moved, and
        at the end of ``run()``/``drain()``.
    injector : a ``ServingFaultInjector`` (NaN logits, slow decode,
        submit and deadline storms).
    preemption : a ``PreemptionHandler``; once it is requested, ``run()``
        drains the engine.
    watchdog : a ``HangWatchdog`` beaten at the top of each ``step()``
        (``make_serving_watchdog`` attaches one).
    on_tokens : ``(slot, request_id, token_ids)`` callback fed each
        newly sampled token on the host; a raising hook is disarmed.
    paged_kernel : the decode attention route of the paged layout:
        None takes the CUDA kernel on the card and the gather path on
        the CPU; False forces the gather path (the reference run).
    device : where the engine runs; None means the CUDA card and raises
        without one. Pass ``"cpu"`` for the plain PyTorch path. On the
        card both steps are captured as CUDA graphs here, in the
        constructor (a Qwen3-MoE config must move tokens by index:
        the one-hot form cannot be captured).
    mesh / tp_axis / batch_axis : serve over a mesh (the module
        docstring): a Llama/Qwen3 model's or a GPT-MoE's weights over
        ``tp_axis``, a Qwen3-MoE's over ``tp_axis`` and its experts over
        ``ep`` (a full
        parameter tree is cut to this rank's shards; a module must have
        been built for the mesh), the cache's KV heads over ``tp_axis``
        (whole over ep) and, dense models and the dense layout only, its
        slots over ``batch_axis`` (each rank computes its slots; the
        tokens are all-gathered in the step). ``device`` is this rank's
        card.
    donate_cache : accepted for the reference's signature; the buffers
        are written in place whatever it says (the counterpart of
        donation).
    """

    def __init__(
        self,
        params: Any,
        cfg: Any,
        *,
        max_slots: int = 4,
        max_seq: int = 512,
        prefill_len: Optional[int] = None,
        sampling: SamplingParams = SamplingParams(),
        cache_dtype: Optional[torch.dtype] = None,
        cache_layout: str = "dense",
        page_size: int = 16,
        num_pages: Optional[int] = None,
        prefix_cache: bool = True,
        queue_capacity: int = 0,
        default_ttl_s: float = 0.0,
        strict_submit: bool = True,
        forward_fn: Optional[Callable] = None,
        monitor: Any = None,
        monitor_every: int = 16,
        tracer: Any = None,
        exporter: Any = None,
        injector: Optional[ServingFaultInjector] = None,
        preemption: Any = None,
        watchdog: Any = None,
        on_tokens: Optional[Callable[[int, int, List[int]], None]] = None,
        paged_kernel: Optional[bool] = None,
        device: DeviceLike = None,
        mesh: Any = None,
        tp_axis: str = "tp",
        batch_axis: Optional[str] = None,
        donate_cache: Optional[bool] = None,
    ) -> None:
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if max_seq < 2:
            raise ValueError(f"max_seq must be >= 2, got {max_seq}")
        if queue_capacity < 0:
            raise ValueError(
                f"queue_capacity must be >= 0 (0 = unbounded), "
                f"got {queue_capacity}")
        if default_ttl_s < 0:
            raise ValueError(
                f"default_ttl_s must be >= 0 (0 = no deadline), "
                f"got {default_ttl_s}")
        if cache_layout not in ("dense", "paged"):
            raise ValueError(
                f"cache_layout must be 'dense' or 'paged', "
                f"got {cache_layout!r}")
        block = getattr(cfg, "block_size", None)
        if block is not None and max_seq > block:
            raise ValueError(
                f"max_seq {max_seq} exceeds the model's block_size {block} "
                "(its learned position table)")
        self._check_mesh(cfg, mesh, tp_axis, batch_axis, cache_layout,
                         max_slots)
        self.mesh, self.tp_axis, self.batch_axis = mesh, tp_axis, batch_axis
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        resolved_dispatch = getattr(cfg, "resolved_moe_dispatch", None)
        if on_card and resolved_dispatch and resolved_dispatch() != "index":
            raise ValueError(
                "the engine captures its steps as CUDA graphs on the card, "
                "and the one-hot MoE movement (moe_dispatch='einsum') calls "
                "nonzero, which capture forbids; use moe_dispatch='index' "
                "or 'auto'")
        self.model = self._resolve_model(params, cfg)
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.prefill_len = prefill_len or max_seq
        if self.prefill_len > max_seq:
            raise ValueError(
                f"prefill_len {self.prefill_len} exceeds max_seq {max_seq}")
        self.sampling = sampling
        self.queue_capacity = queue_capacity
        self.default_ttl_s = default_ttl_s
        self.strict_submit = strict_submit
        self.monitor = monitor
        self.monitor_every = monitor_every
        self.tracer = tracer
        self.exporter = exporter
        self.injector = injector
        self.preemption = preemption
        self.watchdog = watchdog
        self.on_tokens = on_tokens
        self._forward_fn = forward_fn

        self.cache_layout = cache_layout
        self._paged = cache_layout == "paged"
        if self._paged and page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self._pages_per_slot = (
            ceil_div(max_seq, page_size) if self._paged else 0)
        if num_pages is None and self._paged:
            num_pages = max_slots * self._pages_per_slot + 1
        self.num_pages = num_pages

        sharding = None
        if mesh is not None:
            sharding = (paged_kv_cache_shardings(mesh, tp_axis=tp_axis)
                        if self._paged else
                        kv_cache_shardings(mesh, tp_axis=tp_axis,
                                           batch_axis=batch_axis))
        # this rank's slots of the dense cache (all of them without
        # batch_axis)
        self._local_rows = slice(None)
        if batch_axis is not None:
            w = max_slots // mesh.axis_size(batch_axis)
            r = mesh.axis_rank(batch_axis)
            self._local_rows = slice(r * w, (r + 1) * w)
        if self._paged:
            self.cache = init_paged_kv_cache(
                cfg, num_pages, page_size, dtype=cache_dtype,
                device=self.device, sharding=sharding)
            self.allocator = PageAllocator(num_pages)
            self.radix = (
                RadixPrefixCache(
                    page_size, self.allocator.retain, self.allocator.release,
                    self.allocator.refcount,
                ) if prefix_cache else None
            )
            # per-slot page tables (host copy, pinned on the card), the
            # pages each slot holds a reference on (shared prefix pages
            # first), and how many leading entries are FROZEN (shared or
            # radix-registered)
            tables = torch.full((max_slots, self._pages_per_slot),
                                TRASH_PAGE, dtype=torch.int32,
                                pin_memory=on_card)
            self._tables_host = tables
            self._tables = tables.numpy()
            # the static device copy both steps read, refreshed with one
            # copy_ before a step that follows a host write
            self._tables_dev = tables.to(self.device, copy=True)
            self._tables_dirty = False
            self._slot_pages: List[List[int]] = [[] for _ in range(max_slots)]
            self._slot_frozen = [0] * max_slots
            logger.info(
                "inference engine: %d slots over %d pages x %d tokens, "
                "pool %.1f MiB on %s%s",
                max_slots, num_pages, page_size,
                kv_cache_bytes(cfg, max_slots, max_seq, dtype=cache_dtype,
                               layout="paged", page_size=page_size,
                               num_pages=num_pages,
                               sharding=sharding) / 2**20,
                self.device, ", prefix cache on" if prefix_cache else "")
            prefill = functools.partial(
                make_paged_prefill_step(
                    cfg, sampling, page_size=page_size, seq_limit=max_seq,
                    forward_fn=forward_fn),
                self.model, page_tables=self._tables_dev, pool=self.cache)
            decode = functools.partial(
                make_paged_decode_step(
                    cfg, sampling, page_size=page_size, seq_limit=max_seq,
                    forward_fn=forward_fn, kernel=paged_kernel),
                self.model, page_tables=self._tables_dev, pool=self.cache)
            prefill_meta = dict(tail_lens=np.ones(max_slots, np.int32),
                                starts=np.zeros(max_slots, np.int32))
        else:
            self.cache = init_kv_cache(cfg, max_slots, max_seq,
                                       dtype=cache_dtype, device=self.device,
                                       sharding=sharding)
            self.allocator = None
            self.radix = None
            logger.info(
                "inference engine: %d slots x %d positions, cache %.1f MiB "
                "on %s", max_slots, max_seq,
                kv_cache_bytes(cfg, max_slots, max_seq, dtype=cache_dtype,
                               sharding=sharding) / 2**20, self.device)
            prefill = functools.partial(
                make_prefill_step(cfg, sampling, forward_fn=forward_fn,
                                  batch_axis=batch_axis),
                self.model, cache=self.cache)
            decode = functools.partial(
                make_decode_step(cfg, sampling, forward_fn=forward_fn,
                                 batch_axis=batch_axis),
                self.model, cache=self.cache)
            prefill_meta = dict(lengths=np.ones(max_slots, np.int32))
        if mesh is not None:
            # the axis names resolve in the mesh while a step runs (and
            # while it is captured)
            prefill, decode = _in_mesh(prefill, mesh), _in_mesh(decode, mesh)
        # the clock's and the signals' decisions, made on rank 0 (None:
        # one process, nothing to share)
        self._host_group = (mesh.host_group()
                            if mesh is not None and mesh.world_size > 1
                            else None)
        self._preempt_agreed = False
        # the inputs' first values write nothing (no slot masked in), so
        # the capture's warm-up run leaves the cache as it was
        b = max_slots
        self._prefill = self._make_prefill_step(prefill, dict(
            tokens=np.zeros((b, self.prefill_len), np.int32), **prefill_meta,
            write_mask=np.zeros(b, bool), seeds=np.zeros(b, np.int64)))
        self._decode = StaticStep(decode, dict(
            tokens=np.zeros(b, np.int32), positions=np.zeros(b, np.int32),
            active=np.zeros(b, bool), seeds=np.zeros(b, np.int64)),
            self.device)
        self._fill_slots = make_fill_slots_step()

        self._slots = [_Slot() for _ in range(max_slots)]
        self._queue: deque[Request] = deque()
        self._results: Dict[int, RequestResult] = {}
        self._finished_tick: List[RequestResult] = []
        self._ids = itertools.count()
        self._seeds = np.zeros(max_slots, np.int64)
        self._draining = False
        self.metrics = EngineMetrics(num_slots=max_slots)
        if self._paged:
            self._update_page_gauges()
        # progress fingerprint of the last JSONL export: an idle engine
        # appends no duplicate records
        self._exported_key = self._export_key()

    @staticmethod
    def _check_mesh(cfg, mesh, tp_axis: str, batch_axis: Optional[str],
                    cache_layout: str, max_slots: int) -> None:
        """The reference's checks of a serving mesh, and the port's: a
        dense model or a GPT-MoE over tp and dp, a Qwen3-MoE over tp and
        ep (and replicas over dp, no ``batch_axis``)."""
        if mesh is None:
            if batch_axis is not None:
                raise ValueError("batch_axis needs a mesh")
            return
        if tp_axis != "tp":
            raise ValueError(f"tp_axis must be 'tp', got {tp_axis!r}")
        from scaletorch_tpu_torch.models import gpt_moe

        if isinstance(cfg, gpt_moe.GPTMoEConfig):
            gpt_moe.check_serving_mesh(cfg, mesh)
        elif hasattr(cfg, "num_experts"):
            from scaletorch_tpu_torch.models.qwen3_moe import (
                check_serving_mesh,
            )

            check_serving_mesh(cfg, mesh)
            if batch_axis is not None:
                raise ValueError(
                    "a Qwen3-MoE serving mesh shards no slots: every rank "
                    "of its tp x ep group holds every slot (batch_axis "
                    "must be None)")
            return
        if mesh.pp > 1 or mesh.cp > 1 or mesh.ep > 1:
            raise ValueError(
                f"a serving mesh spans tp and dp only, got {mesh!r}")
        if batch_axis is not None:
            if cache_layout == "paged":
                raise ValueError(
                    "batch_axis shards dense slots: the paged pool's pages "
                    "are not slot-aligned (dense layout only)")
            if batch_axis != "dp":
                raise ValueError(
                    f"batch_axis must be 'dp' or None, got {batch_axis!r}")
            if max_slots % mesh.dp:
                raise ValueError(
                    f"max_slots {max_slots} does not split over dp="
                    f"{mesh.dp}")

    def _resolve_model(self, params, cfg) -> torch.nn.Module:
        if not isinstance(params, torch.nn.Module):
            from scaletorch_tpu_torch.models.gpt_moe import (
                GPTMoEConfig,
                GPTMoEForCausalLM,
            )
            from scaletorch_tpu_torch.models.llama import LlamaForCausalLM
            from scaletorch_tpu_torch.models.qwen3_moe import (
                Qwen3MoEConfig,
                Qwen3MoEForCausalLM,
            )

            family = (GPTMoEForCausalLM if isinstance(cfg, GPTMoEConfig)
                      else Qwen3MoEForCausalLM
                      if isinstance(cfg, Qwen3MoEConfig)
                      else LlamaForCausalLM)
            return family.from_params(params, cfg, device=self.device,
                                      mesh=self.mesh)
        for axis in ("tp", "ep"):
            want = getattr(self.mesh, axis) if self.mesh else 1
            held = getattr(params, f"{axis}_size", 1)
            if held != want:
                raise ValueError(
                    f"the model holds {axis}={held} shards, the engine's "
                    f"mesh has {axis}={want}")
        dev = next(params.parameters()).device
        if dev.type != self.device.type or (
                self.device.index is not None and dev != self.device):
            raise ValueError(
                f"the model lives on {dev}, the engine runs on {self.device}")
        self.device = dev
        return params

    def _make_prefill_step(self, prefill: Callable,
                           inputs: Dict[str, np.ndarray]) -> StaticStep:
        """The prefill step over its static buffers (captured here on the
        card). A disaggregated engine builds its own, over the pool of its
        prefill slice."""
        return StaticStep(prefill, inputs, self.device)

    def _update_page_gauges(self) -> None:
        self.metrics.pages_in_use = self.allocator.used_count
        self.metrics.page_pool_free = self.allocator.free_count
        self.metrics.prefix_pages = (
            len(self.radix) if self.radix is not None else 0)

    def _upload_tables(self) -> None:
        """Refresh the static device page tables from the host copy, once
        per host write rather than once per step."""
        if self._tables_dirty:
            with torch.inference_mode():
                self._tables_dev.copy_(self._tables_host, non_blocking=True)
            self._tables_dirty = False

    def _span(self, name: str, **args):
        """A telemetry span when a tracer is attached, the shared no-op
        otherwise (spans time the host, never force a sync)."""
        if self.tracer is None:
            return NOOP_SPAN
        return self.tracer.span(name, **args)

    def _req_event(self, ph: str, req: Request, name: str, **args) -> None:
        """A request-scoped async event (``ph`` in 'b'/'e'/'n') on the
        request's trace_id track; one branch when untraced. The lifecycle
        vocabulary is request / req.queued / req.admitted / req.prefill /
        req.decode / req.finalize."""
        if self.tracer is None or req.trace_id is None:
            return
        self.tracer.async_event(ph, name, req.trace_id, **args)

    def _export_key(self):
        """Progress fingerprint for the JSONL export (counters only: the
        snapshot's rates move on every call)."""
        return (self.metrics.decode_steps, self.metrics.requests_submitted,
                tuple(sorted(self.metrics.outcomes.items())))

    def _export_snapshot(self) -> None:
        """Append a metrics record to the JSONL stream iff the counters
        moved since the last export."""
        key = self._export_key()
        if key == self._exported_key:
            return
        self._exported_key = key
        self.exporter.emit("engine_metrics", self.metrics.snapshot())

    # ---- compile accounting (the one-capture contract) --------------------
    @property
    def decode_compile_count(self) -> int:
        """CUDA-graph captures of the decode step (on the CPU, the one
        static step built)."""
        return self._decode.compile_count

    @property
    def prefill_compile_count(self) -> int:
        return self._prefill.compile_count

    def _request_pages(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case pages a request reserves: prompt plus generation,
        capped by ``max_seq``."""
        total = min(prompt_len + max_new_tokens, self.max_seq)
        return ceil_div(total, self.page_size)

    @property
    def draining(self) -> bool:
        return self._draining

    # ---- request lifecycle ----------------------------------------------
    def submit(
        self,
        prompt: List[int],
        *,
        max_new_tokens: int = 64,
        eos_id: Optional[int] = None,
        seed: int = 0,
        ttl_s: Optional[float] = None,
        trace_id: Optional[str] = None,
    ) -> int:
        """Queue a request; returns its id. Admission happens inside
        ``step()`` when a slot (and, paged, the pages) frees up.

        ``ttl_s`` sets this request's deadline (None = engine
        ``default_ttl_s``; <= 0 = none). ``trace_id`` keys the request's
        lifecycle events on the tracer. Invalid submissions raise
        (``strict_submit``) or end as ``rejected``; a draining engine
        raises ``EngineDraining`` / rejects. A full queue sheds its
        OLDEST request. Over a mesh every rank submits the same requests
        in the same order (each rank's engine numbers them alike)."""
        err = None
        if self._draining:
            err = "engine is draining: admissions are stopped"
        elif not prompt:
            err = "prompt must contain at least one token"
        elif len(prompt) > self.prefill_len:
            err = (
                f"prompt length {len(prompt)} exceeds the engine's static "
                f"prefill buffer ({self.prefill_len}); re-create the engine "
                "with a larger prefill_len/max_seq")
        elif len(prompt) >= self.max_seq:
            err = (
                f"prompt length {len(prompt)} leaves no room to generate "
                f"within max_seq {self.max_seq}")
        elif (self._paged and self._request_pages(len(prompt), max_new_tokens)
                > self.allocator.capacity):
            err = (
                f"request needs "
                f"{self._request_pages(len(prompt), max_new_tokens)} pages "
                f"but the pool's capacity is {self.allocator.capacity}; "
                "re-create the engine with more num_pages or cap "
                "max_new_tokens")
        if err is not None and self.strict_submit:
            raise EngineDraining(err) if self._draining else ValueError(err)
        req = Request(request_id=next(self._ids), prompt=list(prompt),
                      max_new_tokens=max_new_tokens, eos_id=eos_id, seed=seed,
                      trace_id=trace_id)
        ttl = self.default_ttl_s if ttl_s is None else ttl_s
        if ttl and ttl > 0:
            req.deadline = req.submit_time + ttl
        self.metrics.requests_submitted += 1
        self._req_event("b", req, "request", request_id=req.request_id)
        self._req_event("b", req, "req.queued")
        if err is not None:
            self._finalize(req, "rejected", tokens=[], detail=err,
                           now=time.monotonic())
            return req.request_id
        self._queue.append(req)
        while self.queue_capacity and len(self._queue) > self.queue_capacity:
            shed = self._queue.popleft()
            self._finalize(
                shed, "shed", tokens=[],
                detail=(f"queue exceeded capacity {self.queue_capacity}; "
                        "oldest request shed"),
                now=time.monotonic())
        self.metrics.queue_depth = len(self._queue)
        return req.request_id

    def _finalize(
        self,
        req: Request,
        outcome: str,
        *,
        tokens: List[int],
        reason: Optional[str] = None,
        detail: Optional[str] = None,
        ttft_t: Optional[float] = None,
        prefill_s: Optional[float] = None,
        prefix_hit: bool = False,
        now: float,
    ) -> None:
        """Record the single terminal result of ``req``: every request
        path funnels through here, so conservation holds by
        construction."""
        latency = now - req.submit_time
        queue_wait = (req.admit_time - req.submit_time
                      if req.admit_time is not None else None)
        self._results[req.request_id] = RequestResult(
            request_id=req.request_id,
            prompt=req.prompt,
            tokens=tokens,
            finish_reason=reason or outcome,
            outcome=outcome,
            detail=detail,
            ttft_s=(ttft_t - req.submit_time) if ttft_t is not None else None,
            latency_s=latency,
            queue_wait_s=queue_wait,
            prefill_s=prefill_s,
            prefix_hit=prefix_hit,
            trace_id=req.trace_id,
        )
        if req.admit_time is not None and outcome in ("ok", "timeout"):
            # only SERVED requests feed the e2e histogram
            self.metrics.hist["e2e"].observe(latency)
        self._req_event("e", req, "req.decode" if req.admit_time is not None
                        else "req.queued")
        self._req_event("n", req, "req.finalize", outcome=outcome,
                        finish_reason=reason or outcome)
        self._req_event("e", req, "request", outcome=outcome)
        self._finished_tick.append(self._results[req.request_id])
        self.metrics.record_outcome(outcome)
        if outcome != "ok":
            logger.warning("request %d -> %s%s", req.request_id, outcome,
                           f" ({detail})" if detail else "")

    def _retire_slot(self, i: int, outcome: str, *,
                     reason: Optional[str] = None,
                     detail: Optional[str] = None, now: float) -> None:
        """Terminal-result a slot's request (partial tokens attached) and
        free the slot."""
        slot = self._slots[i]
        req = slot.request
        self._finalize(
            req, outcome, tokens=slot.tokens[len(req.prompt):],
            reason=reason, detail=detail, ttft_t=slot.first_token_t,
            prefill_s=slot.prefill_s, prefix_hit=slot.prefix_hit, now=now)
        slot.request = None
        slot.tokens = []
        if self._paged:
            # drop the slot's references; pages shared with live slots or
            # pinned by the radix tree survive, the rest return to the
            # free list
            for p in self._slot_pages[i]:
                self.allocator.release(p)
            self._slot_pages[i] = []
            self._slot_frozen[i] = 0
            self._tables[i, :] = TRASH_PAGE
            self._tables_dirty = True
            self._update_page_gauges()

    def _expire(self, now: float) -> None:
        """Deadline sweep over queued and mid-decode requests. On a mesh
        the requests whose deadline passed are rank 0's, and so is the
        preemption flag: one broadcast a tick, made only while a request
        has a deadline or a preemption handler is installed (replicated
        state, so every rank skips it alike; it costs the host ~2 ms)."""
        due = [r.request_id for r in self._queue
               if r.deadline is not None and now >= r.deadline]
        due += [s.request.request_id for s in self._slots
                if s.active and s.request.deadline is not None
                and now >= s.request.deadline]
        timed = (self.preemption is not None
                 or any(r.deadline is not None for r in self._queue)
                 or any(s.active and s.request.deadline is not None
                        for s in self._slots))
        if self._host_group is not None and timed:
            preempt = (self.preemption is not None
                       and self.preemption.requested)
            due, self._preempt_agreed = self._agree((due, preempt))
        due = set(due)
        if self._queue:
            kept: deque[Request] = deque()
            for req in self._queue:
                if req.request_id in due:
                    self._finalize(
                        req, "timeout", tokens=[],
                        detail="deadline exceeded before admission", now=now)
                else:
                    kept.append(req)
            self._queue = kept
            self.metrics.queue_depth = len(self._queue)
        for i, slot in enumerate(self._slots):
            if slot.active and slot.request.request_id in due:
                self._retire_slot(
                    i, "timeout", detail="deadline exceeded mid-decode",
                    now=now)

    def _quarantine(self, indices: List[int], now: float, where: str) -> None:
        """Retire poisoned slots (non-finite logits) and zero their cache
        lines so the NaN K/V cannot outlive the request. Paged, only the
        slot's MUTABLE pages (past the frozen prefix) are cleared: frozen
        pages were written once by a healthy prefill and may be shared."""
        if self._paged:
            mask = np.zeros(self.num_pages, bool)
            for i in indices:
                mutable = self._slot_pages[i][self._slot_frozen[i]:]
                mask[mutable] = True
                self._retire_slot(i, "quarantined",
                                  detail=f"non-finite logits at {where}",
                                  now=now)
        else:
            mask = np.zeros(self.max_slots, bool)
            for i in indices:
                self._retire_slot(i, "quarantined",
                                  detail=f"non-finite logits at {where}",
                                  now=now)
                mask[i] = True
        self._fill(mask, 0.0)

    def _fill(self, mask: np.ndarray, value: float) -> None:
        """``value`` into the cache lines ``mask`` selects (slots dense,
        pages paged), this rank's rows of them."""
        if not self._paged:
            mask = mask[self._local_rows]
        with torch.inference_mode():
            self._fill_slots(self.cache, mask, value)

    def _agree(self, local: Any) -> Any:
        """Rank 0's ``local`` on every rank of the mesh (one gloo
        broadcast); ``local`` itself in one process."""
        if self._host_group is None:
            return local
        import torch.distributed as dist

        box = [local]
        dist.broadcast_object_list(box, src=0, group=self._host_group)
        return box[0]

    def _preemption_requested(self) -> bool:
        """Whether a preemption asks for a drain: the handler's flag, or on
        a mesh rank 0's, as the last tick shared it."""
        if self._host_group is not None:
            return self._preempt_agreed
        return self.preemption is not None and self.preemption.requested

    def _poison_slot(self, slot_idx: int) -> None:
        """Fault injection: NaN-fill one slot's cache lines so its next
        decode step gives non-finite logits, through the quarantine's
        in-place fill. Paged, only the slot's MUTABLE pages: frozen prefix
        pages may be shared, and poisoning them would fault neighbours
        (with a page-aligned prompt the poison shows from the second
        decode on)."""
        active = [i for i, s in enumerate(self._slots) if s.active]
        if not active:
            logger.warning(
                "fault injection: no active slot to poison; skipping")
            return
        if slot_idx not in active:
            slot_idx = active[0]
        if self._paged:
            mask = np.zeros(self.num_pages, bool)
            mask[self._slot_pages[slot_idx][
                self._slot_frozen[slot_idx]:]] = True
        else:
            mask = np.zeros(self.max_slots, bool)
            mask[slot_idx] = True
        self._fill(mask, float("nan"))

    # ---- warm prefix exchange ----------------------------------------------
    # A fresh engine warms its radix tree from a live peer. The donor side
    # (export_prefix_map / export_prefix_pages) only reads: each page it
    # ships is retained across the copy to the host and released after,
    # so the donor's conservation never moves. The recipient
    # (import_prefix_pages) allocates pool pages, copies the bytes into
    # the pool in place (index_copy_ along the page axis: same storage,
    # no recapture), registers the chains, and drops its allocation
    # references in a ``finally`` so an interrupted import leaves the
    # allocator conserved.

    def _page_shape(self) -> List[int]:
        """One page's shape in the pool: [L, Hkv, page_size, D]."""
        return ([int(self.cache.k.shape[0])]
                + [int(d) for d in self.cache.k.shape[2:]])

    def export_prefix_map(self) -> Dict[str, Any]:
        """The radix tree for a warming peer: root-to-leaf token chains
        with their page ids, and each registered page's refcount."""
        if not self._paged or self.radix is None:
            return {"page_size": self.page_size if self._paged else None,
                    "chains": [], "pages": {}}
        return {
            "page_size": self.page_size,
            "dtype": dtype_name(self.cache.k.dtype),
            "page_shape": self._page_shape(),
            "chains": [
                {"tokens": [int(t) for t in tokens],
                 "pages": [int(p) for p in pages]}
                for tokens, pages in self.radix.chains()],
            "pages": {
                int(p): {"refcount": self.allocator.refcount(p),
                         "frozen": True}
                for p in self.radix.registered_pages()},
            "capacity": self.allocator.capacity,
            "free": self.allocator.free_count,
        }

    def export_prefix_pages(
        self, pages: Sequence[int]
    ) -> Tuple[Dict[str, Any], Dict[int, Tuple[bytes, bytes]]]:
        """The requested FROZEN pages' K/V bytes, copied to the host:
        ``(meta, {page: (k_bytes, v_bytes)})``. Pages no longer registered
        are left out."""
        meta: Dict[str, Any] = {
            "dtype": dtype_name(self.cache.k.dtype) if self._paged else None,
            "page_shape": self._page_shape() if self._paged else [],
            "page_size": self.page_size if self._paged else None,
        }
        contents: Dict[int, Tuple[bytes, bytes]] = {}
        if not self._paged or self.radix is None:
            return meta, contents
        frozen = set(self.radix.registered_pages())
        valid = [int(p) for p in pages if int(p) in frozen]
        if not valid:
            return meta, contents
        for p in valid:
            self.allocator.retain(p)
        try:
            idx = torch.tensor(valid, dtype=torch.long, device=self.device)
            with torch.inference_mode():
                k_host = self.cache.k.index_select(1, idx).cpu()
                v_host = self.cache.v.index_select(1, idx).cpu()
        finally:
            for p in valid:
                self.allocator.release(p)
        for i, p in enumerate(valid):
            contents[p] = (_page_bytes(k_host[:, i]),
                           _page_bytes(v_host[:, i]))
        return meta, contents

    def import_prefix_pages(
        self,
        chains: Sequence[Tuple[Sequence[int], Sequence[int]]],
        contents: Dict[int, Tuple[bytes, bytes]],
        *,
        dtype: Optional[str],
        page_shape: Sequence[int],
        page_size: Optional[int],
    ) -> Dict[str, Any]:
        """Install a donor's pages into this engine's pool and radix tree.
        ``chains`` holds donor ``(tokens, donor_pages)`` paths; a chain
        whose page bytes are missing keeps its valid PREFIX. Returns
        ``{"pages": new radix pages, "chains": [registered tokens]}``."""
        result: Dict[str, Any] = {"pages": 0, "chains": []}
        if not self._paged or self.radix is None:
            return result
        expected = tuple(self._page_shape())
        if (page_size != self.page_size
                or dtype_name(dtype) != dtype_name(self.cache.k.dtype)
                or tuple(int(d) for d in page_shape) != expected):
            logger.warning(
                "warm import skipped: peer pool is incompatible "
                "(page_size=%s dtype=%s shape=%s vs local %s/%s/%s)",
                page_size, dtype, tuple(page_shape), self.page_size,
                self.cache.k.dtype, expected)
            return result
        page_nbytes = int(np.prod(expected)) * self.cache.k.element_size()
        imported: Dict[int, int] = {}       # donor page -> local page
        newly_allocated: List[int] = []
        planned: List[Tuple[List[int], List[int]]] = []
        try:
            for tokens, donor_pages in chains:
                local: List[int] = []
                for dp in donor_pages:
                    dp = int(dp)
                    lp = imported.get(dp)
                    if lp is None:
                        data = contents.get(dp)
                        if (data is None or len(data[0]) != page_nbytes
                                or len(data[1]) != page_nbytes):
                            break  # bytes never arrived: keep the prefix
                        got = self.allocator.alloc(1)
                        if got is None:
                            break  # pool pressure: warm what fits
                        lp = got[0]
                        imported[dp] = lp
                        newly_allocated.append(lp)
                    local.append(lp)
                if local:
                    planned.append((
                        [int(t) for t in
                         tokens[:len(local) * self.page_size]], local))
            if imported:
                self._write_imported_pages(imported, contents)
                created = 0
                for tokens, local in planned:
                    created += self.radix.insert(tokens, local)
                self.metrics.warm_pages_total += created
                result["pages"] = created
                result["chains"] = [tokens for tokens, _ in planned]
        finally:
            # registered pages fall to the tree's single reference; pages
            # the tree already held (and all, after an interrupted import)
            # free at once
            for lp in newly_allocated:
                self.allocator.release(lp)
            self._update_page_gauges()
        return result

    def _write_imported_pages(
        self, imported: Dict[int, int],
        contents: Dict[int, Tuple[bytes, bytes]],
    ) -> None:
        """Copy every imported page's bytes into the pool in place: one
        ``index_copy_`` per buffer along the page axis."""
        shape = self._page_shape()
        dtype = self.cache.k.dtype
        idx = torch.tensor(list(imported.values()), dtype=torch.long,
                           device=self.device)
        with torch.inference_mode():
            for which, buf in enumerate(self.cache):
                src = torch.stack(
                    [torch.frombuffer(bytearray(contents[dp][which]),
                                      dtype=torch.uint8)
                     .view(dtype).view(shape) for dp in imported], dim=1)
                buf.index_copy_(1, idx, src.to(self.device))

    def _admit(self) -> None:

        """Move queued requests into free slots and prefill them — ONE
        batched prefill call however many were admitted."""
        if self._paged:
            self._admit_paged()
        else:
            self._admit_dense()

    def _bind_slot(self, i: int, req: Request) -> None:
        slot = self._slots[i]
        slot.request = req
        slot.tokens = list(req.prompt)
        slot.position = len(req.prompt)
        slot.generated = 0
        slot.first_token_t = None
        slot.last_token_t = None
        slot.prefill_s = None
        slot.prefix_hit = False
        req.admit_time = time.monotonic()
        self.metrics.hist["queue_wait"].observe(
            req.admit_time - req.submit_time)
        self._req_event("e", req, "req.queued")
        self._req_event("n", req, "req.admitted", slot=i)
        self._seeds[i] = req.seed
        self.metrics.requests_admitted += 1

    def _admit_dense(self) -> None:
        free = [i for i, s in enumerate(self._slots) if not s.active]
        if not free or not self._queue:
            return
        admitted: List[int] = []
        tokens = np.zeros((self.max_slots, self.prefill_len), np.int32)
        lengths = np.ones(self.max_slots, np.int32)
        write_mask = np.zeros(self.max_slots, bool)
        for i in free:
            if not self._queue:
                break
            req = self._queue.popleft()
            self._bind_slot(i, req)
            tokens[i, : len(req.prompt)] = req.prompt
            lengths[i] = len(req.prompt)
            write_mask[i] = True
            admitted.append(i)
        t0 = time.monotonic()
        for i in admitted:
            self._req_event("b", self._slots[i].request, "req.prefill")
        with self._span("prefill", admitted=len(admitted)):
            out = self._prefill(tokens=tokens, lengths=lengths,
                                write_mask=write_mask, seeds=self._seeds)
        self._after_prefill(admitted, out, t0)

    def _after_prefill(self, admitted: List[int],
                       out: Tuple[torch.Tensor, ...], t0: float) -> None:
        """Bring the first tokens and the finite mask to the host (one
        copy), attribute the prefill's wall time, quarantine poisoned
        slots, register frozen prompt pages (paged) and emit."""
        host = _to_host(out)
        self.metrics.prefill_calls += 1
        now = time.monotonic()
        for i in admitted:
            slot = self._slots[i]
            slot.prefill_s = now - t0
            self.metrics.hist["prefill"].observe(now - t0)
            # close the prefill event before a quarantine can retire it
            self._req_event("e", slot.request, "req.prefill")
            self._req_event("b", slot.request, "req.decode")
        poisoned = [i for i in admitted if not host[1, i]]
        if poisoned:
            # poison prompts skip radix registration: their pages hold
            # non-finite K/V and must never be shared
            self._quarantine(poisoned, now, where="prefill")
        for i in admitted:
            if not host[1, i]:
                continue
            if self.radix is not None:
                slot = self._slots[i]
                plen = len(slot.request.prompt)
                frozen = (plen // self.page_size) * self.page_size
                if frozen:
                    n = frozen // self.page_size
                    self.radix.insert(
                        slot.request.prompt[:frozen],
                        [int(p) for p in self._tables[i, :n]])
                    # the fully written prompt pages are immutable from
                    # here on: exempt from quarantine, shareable
                    self._slot_frozen[i] = n
            self._emit(i, int(host[0, i]), now)
        if self._paged:
            self._update_page_gauges()
        self.metrics.queue_depth = len(self._queue)

    def _reserve_pages(self, req: Request):
        """Reserve the pages one request needs: radix-match its prompt,
        retain the shared prefix pages, allocate the rest (evicting
        unpinned radix leaves when the free list runs short). Returns
        (shared_tokens, page_list), or None when the pool cannot cover
        the request now — it waits at the head of the queue (FIFO)."""
        plen = len(req.prompt)
        ps = self.page_size
        total_pages = self._request_pages(plen, req.max_new_tokens)
        shared = 0
        shared_pages: List[int] = []
        if self.radix is not None:
            matched, pages = self.radix.match(req.prompt)
            # never share the whole prompt: the first token samples from
            # the logits at prompt_len - 1, so at least one tail token
            # must run through prefill
            shared = min(matched, ((plen - 1) // ps) * ps)
            shared_pages = pages[: shared // ps]
            for p in shared_pages:
                self.allocator.retain(p)
        own_needed = total_pages - len(shared_pages)
        own = self.allocator.alloc(own_needed)
        if own is None and self.radix is not None:
            self.radix.evict(own_needed - self.allocator.free_count)
            own = self.allocator.alloc(own_needed)
        if own is None:
            for p in shared_pages:
                self.allocator.release(p)
            return None
        return shared, shared_pages + own

    def _admit_paged(self) -> None:
        free = [i for i, s in enumerate(self._slots) if not s.active]
        if not free or not self._queue:
            return
        admitted: List[int] = []
        tokens = np.zeros((self.max_slots, self.prefill_len), np.int32)
        tail_lens = np.ones(self.max_slots, np.int32)
        starts = np.zeros(self.max_slots, np.int32)
        write_mask = np.zeros(self.max_slots, bool)
        for i in free:
            if not self._queue:
                break
            reserved = self._reserve_pages(self._queue[0])
            if reserved is None:
                break  # page budget exhausted: the head of the line waits
            req = self._queue.popleft()
            shared, pages = reserved
            self._bind_slot(i, req)
            self._slot_pages[i] = pages
            self._slot_frozen[i] = shared // self.page_size
            self._tables[i, :] = TRASH_PAGE
            self._tables[i, : len(pages)] = pages
            self._tables_dirty = True
            tail = req.prompt[shared:]
            tokens[i, : len(tail)] = tail
            tail_lens[i] = len(tail)
            starts[i] = shared
            write_mask[i] = True
            if shared:
                self.metrics.prefix_hits += 1
                self.metrics.prefill_tokens_saved += shared
                self._slots[i].prefix_hit = True
            admitted.append(i)
        if not admitted:
            return
        t0 = time.monotonic()
        for i in admitted:
            self._req_event("b", self._slots[i].request, "req.prefill",
                            prefix_hit=self._slots[i].prefix_hit)
        with self._span("prefill", admitted=len(admitted)):
            self._upload_tables()
            out = self._prefill(tokens=tokens, tail_lens=tail_lens,
                                starts=starts, write_mask=write_mask,
                                seeds=self._seeds)
        self._after_prefill(admitted, out, t0)

    def _emit(self, i: int, token: int, now: float) -> None:
        """Record one generated token for slot i; retire the slot when a
        stop condition hits."""
        slot = self._slots[i]
        req = slot.request
        slot.tokens.append(token)
        slot.generated += 1
        self.metrics.tokens_generated += 1
        self.metrics._window_tokens += 1
        if slot.first_token_t is None:
            slot.first_token_t = now
            self.metrics.record_ttft(now - req.submit_time)
        else:
            self.metrics.hist["tpot"].observe(now - slot.last_token_t)
        slot.last_token_t = now
        if self.on_tokens is not None:
            try:
                self.on_tokens(i, req.request_id, [token])
            except Exception:
                logger.exception("on_tokens hook raised; disarming the hook")
                self.on_tokens = None

        reason = None
        if req.eos_id is not None and token == req.eos_id:
            reason = "eos"
        elif slot.generated >= req.max_new_tokens:
            reason = "length"
        elif slot.position + slot.generated >= self.max_seq:
            # continuing would feed a token at position >= max_seq
            reason = "max_seq"
        if reason is not None:
            self._retire_slot(i, "ok", reason=reason, now=now)

    def step(self) -> List[RequestResult]:
        """One engine tick: deadline sweep, admission (prefill), then one
        decode step for the active slots. Returns every result that
        reached its terminal outcome since the previous ``step()``. The
        watchdog is beaten and the injector's storms fire first; its
        poison and stall fire before the decode."""
        tick = self.metrics.decode_steps + 1  # the decode step this tick runs
        if self.watchdog is not None:
            self.watchdog.beat(step=self.metrics.decode_steps,
                               phase="serve-step")
        inj = self.injector
        if inj is not None:
            storm = inj.take_submit_storm(tick) if not self._draining else 0
            for _ in range(storm):
                self.submit([1], max_new_tokens=1)
            if inj.take_deadline_storm(tick):
                past = time.monotonic() - 1.0
                for req in self._queue:
                    req.deadline = past
                for s in self._slots:
                    if s.active:
                        s.request.deadline = past
        with self._span("tick", tick=tick):
            with self._span("admission"):
                self._expire(time.monotonic())
                self._admit()
            active_idx = [i for i, s in enumerate(self._slots) if s.active]
            if active_idx:
                if inj is not None:
                    poison = inj.take_nan_logits(tick)
                    if poison is not None:
                        self._poison_slot(poison)
                    stall = inj.take_slow_decode(tick)
                    if stall > 0:
                        time.sleep(stall)
                tokens = np.zeros(self.max_slots, np.int32)
                positions = np.zeros(self.max_slots, np.int32)
                active = np.zeros(self.max_slots, bool)
                for i in active_idx:
                    slot = self._slots[i]
                    # feed the last emitted token at its absolute position
                    tokens[i] = slot.tokens[-1]
                    positions[i] = slot.position + slot.generated - 1
                    active[i] = True
                # the span covers the replay and its one copy back
                with self._span("decode", active=len(active_idx)):
                    if self._paged:
                        self._upload_tables()
                    out = self._decode(tokens=tokens, positions=positions,
                                       active=active, seeds=self._seeds)
                    host = _to_host(out)
                self.metrics.decode_steps += 1
                now = time.monotonic()
                poisoned = [i for i in active_idx if not host[1, i]]
                if poisoned:
                    self._quarantine(poisoned, now, where="decode")
                for i in active_idx:
                    if host[1, i]:
                        self._emit(i, int(host[0, i]), now)
        self.metrics.active_slots = sum(s.active for s in self._slots)
        self.metrics.queue_depth = len(self._queue)
        if ((self.monitor is not None or self.exporter is not None)
                and self.metrics.decode_steps % self.monitor_every == 0):
            if self.monitor is not None:
                self.monitor.sample(counters=self.metrics.snapshot())
            if self.exporter is not None:
                self._export_snapshot()
        finished, self._finished_tick = self._finished_tick, []
        return finished

    def tick(self) -> List[RequestResult]:
        """Alias of ``step()``: one admission sweep + one decode step."""
        return self.step()

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(s.active for s in self._slots)

    def cancel(self, request_id: int, *,
               detail: str = "cancelled by client") -> bool:
        """Abort one in-flight request, queued or mid-decode, with an
        ``aborted`` result (partial tokens attached, pages released).
        False when the id is unknown or already terminal."""
        now = time.monotonic()
        for idx, req in enumerate(self._queue):
            if req.request_id == request_id:
                del self._queue[idx]
                self._finalize(req, "aborted", tokens=[], detail=detail,
                               now=now)
                self.metrics.queue_depth = len(self._queue)
                return True
        for i, slot in enumerate(self._slots):
            if slot.active and slot.request.request_id == request_id:
                self._retire_slot(i, "aborted", detail=detail, now=now)
                self.metrics.active_slots = sum(
                    s.active for s in self._slots)
                return True
        return False

    def stop_admissions(self) -> None:
        """Enter the draining state without running the tick loop:
        ``submit()`` now raises / rejects, in-flight work keeps flowing
        through ``step()``. Idempotent."""
        self._draining = True

    def _abort_pending(self, detail: str) -> None:
        now = time.monotonic()
        while self._queue:
            self._finalize(self._queue.popleft(), "aborted", tokens=[],
                           detail=detail, now=now)
        for i, slot in enumerate(self._slots):
            if slot.active:
                self._retire_slot(i, "aborted", detail=detail, now=now)
        self.metrics.queue_depth = 0
        self.metrics.active_slots = 0

    def run(self, max_steps: int = 100_000) -> Dict[int, RequestResult]:
        """Drive ``step()`` until queue and slots drain; returns all
        results by request id. On ``max_steps`` exhaustion the unfinished
        requests end as ``aborted`` with their partial tokens. A pending
        preemption request switches to ``drain()``: admissions stop, the
        admitted requests finish, and the engine returns cleanly."""
        steps = 0
        while self.pending and steps < max_steps:
            if self._preemption_requested():
                logger.warning(
                    "preemption requested (signal %s): draining the engine",
                    self.preemption.signum)
                self.drain(max_steps=max_steps - steps)
                return dict(self._results)
            self.step()
            steps += 1
        if self.pending:
            logger.warning(
                "engine did not drain within %d steps: aborting %d "
                "in-flight requests", max_steps, self.pending)
            self._abort_pending(f"run(max_steps={max_steps}) exhausted")
        if self.exporter is not None:
            # the terminal counters reach the stream between cadence points
            self._export_snapshot()
        return dict(self._results)

    def drain(self, *, max_steps: int = 100_000,
              finish_queued: bool = False) -> Dict[int, RequestResult]:
        """Graceful shutdown: stop admissions, finish the admitted
        requests, flush all results. Queued requests are ``aborted``
        unless ``finish_queued``. Idempotent."""
        self.stop_admissions()
        if not finish_queued:
            now = time.monotonic()
            while self._queue:
                self._finalize(self._queue.popleft(), "aborted", tokens=[],
                               detail="drain: not yet admitted", now=now)
            self.metrics.queue_depth = 0
        steps = 0
        while self.pending and steps < max_steps:
            self.step()
            steps += 1
        if self.pending:
            self._abort_pending(f"drain(max_steps={max_steps}) exhausted")
        if self.exporter is not None:
            self._export_snapshot()
        return dict(self._results)

    def result(self, request_id: int) -> Optional[RequestResult]:
        return self._results.get(request_id)

    def pop_result(self, request_id: int) -> Optional[RequestResult]:
        """Remove and return a terminal result (None when absent)."""
        return self._results.pop(request_id, None)
