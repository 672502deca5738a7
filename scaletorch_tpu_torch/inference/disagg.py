"""Disaggregated prefill/decode serving: two phase slices with
page-ownership handoff.

Counterpart of scaletorch_tpu/inference/disagg.py. Prefill is
compute-bound, decode is bandwidth-bound; ``DisaggregatedEngine`` runs
each phase on a slice of its own — a PREFILL slice and a DECODE slice,
one device each — with a page pool per slice, and one captured step per
phase: the paged prefill step only ever sees prefill-slice buffers, the
paged decode step (the hand-written paged-decode kernel on the card)
only decode-slice buffers, so the one-capture contract holds on BOTH
steps (``prefill_compile_count == 1`` and ``decode_compile_count == 1``
across admissions, handoffs and quarantines).

The page is the handoff unit and ownership crosses slices through TWO
``PageAllocator``s, all-or-nothing per request:

  submit -> queue -> [prefill slice] prefill pool pages, full-prompt
  prefill, FIRST token emitted -> handoff queue -> [wire] only the
  filled prompt pages move (``PageHandoffChannel``: an ``index_select``
  on the prefill pool, a copy to the decode slice's device) -> [decode
  slice] decode pool pages reserved (radix prefix shared pages
  retained, not re-transferred), contents copied in place, prompt
  prefix registered FROZEN in the decode-side radix tree, decode slot
  bound -> prefill pages released.

A request that dies mid-handoff (deadline, cancel, transport fault)
ends in exactly ONE of the six terminal outcomes and leaks zero pages
on either pool: the decode-side reservation rolls back whole and the
prefill-side pages release through the same funnel — both allocators'
``check_conservation`` stay green.

Greedy outputs are BIT-IDENTICAL to the colocated paged engine: per
request the forward is row-independent, the prefill computes the same
K/V from the same (tokens, positions, weights), the page copy is
bitwise, and sampling draws from (seed, position), never the row. The
colocated engine is therefore the standing parity oracle.

On one card both slices may name the same device (``"1:1"`` over
``[cuda:0, cuda:0]``): two pools on one card, the weights shared, not
copied. A slice is one device: tensor parallelism inside a slice is not
ported. Slice sizing (``plan_slice_split``) reads the two slice
programs' peak memory from ``DEFAULT_HBM_BUDGET``'s ``slices`` rows,
measured on the card at a served width (``slice_budget_entries``);
without them ``auto`` takes the even split the reference falls back to.
"""

from __future__ import annotations

import copy
import json
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from scaletorch_tpu_torch.inference.decode import (
    StaticStep,
    make_paged_prefill_step,
)
from scaletorch_tpu_torch.inference.engine import (
    EngineMetrics,
    InferenceEngine,
    Request,
    _to_host,
)
from scaletorch_tpu_torch.inference.kv_cache import (
    TRASH_PAGE,
    PageAllocator,
    PagedKVCache,
    ceil_div,
    init_paged_kv_cache,
)
from scaletorch_tpu_torch.telemetry.histogram import LogHistogram
from scaletorch_tpu_torch.utils.device import resolve_device
from scaletorch_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

# ---- spec parsing / slice planning (pure host) -------------------------

# The port's per-phase memory rows (CUDA peaks measured on the card by
# the analyzer's memory tier, ``--tier memory --write-hbm-budget``), not
# the reference's TPU/CPU file; plan_slice_split reads its ``slices``.
DEFAULT_HBM_BUDGET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "hbm_budget.json")


def parse_disagg_spec(spec: Any) -> Optional[Tuple[int, int]]:
    """``"P:D"`` -> ``(P, D)`` device counts; ``""``/``"auto"`` -> None
    (budget-driven sizing via ``plan_slice_split``). The single grammar
    home for the serve entry's ``--disagg`` and
    ``config.ServingArguments.serve_disagg``."""
    s = str(spec).strip().lower()
    if s in ("", "auto", "none"):
        return None
    parts = s.split(":")
    err = (f"disagg spec must be 'prefill:decode' device counts "
           f"(e.g. '4:4') or 'auto', got {spec!r}")
    if len(parts) != 2:
        raise ValueError(err)
    try:
        n_p, n_d = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(err) from None
    if n_p < 1 or n_d < 1:
        raise ValueError(
            f"each slice needs >= 1 device, got {spec!r}")
    return n_p, n_d


def _budget_peak(entries: Dict[str, Any], *names: str) -> Optional[float]:
    for name in names:
        try:
            return float(entries[name]["peak_mb"])
        except (KeyError, ValueError, TypeError):
            continue
    return None


def plan_slice_split(
    num_devices: int,
    *,
    budget_path: Optional[str] = None,
) -> Tuple[int, int]:
    """Size the two slices from per-phase memory rows: devices split
    proportional to ``peak_mb`` of the prefill-slice vs decode-slice
    programs (the ``disagg_*`` rows; ``prefill_step`` /
    ``paged_decode_step`` are the fallback), each slice getting at least
    one device. The rows are the budget's ``slices`` section, the two
    programs measured at a served width (``slice_budget_entries``); its
    ``entries`` section holds the audit entries' rows at the reference's
    toy width, which gate the memory tier and size nothing. A missing or
    unreadable section falls back to an even split — sizing degrades,
    correctness doesn't."""
    if num_devices < 2:
        raise ValueError(
            f"disaggregation needs >= 2 devices (one per slice), "
            f"got {num_devices}")
    path = budget_path or DEFAULT_HBM_BUDGET
    try:
        with open(path) as f:
            entries = json.load(f)["slices"]
    except (OSError, ValueError, KeyError, TypeError):
        entries = {}
    w_p = _budget_peak(entries, "disagg_prefill_slice",
                       "prefill_step") or 1.0
    w_d = _budget_peak(entries, "disagg_decode_slice",
                       "paged_decode_step") or 1.0
    n_p = int(round(num_devices * w_p / (w_p + w_d)))
    n_p = max(1, min(num_devices - 1, n_p))
    return n_p, num_devices - n_p


def _canonical(device: Any) -> torch.device:
    """A resolved device with its index filled in (``cuda`` -> the
    current card), so two spellings of one card compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class HandoffError(RuntimeError):
    """A page transfer failed in flight (injected in drills). The engine
    converts it into exactly one ``aborted`` terminal result with both
    pools conserved."""


class PageHandoffChannel:
    """Moves filled K/V pages from the prefill slice to the decode slice.

    ``transfer`` gathers the source pages on the prefill slice with an
    ``index_select`` along the page axis (a device-side gather — the
    host never sees the bytes) and moves them to ``dst_device`` (a no-op
    when both slices share the card; a device-to-device copy between
    two cards). Everything is enqueued on the current stream, the one
    the engine's steps run on. Byte/page accounting and the
    fault-injection hook live here so drills and gauges share one
    counter set."""

    def __init__(self, dst_device: Optional[Any] = None) -> None:
        self.dst_device = dst_device
        self.transfers = 0
        self.pages_transferred = 0
        self.bytes_transferred = 0
        self.failures = 0
        self._fail_next = 0

    def fail_next(self, n: int = 1) -> None:
        """Drill hook: the next ``n`` transfers raise ``HandoffError``
        (the mid-handoff crash the conservation tests interleave)."""
        self._fail_next += n

    def transfer(self, src_cache: PagedKVCache, src_pages: List[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Returns ``(k_pages, v_pages, nbytes)`` on ``dst_device`` —
        shape [L, n, H_kv, page, D]."""
        if self._fail_next > 0:
            self._fail_next -= 1
            self.failures += 1
            raise HandoffError("injected handoff transport fault")
        idx = torch.tensor(src_pages, dtype=torch.long,
                           device=src_cache.k.device)
        with torch.inference_mode():
            k = src_cache.k.index_select(1, idx)
            v = src_cache.v.index_select(1, idx)
            if self.dst_device is not None:
                k = k.to(self.dst_device, non_blocking=True)
                v = v.to(self.dst_device, non_blocking=True)
        nbytes = int(k.nbytes + v.nbytes)
        self.transfers += 1
        self.pages_transferred += len(src_pages)
        self.bytes_transferred += nbytes
        return k, v, nbytes


@dataclass
class DisaggMetrics(EngineMetrics):
    """EngineMetrics plus the per-slice health the phase split creates:
    slice sizes, the prefill pool's occupancy (the decode pool rides the
    base gauges), handoff counters/bytes and per-slice busy fractions
    (host wall attributed to each slice's step over the metrics window,
    the card's work included: each step's time ends at its sync).
    ``snapshot()`` stays flat numeric, so every key reaches /metrics as
    an ``engine_*`` gauge and JSONL consumers unchanged."""

    prefill_slice_devices: int = 0
    decode_slice_devices: int = 0
    prefill_pages_in_use: int = 0
    prefill_pool_free: int = 0
    handoffs: int = 0
    handoff_failures: int = 0
    pages_handed_off: int = 0
    handoff_bytes: int = 0
    prefill_busy_s: float = 0.0
    decode_busy_s: float = 0.0

    def __post_init__(self) -> None:
        # handoff latency (prefill-done -> decode-slot bound): queueing
        # for a free slot/pages plus the wire
        self.hist["handoff"] = LogHistogram()

    def busy_fractions(self) -> Tuple[float, float]:
        dt = time.monotonic() - self._window_start
        if dt <= 0:
            return 0.0, 0.0
        return (min(1.0, self.prefill_busy_s / dt),
                min(1.0, self.decode_busy_s / dt))

    def reset_window(self) -> None:
        super().reset_window()
        self.prefill_busy_s = 0.0
        self.decode_busy_s = 0.0

    def snapshot(self) -> Dict[str, float]:
        snap = super().snapshot()
        busy_p, busy_d = self.busy_fractions()
        snap.update({
            "prefill_slice_devices": self.prefill_slice_devices,
            "decode_slice_devices": self.decode_slice_devices,
            "prefill_pages_in_use": self.prefill_pages_in_use,
            "prefill_pool_free": self.prefill_pool_free,
            "handoffs": self.handoffs,
            "handoff_failures": self.handoff_failures,
            "pages_handed_off": self.pages_handed_off,
            "handoff_bytes": self.handoff_bytes,
            "prefill_slice_busy_fraction": busy_p,
            "decode_slice_busy_fraction": busy_d,
        })
        return snap


class _PendingHandoff:
    """A request between phases: prefilled (first token already emitted
    to the stream), holding prefill-pool pages, waiting for a decode
    slot + decode-pool pages."""

    __slots__ = ("req", "pages", "first_token", "prefill_s",
                 "first_token_t", "ready_t")

    def __init__(self, req: Request, pages: List[int], first_token: int,
                 prefill_s: float, first_token_t: float,
                 ready_t: float) -> None:
        self.req = req
        self.pages = pages
        self.first_token = first_token
        self.prefill_s = prefill_s
        self.first_token_t = first_token_t
        self.ready_t = ready_t


class _TimedStep:
    """A captured step whose calls add their wall time, the card's work
    included, to a busy counter: the sync after the replay (which the
    engine's one token copy back would make anyway) goes inside the
    window. Every other attribute is the step's (``captures``,
    ``replays``, ``compile_count``, ``captured_launches``)."""

    def __init__(self, step: StaticStep,
                 on_busy: Callable[[float], None]) -> None:
        self.step = step
        self._on_busy = on_busy

    def __call__(self, **arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
        t0 = time.monotonic()
        out = self.step(**arrays)
        if self.step.device.type == "cuda":
            torch.cuda.current_stream(self.step.device).synchronize()
        self._on_busy(time.monotonic() - t0)
        return out

    def __getattr__(self, name: str) -> Any:
        return getattr(self.step, name)


class DisaggregatedEngine(InferenceEngine):
    """The colocated paged engine with its prefill phase lifted onto a
    separate slice.

    The base class remains the DECODE side unchanged: pool, allocator,
    radix tree, page tables, slots, the captured decode step and the
    tick loop — ``step()`` is inherited, only the admission hooks
    (``_admit`` / ``_expire`` / ``cancel`` / ``_abort_pending``) are
    reinterpreted as the phase scheduler:

      1. handoff sweep — bind prefilled requests into free decode slots
         by decode-pool budget (FIFO; all-or-nothing reservation);
      2. prefill admission — admit queued requests into the prefill
         slice by PREFILL-pool budget, one batched prefill call, first
         tokens emitted (or poison prompts quarantined) right here;
      3. second handoff sweep — a request prefilled this tick can reach
         a decode slot the same tick, matching the colocated engine's
         admit-then-decode cadence.

    Parameters beyond ``InferenceEngine``: ``devices`` (default every
    visible card; a device may be listed twice, so ``"1:1"`` over
    ``[cuda:0, cuda:0]`` puts both slices on one card), ``disagg_split``
    (``(P, D)`` tuple, ``"P:D"`` string, or None = ``plan_slice_split``
    over ``budget_path``), ``prefill_pool_pages`` (prefill-side scratch
    pool; default sizes ``max_slots`` full prompts + trash page) and
    ``channel`` (a ``PageHandoffChannel``, injectable for drills). The
    decode slice's device is the engine's ``device``; do not pass
    ``device`` separately.
    """

    def __init__(self, params, cfg, *,
                 devices: Optional[Sequence[Any]] = None,
                 disagg_split: Any = None,
                 budget_path: Optional[str] = None,
                 prefill_pool_pages: Optional[int] = None,
                 channel: Optional[PageHandoffChannel] = None,
                 **kw) -> None:
        layout = kw.setdefault("cache_layout", "paged")
        if layout != "paged":
            raise ValueError(
                "DisaggregatedEngine requires cache_layout='paged' — "
                "the page is the handoff unit")
        if kw.get("mesh") is not None:
            raise ValueError(
                "DisaggregatedEngine owns its slices; pass "
                "devices/disagg_split instead of mesh")
        if "device" in kw:
            raise ValueError(
                "DisaggregatedEngine places its slices from devices=; "
                "do not pass device=")
        if devices is None:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devs = [_canonical(d) for d in devices]
        if isinstance(disagg_split, str):
            disagg_split = parse_disagg_spec(disagg_split)
        if disagg_split is None:
            disagg_split = plan_slice_split(
                len(devs), budget_path=budget_path)
        n_p, n_d = disagg_split
        if n_p < 1 or n_d < 1:
            raise ValueError(
                f"each slice needs >= 1 device, got {n_p}:{n_d}")
        if n_p + n_d > len(devs):
            raise ValueError(
                f"slice spec {n_p}:{n_d} needs {n_p + n_d} devices but "
                f"only {len(devs)} are listed")
        if n_p > 1 or n_d > 1:
            raise NotImplementedError(
                f"slice spec {n_p}:{n_d}: a slice is one device in the "
                "port (tensor parallelism inside a slice is not ported)")
        self.prefill_device = devs[0]
        self._prefill_pool_pages = prefill_pool_pages
        kw["device"] = devs[n_p]

        # the base constructor builds the decode side and, through
        # _make_prefill_step, the prefill slice's pool and step
        super().__init__(params, cfg, **kw)

        self._handoff: deque[_PendingHandoff] = deque()
        self.channel = channel if channel is not None \
            else PageHandoffChannel(self.device)
        if self.channel.dst_device is None:
            self.channel.dst_device = self.device

        # decode busy attribution: the captured step stays reachable
        # (captures, replays, launches) through the wrapper
        self._decode = _TimedStep(self._decode, self._add_decode_busy)

        metrics = DisaggMetrics(num_slots=self.max_slots)
        metrics.prefill_slice_devices = n_p
        metrics.decode_slice_devices = n_d
        self.metrics = metrics
        self._update_page_gauges()
        self._exported_key = self._export_key()
        logger.info(
            "disaggregated engine: prefill slice on %s (%d-page pool), "
            "decode slice on %s (%d-page pool)",
            self.prefill_device, self.prefill_num_pages, self.device,
            self.num_pages)

    def _add_decode_busy(self, seconds: float) -> None:
        self.metrics.decode_busy_s += seconds

    # ---- the prefill slice's pool and step ---------------------------
    def _make_prefill_step(self, prefill: Callable,
                           inputs: Dict[str, np.ndarray]) -> StaticStep:
        """The prefill slice: its scratch pool (PROMPT pages only — a
        request's generation pages exist solely on the decode side), the
        model there (the decode slice's own when both share a device),
        and the paged prefill step over them, its page tables an input
        of the step. ``prefill`` (the colocated step over the decode
        pool) is not used."""
        dev = self.prefill_device
        prompt_pages_max = ceil_div(self.prefill_len, self.page_size)
        pool_pages = self._prefill_pool_pages
        if pool_pages is None:
            pool_pages = self.max_slots * prompt_pages_max + 1
        if pool_pages < prompt_pages_max + 1:
            raise ValueError(
                f"prefill_pool_pages {pool_pages} cannot hold "
                f"one max-length prompt ({prompt_pages_max} pages + "
                f"trash page)")
        self.prefill_num_pages = pool_pages
        self.prefill_cache = init_paged_kv_cache(
            self.cfg, pool_pages, self.page_size,
            dtype=self.cache.k.dtype, device=dev)
        self.prefill_allocator = PageAllocator(pool_pages)
        if dev == _canonical(self.device):
            self.prefill_model = self.model  # shared, not copied
        else:
            self.prefill_model = copy.deepcopy(self.model).to(dev)
        step = make_paged_prefill_step(
            self.cfg, self.sampling, page_size=self.page_size,
            seq_limit=self.max_seq, forward_fn=self._forward_fn)

        def run(**kw):
            return step(self.prefill_model, pool=self.prefill_cache, **kw)

        inputs = dict(inputs, page_tables=np.full(
            (self.max_slots, self._pages_per_slot), TRASH_PAGE, np.int32))
        return StaticStep(run, inputs, dev)

    # ---- conservation (both pools) -----------------------------------
    def check_conservation(self) -> None:
        """Green iff NEITHER pool leaked: free + allocated == capacity
        and positive refcounts on both allocators."""
        self.allocator.check_conservation()
        self.prefill_allocator.check_conservation()

    @property
    def pending(self) -> int:
        return (len(self._queue) + len(self._handoff)
                + sum(s.active for s in self._slots))

    def _update_page_gauges(self) -> None:
        super()._update_page_gauges()
        alloc = getattr(self, "prefill_allocator", None)
        if alloc is not None and isinstance(self.metrics, DisaggMetrics):
            self.metrics.prefill_pages_in_use = alloc.used_count
            self.metrics.prefill_pool_free = alloc.free_count

    # ---- phase scheduler ---------------------------------------------
    def _admit(self) -> None:
        with self._span("handoff", pending=len(self._handoff)):
            self._handoff_sweep(time.monotonic())
        self._prefill_admit()
        if self._handoff:
            # same-tick pipeline: a request prefilled above reaches a
            # decode slot before this tick's decode step, exactly the
            # colocated admit-then-decode cadence
            with self._span("handoff", pending=len(self._handoff)):
                self._handoff_sweep(time.monotonic())

    def _expire(self, now: float) -> None:
        super()._expire(now)
        if self._handoff:
            kept: deque[_PendingHandoff] = deque()
            for h in self._handoff:
                if (h.req.deadline is not None
                        and now >= h.req.deadline):
                    self._drop_handoff(
                        h, "timeout",
                        detail="deadline exceeded awaiting handoff",
                        now=now)
                else:
                    kept.append(h)
            self._handoff = kept

    def cancel(self, request_id: int, *,
               detail: str = "cancelled by client") -> bool:
        now = time.monotonic()
        for h in self._handoff:
            if h.req.request_id == request_id:
                self._handoff.remove(h)
                self._drop_handoff(h, "aborted", detail=detail, now=now)
                return True
        return super().cancel(request_id, detail=detail)

    def _abort_pending(self, detail: str) -> None:
        now = time.monotonic()
        while self._handoff:
            self._drop_handoff(
                self._handoff.popleft(), "aborted", detail=detail,
                now=now)
        super()._abort_pending(detail)

    def _drop_handoff(self, h: _PendingHandoff, outcome: str, *,
                      detail: str, now: float) -> None:
        """Mid-handoff death: release the prefill-side pages and record
        the request's single terminal result (its already-streamed first
        token attached). The decode side holds nothing yet — exactly one
        outcome, zero leaks on either pool."""
        for p in h.pages:
            self.prefill_allocator.release(p)
        self._req_event("e", h.req, "req.handoff", outcome=outcome)
        self._finalize(
            h.req, outcome, tokens=[h.first_token], detail=detail,
            ttft_t=h.first_token_t, prefill_s=h.prefill_s, now=now)
        self._update_page_gauges()

    # ---- phase 1: prefill slice --------------------------------------
    def _prefill_admit(self) -> None:
        """Admit queued requests into the prefill slice by PREFILL-pool
        budget — one batched prefill call for everything admitted this
        tick, first tokens emitted (streamed) straight from the slice,
        poison prompts quarantined with their pool lines cleared."""
        if not self._queue:
            return
        b = self.max_slots
        admitted: List[Tuple[int, Request, List[int]]] = []
        tokens = np.zeros((b, self.prefill_len), np.int32)
        tail_lens = np.ones(b, np.int32)
        starts = np.zeros(b, np.int32)
        write_mask = np.zeros(b, bool)
        tables = np.full((b, self._pages_per_slot), TRASH_PAGE, np.int32)
        seeds = np.zeros(b, np.int64)
        row = 0
        while row < b and self._queue:
            req = self._queue[0]
            n_pages = ceil_div(len(req.prompt), self.page_size)
            pages = self.prefill_allocator.alloc(n_pages)
            if pages is None:
                break  # prefill-pool budget: head of the line waits
            self._queue.popleft()
            req.admit_time = time.monotonic()
            self.metrics.hist["queue_wait"].observe(
                req.admit_time - req.submit_time)
            self._req_event("e", req, "req.queued")
            self._req_event("n", req, "req.admitted", slot=row,
                            slice="prefill")
            self.metrics.requests_admitted += 1
            tokens[row, :len(req.prompt)] = req.prompt
            tail_lens[row] = len(req.prompt)
            write_mask[row] = True
            tables[row, :n_pages] = pages
            seeds[row] = req.seed
            admitted.append((row, req, pages))
            row += 1
        if not admitted:
            return
        t0 = time.monotonic()
        for _, req, _ in admitted:
            self._req_event("b", req, "req.prefill", slice="prefill")
        with self._span("prefill", admitted=len(admitted),
                        slice="prefill"):
            host = _to_host(self._prefill(
                tokens=tokens, tail_lens=tail_lens, starts=starts,
                write_mask=write_mask, page_tables=tables, seeds=seeds))
        self.metrics.prefill_calls += 1
        now = time.monotonic()
        prefill_s = now - t0
        self.metrics.prefill_busy_s += prefill_s
        poison_mask = np.zeros(self.prefill_num_pages, bool)
        poisoned: List[Tuple[Request, List[int]]] = []
        for row, req, pages in admitted:
            self.metrics.hist["prefill"].observe(prefill_s)
            self._req_event("e", req, "req.prefill")
            if not host[1, row]:
                poison_mask[pages] = True
                poisoned.append((req, pages))
                continue
            self._finish_prefill(req, pages, int(host[0, row]),
                                 prefill_s, now)
        if poisoned:
            # the NaN K/V must not outlive the request on THIS pool
            # either — the same masked in-place clear quarantine uses on
            # the decode pool
            with torch.inference_mode():
                self._fill_slots(self.prefill_cache, poison_mask, 0.0)
            for req, pages in poisoned:
                for p in pages:
                    self.prefill_allocator.release(p)
                self._finalize(
                    req, "quarantined", tokens=[],
                    detail="non-finite logits at prefill",
                    prefill_s=prefill_s, now=now)
        self._update_page_gauges()
        self.metrics.queue_depth = len(self._queue)

    def _finish_prefill(self, req: Request, pages: List[int],
                        token: int, prefill_s: float,
                        now: float) -> None:
        """Healthy prefill: stream the first token, then either finish
        the request outright (stop condition at token one — no decode
        phase needed) or queue it for handoff."""
        self.metrics.tokens_generated += 1
        self.metrics._window_tokens += 1
        self.metrics.record_ttft(now - req.submit_time)
        if self.on_tokens is not None:
            try:
                self.on_tokens(-1, req.request_id, [token])
            except Exception:
                logger.exception(
                    "on_tokens hook raised; disarming the hook")
                self.on_tokens = None
        reason = None
        if req.eos_id is not None and token == req.eos_id:
            reason = "eos"
        elif req.max_new_tokens <= 1:
            reason = "length"
        elif len(req.prompt) + 1 >= self.max_seq:
            reason = "max_seq"
        if reason is not None:
            for p in pages:
                self.prefill_allocator.release(p)
            self._finalize(req, "ok", tokens=[token], reason=reason,
                           ttft_t=now, prefill_s=prefill_s, now=now)
            return
        self._handoff.append(_PendingHandoff(
            req, pages, token, prefill_s, now, now))
        self._req_event("b", req, "req.handoff")

    # ---- phase 2: the wire -------------------------------------------
    def _handoff_sweep(self, now: float) -> None:
        """Bind prefilled requests into free decode slots, FIFO. The
        head blocks on decode-pool budget (pages free as slots retire);
        a transport fault finalizes the head and the sweep continues."""
        while self._handoff:
            free = [i for i, s in enumerate(self._slots) if not s.active]
            if not free:
                return
            status = self._try_handoff(free[0], self._handoff[0], now)
            if status == "wait":
                return
            self._handoff.popleft()

    def _try_handoff(self, i: int, h: _PendingHandoff,
                     now: float) -> str:
        """All-or-nothing ownership flip for one request: reserve on the
        decode pool (radix prefix shared, rest allocated — identical
        math to colocated admission), move only the NON-SHARED prompt
        pages over the wire, register the prompt prefix frozen in the
        decode radix, bind the slot, release the prefill pages. Any
        failure rolls the decode-side reservation back whole. Returns
        'done' | 'wait' | 'failed'."""
        req = h.req
        plen = len(req.prompt)
        ps = self.page_size
        reserved = self._reserve_pages(req)
        if reserved is None:
            return "wait"
        shared, pages = reserved
        n_shared = shared // ps
        prompt_pages = ceil_div(plen, ps)
        src = h.pages[n_shared:prompt_pages]
        dst = pages[n_shared:prompt_pages]
        try:
            k_pages, v_pages, nbytes = self.channel.transfer(
                self.prefill_cache, src)
        except HandoffError as exc:
            for p in pages:
                self.allocator.release(p)
            for p in h.pages:
                self.prefill_allocator.release(p)
            self.metrics.handoff_failures += 1
            self._req_event("e", req, "req.handoff", error=str(exc))
            self._finalize(
                req, "aborted", tokens=[h.first_token],
                detail=f"page handoff failed: {exc}",
                ttft_t=h.first_token_t, prefill_s=h.prefill_s, now=now)
            self._update_page_gauges()
            return "failed"
        if dst:
            # copy the transferred pages into the decode pool in place
            # (same storage: the captured decode step keeps its buffers)
            dst_idx = torch.tensor(dst, dtype=torch.long,
                                   device=self.device)
            with torch.inference_mode():
                self.cache.k.index_copy_(1, dst_idx, k_pages)
                self.cache.v.index_copy_(1, dst_idx, v_pages)
        # destination registered before the source releases: the pages
        # are never owned by zero allocators
        slot = self._slots[i]
        slot.request = req
        slot.tokens = list(req.prompt) + [h.first_token]
        slot.position = plen
        slot.generated = 1
        slot.first_token_t = h.first_token_t
        slot.last_token_t = h.first_token_t
        slot.prefill_s = h.prefill_s
        slot.prefix_hit = shared > 0
        self._slot_pages[i] = pages
        self._slot_frozen[i] = n_shared
        self._tables[i, :] = TRASH_PAGE
        self._tables[i, :len(pages)] = pages
        self._tables_dirty = True
        self._seeds[i] = req.seed
        if shared:
            self.metrics.prefix_hits += 1
        if self.radix is not None:
            # the page-aligned prompt prefix was written once by a
            # healthy prefill and is immutable from here on: register
            # it frozen (shareable, exempt from quarantine clears,
            # evictable at refcount zero like any chain)
            frozen = (plen // ps) * ps
            if frozen:
                n = frozen // ps
                self.radix.insert(req.prompt[:frozen],
                                  [int(p) for p in pages[:n]])
                self._slot_frozen[i] = n
        for p in h.pages:
            self.prefill_allocator.release(p)
        done = time.monotonic()
        self.metrics.handoffs += 1
        self.metrics.pages_handed_off += len(src)
        self.metrics.handoff_bytes += nbytes
        self.metrics.hist["handoff"].observe(done - h.ready_t)
        self._req_event("e", req, "req.handoff", pages=len(src),
                        shared_tokens=shared)
        self._req_event("b", req, "req.decode", slot=i, slice="decode")
        self._update_page_gauges()
        return "done"

    # ---- export ------------------------------------------------------
    def _export_snapshot(self) -> None:
        made_progress = self._export_key() != self._exported_key
        super()._export_snapshot()
        if made_progress and self.exporter is not None:
            m = self.metrics
            busy_p, busy_d = m.busy_fractions()
            self.exporter.emit("disagg", {
                "prefill_slice_devices": m.prefill_slice_devices,
                "decode_slice_devices": m.decode_slice_devices,
                "handoffs": m.handoffs,
                "handoff_failures": m.handoff_failures,
                "pages_handed_off": m.pages_handed_off,
                "handoff_bytes": m.handoff_bytes,
                "prefill_pages_in_use": m.prefill_pages_in_use,
                "prefill_pool_free": m.prefill_pool_free,
                "prefill_slice_busy_fraction": busy_p,
                "decode_slice_busy_fraction": busy_d,
            })


# ---- the analyzer's audit entries ----------------------------------------------


def audit_entry_prefill_slice() -> Dict[str, Any]:
    """Audit entry: the PREFILL slice's one program, the paged prefill
    step as the disaggregated engine calls it (whole prompts into a
    prompt-pages pool, through the gather path). Contract: the pool
    updated in place, zero collectives (cross-slice traffic rides the
    handoff channel, never a collective), the pinned ``kv_cache``
    geometry equal to the pool's bytes. Its ``peak_mb`` row in
    ``hbm_budget.json`` is what ``plan_slice_split`` sizes the prefill
    slice by."""
    from scaletorch_tpu_torch.inference.decode import (
        AUDIT_BATCH,
        AUDIT_MAX_SEQ,
        AUDIT_PAGE,
        _audit_contract,
        audit_cfg,
        audit_inputs,
        audit_model,
        audit_page_tables,
    )
    from scaletorch_tpu_torch.inference.kv_cache import kv_cache_bytes
    from scaletorch_tpu_torch.inference.sampling import SamplingParams

    cfg = audit_cfg()
    b, s_max, page = AUDIT_BATCH, AUDIT_MAX_SEQ, AUDIT_PAGE
    max_pages = s_max // page
    num_pages = b * max_pages + 1

    def setup(device) -> Dict[str, Any]:
        model = audit_model(cfg, device)
        pool = init_paged_kv_cache(cfg, num_pages, page,
                                   device=torch.device(device))
        tables = audit_page_tables(b, max_pages, num_pages, device)
        x = audit_inputs(device)
        fn = make_paged_prefill_step(cfg, SamplingParams(temperature=0.0),
                                     page_size=page, seq_limit=s_max)
        tail_lens = x["positions"] + 1
        starts = torch.zeros_like(tail_lens)
        return {"call": lambda: fn(model, x["tokens"], tail_lens, starts,
                                   x["mask"], tables, pool, x["seeds"]),
                "inplace": {"pool.k": pool.k, "pool.v": pool.v},
                "arguments": [*model.parameters(), *pool, tables,
                              *x.values()],
                "cache": tuple(pool)}

    kv = {"cfg": cfg, "layout": "paged", "batch": b, "max_seq": s_max,
          "dtype": torch.float32, "page_size": page, "num_pages": num_pages}
    entry = _audit_contract(
        "disagg_prefill_slice", "scaletorch_tpu_torch/inference/disagg.py",
        cfg, kv, kv_cache_bytes(cfg, b, s_max, torch.float32,
                                layout="paged", page_size=page,
                                num_pages=num_pages) / 1e6)
    entry["setup"] = setup
    return entry


def audit_entry_decode_slice() -> Dict[str, Any]:
    """Audit entry: the DECODE slice's one program, the paged decode step
    the colocated engine runs (the slice changes placement, never the
    program), audited under the disaggregated name so its ``peak_mb`` row
    sizes the decode slice in ``plan_slice_split``."""
    from scaletorch_tpu_torch.inference.decode import audit_entry_paged_decode

    entry = audit_entry_paged_decode()
    entry["name"] = "disagg_decode_slice"
    entry["file"] = "scaletorch_tpu_torch/inference/disagg.py"
    return entry


# ---- the slice rows plan_slice_split reads ---------------------------------------
# The audit entries above run the reference's hidden-64 model: their rows
# gate the memory tier (ST1001) and size nothing. plan_slice_split sizes
# the slices from the same two programs measured at a served width: the
# serve cell's model and engine shape (Qwen3-0.6B, fp32, 8 slots of 2048
# keys, prompts of 512 in pages of 16), written to the budget's
# ``slices`` section by the memory tier on the card.
SLICE_BUDGET_MODEL = "qwen3-0.6b"
SLICE_BUDGET_SHAPE = {"max_slots": 8, "max_seq": 2048, "prefill_len": 512,
                      "page_size": 16}


def slice_budget_entries(cfg=None, **shape: int) -> List[Dict[str, Any]]:
    """The prefill slice's and the decode slice's programs at the engine's
    own pool sizes (``max_slots`` whole prompts + TRASH on the prefill
    side, ``max_slots`` full sequences + TRASH on the decode side), as
    entries the memory tier measures (``name``, ``file``, ``setup``,
    ``shape``). ``cfg`` defaults to ``SLICE_BUDGET_MODEL`` in fp32 and
    ``shape`` to ``SLICE_BUDGET_SHAPE``; every prompt is ``prefill_len``
    long and every decode slot at its last key."""
    from scaletorch_tpu_torch.inference.decode import (
        audit_model,
        make_paged_decode_step,
    )
    from scaletorch_tpu_torch.inference.sampling import SamplingParams
    from scaletorch_tpu_torch.models.presets import model_config

    model = SLICE_BUDGET_MODEL if cfg is None else "custom"
    if cfg is None:
        cfg = model_config(SLICE_BUDGET_MODEL, dtype=torch.float32)
    shape = {**SLICE_BUDGET_SHAPE, **shape}
    b, page = shape["max_slots"], shape["page_size"]
    max_seq, prefill_len = shape["max_seq"], shape["prefill_len"]
    per_slot = ceil_div(max_seq, page)
    prompt_pages = ceil_div(prefill_len, page)
    greedy = SamplingParams(temperature=0.0)

    def common(device, pool_pages: int, owned: int) -> Dict[str, Any]:
        dev = torch.device(device)
        gen = torch.Generator(device=dev).manual_seed(0)
        pages = torch.arange(b * owned, dtype=torch.int32, device=dev)
        tables = torch.full((b, per_slot), TRASH_PAGE, dtype=torch.int32,
                            device=dev)
        tables[:, :owned] = (pages + 1).view(b, owned)
        return {"params": audit_model(cfg, dev), "tables": tables,
                "pool": init_paged_kv_cache(cfg, pool_pages, page,
                                            device=dev),
                "mask": torch.ones(b, dtype=torch.bool, device=dev),
                "seeds": torch.randint(0, 2**31, (b,), generator=gen,
                                       device=dev, dtype=torch.int64),
                "tokens": torch.randint(0, cfg.vocab_size,
                                        (b, prefill_len), generator=gen,
                                        device=dev, dtype=torch.int32)}

    def prepared(x: Dict[str, Any], call: Callable) -> Dict[str, Any]:
        pool = x["pool"]
        return {"call": call,
                "inplace": {"pool.k": pool.k, "pool.v": pool.v},
                "arguments": [*x["params"].parameters(), *pool, x["tables"],
                              x["tokens"], x["mask"], x["seeds"]],
                "cache": tuple(pool)}

    def setup_prefill(device) -> Dict[str, Any]:
        x = common(device, b * prompt_pages + 1, prompt_pages)
        fn = make_paged_prefill_step(cfg, greedy, page_size=page,
                                     seq_limit=max_seq)
        lens = torch.full((b,), prefill_len, dtype=torch.int32,
                          device=x["tokens"].device)
        return prepared(x, lambda: fn(
            x["params"], x["tokens"], lens, torch.zeros_like(lens),
            x["mask"], x["tables"], x["pool"], x["seeds"]))

    def setup_decode(device) -> Dict[str, Any]:
        x = common(device, b * per_slot + 1, per_slot)
        fn = make_paged_decode_step(cfg, greedy, page_size=page,
                                    seq_limit=max_seq)
        pos = torch.full((b,), max_seq - 1, dtype=torch.int32,
                         device=x["tokens"].device)
        return prepared(x, lambda: fn(
            x["params"], x["tokens"][:, 0], pos, x["mask"], x["tables"],
            x["pool"], x["seeds"]))

    shape = {"model": model, "hidden_size": cfg.hidden_size,
             "num_hidden_layers": cfg.num_hidden_layers, **shape}
    return [{"name": "disagg_prefill_slice", "setup": setup_prefill,
             "file": "scaletorch_tpu_torch/inference/disagg.py",
             "shape": shape},
            {"name": "disagg_decode_slice", "setup": setup_decode,
             "file": "scaletorch_tpu_torch/inference/disagg.py",
             "shape": shape}]
