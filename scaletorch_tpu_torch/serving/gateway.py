"""The front door: asyncio HTTP/1.1 gateway with SSE token streaming.

Counterpart of scaletorch_tpu/serving/gateway.py over the port's
``InferenceEngine`` (every decode of a paged engine on the card runs the
hand-written paged-decode kernel inside its captured step). The wire,
the queueing, the routing and the bookkeeping are the reference's.

Stdlib-only transport (asyncio + the repo's own modules — no web
framework): a serving gateway whose transport
layer is ~300 lines of readable asyncio is a gateway whose failure modes
fit in one head.

Three endpoints:

  * ``POST /v1/generate`` — token-in/token-out generation. With
    ``stream: true`` (default) the response is an SSE stream: one
    ``token`` event per engine tick with that request's newly sampled
    tokens, then exactly one ``done`` event carrying the engine's terminal
    outcome. With ``stream: false`` a single JSON body whose HTTP
    status IS the outcome (``protocol.STATUS_BY_OUTCOME``).
  * ``GET /metrics`` — Prometheus text exposition via
    ``telemetry.export.render_families``: gateway counters/gauges,
    tenant-labeled queue depths and shed counters, each replica's live
    ``EngineMetrics`` snapshot as ``engine_*{replica="..."}`` series,
    and the per-tenant latency distributions (TTFT, TPOT, queue wait,
    prefill, e2e) as real ``histogram`` families — identities ride
    escaped LABELS, never the metric name. HTTP/1.1 keep-alive, so a
    scrape-heavy Prometheus pays one connection, not one per scrape.
  * ``GET /healthz`` — liveness + capacity: per-replica alive flags,
    the page-pool headroom gauges admission is actually steering by,
    and (when SLO targets are configured) a live ``slo`` verdict.
    Keep-alive like /metrics.

Request-scoped observability: the gateway accepts/mints a W3C
``traceparent`` per generate request, emits gateway-side spans
(``gw.parse`` plus async ``gw.request``/``gw.queued``/``gw.stream``
events keyed by trace id), threads the trace id through the worker
bridge into the engine's lifecycle spans, records per-tenant latency
histograms, and writes one ``access`` JSONL record per terminal
outcome.

The sync/async seam is ``EngineWorker``: the engine is synchronous and
single-threaded by design (one captured decode step, one capture), so
each replica runs on its OWN worker thread driving ``engine.tick()``, and the
event loop talks to it through a closure inbox. Tokens flow the other
way by PUSH: the engine's per-tick ``on_tokens`` hook (never polling
terminal results) hands each newly sampled token to the worker, which
trampolines it onto the event loop with ``call_soon_threadsafe`` — the
SSE write happens within one tick of the sample, and the bridge adds
zero recaptures (``decode_compile_count == 1`` with the gateway attached
is acceptance-tested). The engine captured its CUDA graphs on the
thread that built it; grad mode and the current CUDA device are per
thread in PyTorch, so the worker thread sets both before its first
replay. The token hook receives host ints the engine already copied
back with its one per-step copy: the trampoline adds no device sync.

Requests wait in the GATEWAY's weighted-fair queue (admission.py), not
the engine's FIFO — the dispatcher only feeds a replica while its
engine queue is shallow, so tenant fairness survives all the way to the
decode batch. Multi-replica, the dispatcher routes prefix-aware
(router.py): the radix tree's page-aligned chunk hashes are the routing
key, so requests sharing a system prompt land on the replica whose tree
already holds those pages.

Every HTTP request ends in exactly one terminal outcome and exactly one
terminal HTTP status/SSE ``done`` event — the engine's conservation
invariant, extended to the wire and property-tested under tenant
storms, deadline storms, and mid-stream disconnects (a dropped client
aborts its request and releases its pages within a tick).
"""

from __future__ import annotations

import asyncio
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from scaletorch_tpu_torch.inference.engine import InferenceEngine, RequestResult
from scaletorch_tpu_torch.inference.resilience import (
    TERMINAL_OUTCOMES,
    ServingFaultInjector,
)
from scaletorch_tpu_torch.serving import protocol
from scaletorch_tpu_torch.serving.admission import (
    AdmissionController,
    TenantConfig,
)
from scaletorch_tpu_torch.serving.protocol import (
    GenerateRequest,
    ProtocolError,
)
from scaletorch_tpu_torch.serving.router import (
    NoReplicaAvailable,
    PrefixAwareRouter,
)
from scaletorch_tpu_torch.serving.slo import LATENCY_OUTCOMES, evaluate_slo
from scaletorch_tpu_torch.telemetry.export import render_families
from scaletorch_tpu_torch.telemetry.histogram import LogHistogram, TenantHistograms
from scaletorch_tpu_torch.telemetry.spans import NOOP_SPAN
from scaletorch_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    429: "Too Many Requests", 500: "Internal Server Error",
    503: "Service Unavailable", 504: "Gateway Timeout",
}

MAX_BODY_BYTES = 8 * 2**20
MAX_HEADER_LINES = 100
HEADER_TIMEOUT_S = 30.0

# The per-tenant latency distributions the gateway records
# (telemetry/histogram.py): time-to-first-token, per-token
# inter-arrival, WFQ queue wait, engine prefill wall, end-to-end.
HIST_METRICS = ("ttft", "tpot", "queue_wait", "prefill", "e2e")


# --------------------------------------------------------------------------
# Engine worker: the sync engine on its own thread, push-streaming out
# --------------------------------------------------------------------------


class _Handlers:
    __slots__ = ("on_tokens", "on_done")

    def __init__(self, on_tokens: Callable[[List[int]], None],
                 on_done: Callable[[RequestResult], None]) -> None:
        self.on_tokens = on_tokens
        self.on_done = on_done


class EngineWorker:
    """One engine replica on one worker thread.

    The thread owns the engine exclusively: submits/cancels arrive as
    closures on an inbox drained between ticks, generated tokens leave
    through the engine's ``on_tokens`` hook, terminal results through
    the per-tick finished list — push on every edge, no polling of
    terminal state. ``tick_listeners`` fire after every tick (the
    gateway uses one to wake its dispatcher); callbacks run ON THE
    WORKER THREAD and must trampoline themselves onto the event loop.
    """

    def __init__(self, engine: InferenceEngine, *, replica_id: str = "r0",
                 idle_wait_s: float = 0.01,
                 max_drain_ticks: int = 100_000) -> None:
        if engine.on_tokens is not None:
            raise ValueError(
                "engine already has an on_tokens hook; the worker owns it")
        self.engine = engine
        self.replica_id = replica_id
        self.idle_wait_s = idle_wait_s
        self.max_drain_ticks = max_drain_ticks
        engine.on_tokens = self._hook_tokens
        self._inbox: "queue.SimpleQueue[Callable[[], None]]" = \
            queue.SimpleQueue()
        self._handlers: Dict[int, _Handlers] = {}
        self._reap_lock = threading.Lock()
        self._stop = False
        self.alive = False
        self.exit_code: Optional[int] = None
        self.tick_listeners: List[Callable[[], None]] = []
        # the card the engine's graphs were captured on: the worker
        # thread makes it current before its first replay
        device = getattr(engine, "device", None)
        self._cuda_index: Optional[int] = None
        if device is not None and device.type == "cuda":
            self._cuda_index = (device.index if device.index is not None
                                else torch.cuda.current_device())
        self._thread = threading.Thread(
            target=self._loop, name=f"engine-worker-{replica_id}",
            daemon=True)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "EngineWorker":
        self.alive = True
        self._thread.start()
        return self

    def shutdown(self, *, drain: bool = True) -> None:
        """Stop the worker: admissions stop immediately; with ``drain``
        the thread keeps ticking until in-flight requests finish (their
        streams end normally), without it everything in flight is
        aborted. Returns immediately — ``join()`` to wait."""

        def _do() -> None:
            self.engine.stop_admissions()
            if not drain:
                self._abort_inflight("gateway shutdown without drain")
            self._stop = True

        self._inbox.put(_do)

    def fail(self, detail: str = "replica marked dead") -> None:
        """Simulate/execute a replica death (the ``gw_replica_down``
        drill and the router ejection path): every in-flight request
        ends ``aborted`` with its partial tokens and pages released,
        then the thread exits with the serving-stall exit code in
        ``exit_code``."""

        def _do() -> None:
            self.engine.stop_admissions()
            self._abort_inflight(detail)
            self.exit_code = 44
            self._stop = True

        self._inbox.put(_do)

    def kill(self) -> None:
        """The ``gw_replica_crash`` drill on an in-process replica:
        thread-death semantics (``fail``) stand in for the SIGKILL a
        ``RemoteEngineWorker`` delivers to its child process."""
        self.fail("killed (crash drill)")

    def stall(self, seconds: float) -> None:
        """The ``gw_replica_hang`` drill: wedge the worker loop for
        ``seconds`` — no ticks, no watchdog beats — so an attached
        serving watchdog fires (exit 44), exactly like a stalled device
        dispatch."""

        def _do() -> None:
            time.sleep(seconds)

        self._inbox.put(_do)

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    # -- event-loop-side API ----------------------------------------------
    def submit(self, req: GenerateRequest,
               on_tokens: Callable[[int, List[int]], None],
               on_done: Callable[[RequestResult], None],
               *, ttl_s: Optional[float] = None,
               on_submitted: Optional[Callable[[int], None]] = None,
               ) -> None:
        """Enqueue one request onto the worker (any thread). Callbacks
        fire on the worker thread: ``on_submitted(request_id)`` once the
        engine assigns an id, ``on_tokens(request_id, token_ids)`` per
        tick with new tokens, and exactly one terminal ``on_done`` — a
        submit the engine refuses becomes an ``on_done`` with a
        ``rejected`` result."""

        def _do() -> None:
            try:
                rid = self.engine.submit(
                    req.prompt, max_new_tokens=req.max_new_tokens,
                    eos_id=req.eos_id, seed=req.seed, ttl_s=ttl_s,
                    trace_id=req.trace_id)
            except Exception as exc:
                on_done(RequestResult(
                    request_id=-1, prompt=list(req.prompt), tokens=[],
                    finish_reason="rejected", outcome="rejected",
                    detail=str(exc)))
                return
            self._handlers[rid] = _Handlers(on_tokens, on_done)
            if on_submitted is not None:
                on_submitted(rid)
            result = self.engine.result(rid)
            if result is not None:
                # terminal at submit (rejected under strict_submit=False)
                self._deliver(result)

        # enqueue FIRST, then re-check liveness: if the worker thread
        # exited between the dispatcher's health check and this put, no
        # thread will ever drain the inbox — reap it here so the closure
        # still runs (the engine is stopped, so _do answers `rejected`)
        # instead of stranding the client. The lock serializes this
        # against the thread's own exit-time reap; SimpleQueue makes a
        # doubly-drained inbox safe (each closure pops exactly once).
        self._inbox.put(_do)
        if not self.alive:
            self._reap_stale()

    def cancel(self, request_id: int, detail: str) -> None:
        """Abort one request (client disconnected). The ``aborted``
        terminal result is delivered through the normal path."""

        def _do() -> None:
            if self.engine.cancel(request_id, detail=detail):
                result = self.engine.result(request_id)
                if result is not None:
                    self._deliver(result)

        self._inbox.put(_do)

    def gauges(self) -> Dict[str, float]:
        """The live EngineMetrics snapshot (flat numeric reads — safe
        cross-thread) plus the compile counter the no-retrace contract
        watches."""
        snap = self.engine.metrics.snapshot()
        snap["decode_compile_count"] = float(self.engine.decode_compile_count)
        return snap

    @property
    def page_size(self) -> int:
        return self.engine.page_size

    @property
    def inflight(self) -> int:
        return len(self._handlers)

    # -- warm rejoin (blocking round-trips onto the worker thread) ---------
    def call_engine(self, fn: Callable[[InferenceEngine], Any],
                    *, timeout_s: float = 60.0) -> Any:
        """Run ``fn(engine)`` on the worker thread between ticks and
        return its result — the synchronous twin of ``submit`` for the
        warm-rejoin paths, which need a value back rather than a
        stream. Blocking: call from an executor/request thread, never
        the event loop."""
        box: List[Tuple[str, Any]] = []
        done = threading.Event()

        def _do() -> None:
            try:
                box.append(("ok", fn(self.engine)))
            except Exception as exc:  # delivered to the caller below
                box.append(("err", exc))
            finally:
                done.set()

        self._inbox.put(_do)
        if not self.alive:
            self._reap_stale()
        if not done.wait(timeout_s):
            raise TimeoutError(
                f"engine call on replica {self.replica_id} did not "
                f"return within {timeout_s}s")
        kind, value = box[0]
        if kind == "err":
            raise value
        return value

    def prefix_map(self) -> Dict[str, Any]:
        """Donor half: the engine's radix-tree snapshot."""
        return self.call_engine(lambda e: e.export_prefix_map())

    def export_prefix_pages(self, pages) -> Tuple[Dict[str, Any], Dict]:
        """Donor half: refcount-retained host copies of frozen pages."""
        return self.call_engine(lambda e: e.export_prefix_pages(pages))

    def import_prefix_pages(self, chains, contents, *, dtype,
                            page_shape, page_size) -> Dict[str, Any]:
        """Recipient half: install transferred pages + register chains
        (generous timeout: the write is one in-place copy per buffer, and
        a large import moves many pages)."""
        return self.call_engine(
            lambda e: e.import_prefix_pages(
                chains, contents, dtype=dtype, page_shape=page_shape,
                page_size=page_size),
            timeout_s=300.0)

    # -- worker-thread internals ------------------------------------------
    def _hook_tokens(self, slot: int, request_id: int,
                     token_ids: List[int]) -> None:
        handlers = self._handlers.get(request_id)
        if handlers is not None:
            handlers.on_tokens(request_id, list(token_ids))

    def _deliver(self, result: RequestResult) -> None:
        handlers = self._handlers.pop(result.request_id, None)
        self.engine.pop_result(result.request_id)
        if handlers is not None:
            handlers.on_done(result)

    def _abort_inflight(self, detail: str) -> None:
        for rid in list(self._handlers):
            if self.engine.cancel(rid, detail=detail):
                result = self.engine.result(rid)
                if result is not None:
                    self._deliver(result)
        # anything left (already terminal, delivery pending) flushes now
        for rid in list(self._handlers):
            result = self.engine.result(rid)
            if result is not None:
                self._deliver(result)

    def _drain_inbox(self) -> None:
        while True:
            try:
                fn = self._inbox.get_nowait()
            except queue.Empty:
                return
            fn()

    def _notify_tick(self) -> None:
        for listener in self.tick_listeners:
            try:
                listener()
            except Exception:
                pass

    def _loop(self) -> None:
        engine = self.engine
        drain_ticks = 0
        try:
            # per-thread state in PyTorch: grad mode and the current card
            torch.set_grad_enabled(False)
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            while True:
                self._drain_inbox()
                if self._stop:
                    if not engine.pending:
                        break
                    drain_ticks += 1
                    if drain_ticks > self.max_drain_ticks:
                        self._abort_inflight("drain tick budget exhausted")
                        break
                if engine.pending:
                    finished = engine.tick()
                    for result in finished:
                        self._deliver(result)
                    self._notify_tick()
                elif not self._stop:
                    # an idle engine runs no step() and so beats no
                    # watchdog — beat it here, or an armed serving
                    # watchdog (``scaletorch_tpu_torch.replica``) would count idle
                    # time as a stall and exit 44 for no reason
                    watchdog = engine.watchdog
                    if watchdog is not None:
                        watchdog.beat(step=engine.metrics.decode_steps,
                                      phase="idle")
                    try:
                        fn = self._inbox.get(timeout=self.idle_wait_s)
                    except queue.Empty:
                        continue
                    fn()
        except Exception:
            logger.exception(
                "engine worker %s crashed; aborting its in-flight "
                "requests", self.replica_id)
            self.exit_code = 44
            try:
                self._abort_inflight("replica crashed")
            except Exception:
                pass
        finally:
            self.alive = False
            if self.exit_code is None:
                self.exit_code = 0
            self._reap_stale()
            self._notify_tick()

    def _reap_stale(self) -> None:
        """Answer closures that raced into the inbox around the worker
        thread's exit — a submit landing here becomes a ``rejected``
        (the engine is stopped), never a hung client. Runs on the
        worker thread at exit AND on any caller that enqueued into a
        dead inbox; the lock serializes the two (the engine is no
        longer ticking, so cross-thread engine access is safe)."""
        with self._reap_lock:
            try:
                # idempotent; guarantees a stale submit is REJECTED
                # rather than queued into an engine nobody ticks
                self.engine.stop_admissions()
                self._drain_inbox()
                self._abort_inflight("replica exited")
            except Exception:
                pass


# --------------------------------------------------------------------------
# Gateway metrics
# --------------------------------------------------------------------------


@dataclass
class GatewayMetrics:
    """HTTP-layer counters. The conservation invariant extends the engine's
    to the wire: once every connection has its terminal response,
    ``http_requests_received == sum(outcomes.values())`` — checked by
    ``check_conservation`` and property-tested. Drill-injected storm
    requests are accounted separately (they are not HTTP requests).
    ``responses_by_status`` records each request's TERMINAL status
    (``STATUS_BY_OUTCOME``) — a stream that committed 200 and then
    timed out counts under 504, the status its outcome maps to."""

    http_requests_received: int = 0
    responses_by_status: Dict[int, int] = field(default_factory=dict)
    outcomes: Dict[str, int] = field(
        default_factory=lambda: {o: 0 for o in TERMINAL_OUTCOMES})
    sse_streams_open: int = 0
    sse_streams_total: int = 0
    injected_storm_requests: int = 0
    storm_outcomes: Dict[str, int] = field(
        default_factory=lambda: {o: 0 for o in TERMINAL_OUTCOMES})

    def record_response(self, outcome: str, status: int) -> None:
        self.outcomes[outcome] += 1
        self.responses_by_status[status] = \
            self.responses_by_status.get(status, 0) + 1

    def check_conservation(self) -> None:
        total = sum(self.outcomes.values())
        if total != self.http_requests_received:
            raise AssertionError(
                f"HTTP outcome leak: {self.http_requests_received} "
                f"received != {total} outcomes ({self.outcomes})")

    def snapshot(self, *, tenant_depths: Dict[str, int],
                 shed_count: int,
                 router_snapshot: Dict[str, float]) -> Dict[str, float]:
        snap: Dict[str, float] = {
            "http_requests_received": self.http_requests_received,
            "http_429_total": self.responses_by_status.get(429, 0),
            "sse_streams_open": self.sse_streams_open,
            "sse_streams_total": self.sse_streams_total,
            "gateway_shed_total": shed_count,
            "injected_storm_requests": self.injected_storm_requests,
        }
        for outcome, count in self.outcomes.items():
            snap[f"http_{outcome}"] = count
        for status, count in self.responses_by_status.items():
            snap[f"http_status_{status}"] = count
        for tenant, depth in tenant_depths.items():
            snap[f"tenant_queue_depth_{tenant}"] = depth
        snap.update(router_snapshot)
        return snap


# --------------------------------------------------------------------------
# The gateway
# --------------------------------------------------------------------------


class _Pending:
    """Event-loop-side state of one generate request, including its
    request-scoped observability state: the W3C trace id, the gateway
    timeline stamps (arrival / WFQ enqueue / dispatch / token arrivals)
    the per-tenant histograms and the access record derive from, and
    the engine's terminal ``RequestResult`` once it lands."""

    __slots__ = ("req", "chan", "request_id", "replica_id", "cancelled",
                 "deadline", "synthetic", "trace_id", "parent_span",
                 "arrival_t", "enqueue_t", "dispatch_t", "first_token_t",
                 "last_token_t", "token_count", "result")

    def __init__(self, req: GenerateRequest, *,
                 deadline: Optional[float],
                 synthetic: bool = False,
                 trace_id: Optional[str] = None,
                 parent_span: Optional[str] = None,
                 arrival_t: Optional[float] = None) -> None:
        self.req = req
        self.chan: "asyncio.Queue[Tuple[str, Any]]" = asyncio.Queue()
        self.request_id: Optional[int] = None
        self.replica_id: Optional[str] = None
        self.cancelled: Optional[str] = None  # outcome it was closed with
        self.deadline = deadline
        self.synthetic = synthetic
        self.trace_id = trace_id
        self.parent_span = parent_span
        self.arrival_t = arrival_t if arrival_t is not None \
            else time.monotonic()
        self.enqueue_t: Optional[float] = None
        self.dispatch_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.last_token_t: Optional[float] = None
        self.token_count = 0
        self.result: Optional[RequestResult] = None


class ServingGateway:
    """Asyncio HTTP/1.1 + SSE front end over one or more engine workers.

    Parameters
    ----------
    engines : one engine/worker, or ``{replica_id: engine-or-worker}``
        for multi-replica serving. Plain engines are wrapped in
        ``EngineWorker``s owned (started/joined) by the gateway; any
        other value is taken as an already-started worker — the
        in-process ``EngineWorker`` or a ``RemoteEngineWorker`` handle
        on a replica child process (serving/remote.py).
    supervisor : optional ``serving.supervisor.ReplicaSupervisor`` over
        the replica child processes. The gateway wires its exit/restart
        callbacks: a child exit applies the 0/42/43/44 contract to the
        router (``report_exit``), a restarted child's fresh worker is
        swapped in and ``rejoin``ed to routing cold, and /healthz +
        /metrics surface the per-replica process state (pid, state,
        restart counters, ``replica_restarts_total{replica=}``).
    router : optional ``PrefixAwareRouter`` (built over the replica ids
        and the first engine's page size when absent).
    tenants / default_weight / max_backlog / free_page_watermark :
        admission knobs (admission.AdmissionController).
    default_ttl_s : deadline for requests without their own ``ttl_s``
        (0 = none). Queued past it -> 504 ``timeout``; dispatched past
        it the ENGINE deadline fires (same outcome).
    injector : optional ``ServingFaultInjector`` driving the gateway
        drills (``gw_tenant_storm_*``, ``gw_replica_down_at``).
    exporter : optional ``telemetry.TelemetryExporter``; the gateway
        appends ``gateway_metrics`` + ``latency_histograms`` JSONL
        records every ``export_every`` terminal responses and at
        shutdown, plus one ``access`` record per terminal HTTP outcome
        (tenant, outcome, status, trace_id, queue_wait/ttft/e2e,
        tokens, prefix_hit, replica) — the same schema-versioned
        stream the trainer and engine write.
    tracer : optional ``telemetry.SpanTracer`` (share ONE instance with
        the engines — ``scaletorch_tpu_torch.serve`` does): the gateway emits
        ``gw.parse`` spans plus per-request async events (``gw.request``
        / ``gw.queued`` / ``gw.stream``) keyed by the W3C trace id, so
        a single Perfetto load shows one request crossing the asyncio
        thread, the worker bridge and the engine tick loop.
    slo_targets : optional preset spec from serving/slo.json
        (``serving.slo``); when set, ``/healthz`` carries a live
        ``slo`` block graded from the in-process histograms/outcomes.
    """

    def __init__(
        self,
        engines: Union[InferenceEngine, EngineWorker, Any,
                       Dict[str, Union[InferenceEngine, EngineWorker,
                                       Any]]],
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        router: Optional[PrefixAwareRouter] = None,
        tenants: Optional[Dict[str, TenantConfig]] = None,
        default_weight: float = 1.0,
        max_backlog: int = 256,
        free_page_watermark: float = 0.05,
        default_ttl_s: float = 0.0,
        injector: Optional[ServingFaultInjector] = None,
        exporter: Any = None,
        export_every: int = 32,
        tracer: Any = None,
        slo_targets: Optional[Dict[str, Any]] = None,
        supervisor: Any = None,
    ) -> None:
        if not isinstance(engines, dict):
            engines = {"r0": engines}
        if not engines:
            raise ValueError("gateway needs at least one engine")
        # a "worker" is anything with the EngineWorker surface — the
        # in-process thread bridge or a RemoteEngineWorker handle on a
        # replica child process (serving/remote.py); only bare engines
        # get wrapped (and owned) here
        self.workers: Dict[str, Any] = {}
        self._owned_workers: List[EngineWorker] = []
        for rid, eng in engines.items():
            if isinstance(eng, InferenceEngine):
                worker = EngineWorker(eng, replica_id=rid)
                self.workers[rid] = worker
                self._owned_workers.append(worker)
            else:
                self.workers[rid] = eng
        page_size = next(
            (w.page_size for w in self.workers.values()
             if getattr(w, "page_size", None)), 16)
        self.supervisor = supervisor
        self.router = router or PrefixAwareRouter(
            list(self.workers), page_size)
        self.admission = AdmissionController(
            gauges_fn=self._aggregate_gauges,
            tenants=tenants,
            default_weight=default_weight,
            max_backlog=max_backlog,
            free_page_watermark=free_page_watermark,
            # full-backlog fairness eviction: the over-share tenant's
            # oldest queued request answers 429 so an under-share
            # arrival can enter the fair queue
            on_shed=lambda pending, decision: self._finish_local(
                pending, "shed", decision.reason),
        )
        self.metrics = GatewayMetrics()
        self.hists = TenantHistograms(HIST_METRICS)
        self.tracer = tracer
        self.slo_targets = slo_targets
        self.default_ttl_s = default_ttl_s
        self.injector = injector
        self.exporter = exporter
        self.export_every = export_every
        self._responses_since_export = 0
        self._host = host
        self._requested_port = port
        self.port: Optional[int] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._wake: Optional[asyncio.Event] = None
        self._dispatch_task: Optional[asyncio.Task] = None
        self._tick_cb: Optional[Callable[[], None]] = None
        self._dispatch_count = 0
        self._closing = False
        self._open_generates = 0  # generate handlers awaiting a terminal
        self._thread: Optional[threading.Thread] = None
        self._thread_stopped = threading.Event()
        # warm-rejoin accounting (event-loop only): pages each replica
        # imported from peers + the transfer-latency distribution
        self._warm_pages: Dict[str, float] = {}
        self.warm_hist = LogHistogram()

    # -- gauges ------------------------------------------------------------
    def _aggregate_gauges(self) -> Dict[str, float]:
        """The admission controller's view of the fleet: pool occupancy
        summed over alive replicas (the shed watermark), engine queue
        depth of the SHALLOWEST replica (dispatch headroom — any
        replica able to take work means work can move)."""
        agg = {"pages_in_use": 0.0, "page_pool_free": 0.0,
               "queue_depth": float("inf"), "num_slots": 1.0}
        saw = False
        for worker in self.workers.values():
            if not worker.alive:
                continue
            snap = worker.gauges()
            saw = True
            agg["pages_in_use"] += snap.get("pages_in_use", 0.0)
            agg["page_pool_free"] += snap.get("page_pool_free", 0.0)
            if snap.get("queue_depth", 0.0) < agg["queue_depth"]:
                agg["queue_depth"] = snap.get("queue_depth", 0.0)
                agg["num_slots"] = max(1.0, snap.get("num_slots", 1.0))
        if not saw:
            agg["queue_depth"] = float("inf")
        return agg

    def _fleet_headroom(self) -> Dict[str, float]:
        """Free-page FRACTION per alive replica — the router's
        headroom signal: when the pools diverge it weights the
        rendezvous choice toward replicas with room instead of packing
        by prefix affinity alone (router.route ``headroom=``)."""
        out: Dict[str, float] = {}
        for rid, worker in self.workers.items():
            if not worker.alive:
                continue
            snap = worker.gauges()
            free = snap.get("page_pool_free")
            used = snap.get("pages_in_use", 0.0)
            if free is None:
                continue
            total = free + used
            if total > 0:
                out[rid] = free / total
        return out

    # -- tracing -----------------------------------------------------------
    def _span(self, name: str, **args):
        """Complete-event span on the gateway (asyncio) thread; shared
        no-op when untraced — the engine's one-branch contract."""
        if self.tracer is None:
            return NOOP_SPAN
        return self.tracer.span(name, **args)

    def _req_event(self, ph: str, trace_id: Optional[str], name: str,
                   **args) -> None:
        """Request-scoped async event on the trace_id track (same
        Chrome async-event surface the engine's lifecycle spans use, so
        gateway-side and engine-side spans correlate by id)."""
        if self.tracer is None or trace_id is None:
            return
        self.tracer.async_event(ph, name, trace_id, **args)

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "ServingGateway":
        self._loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        loop = self._loop
        wake = self._wake

        def _on_tick() -> None:
            try:
                loop.call_soon_threadsafe(wake.set)
            except RuntimeError:
                pass  # loop already closed during shutdown

        self._tick_cb = _on_tick
        for worker in self.workers.values():
            worker.tick_listeners.append(_on_tick)
        for worker in self._owned_workers:
            worker.start()
        if self.supervisor is not None:
            # monitor-thread callbacks trampoline onto this loop: child
            # exits apply the exit-code contract to the router, READY
            # replacements swap in and rejoin routing cold
            self.supervisor.on_exit = self._on_replica_exit
            self.supervisor.on_restart = self._on_replica_restart
        self._dispatch_task = asyncio.ensure_future(self._dispatch_loop())
        self._server = await asyncio.start_server(
            self._handle_connection, self._host, self._requested_port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info(
            "serving gateway on http://%s:%d (replicas: %s)",
            self._host, self.port, ", ".join(self.workers))
        return self

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        await self._server.serve_forever()

    # -- supervisor bridge (monitor thread -> event loop) ------------------
    def _on_replica_exit(self, replica_id: str, exit_code: int) -> None:
        loop = self._loop
        if loop is None:
            return
        try:
            loop.call_soon_threadsafe(
                self._apply_replica_exit, replica_id, exit_code)
        except RuntimeError:
            pass  # loop closed: shutdown owns the bookkeeping now

    def _apply_replica_exit(self, replica_id: str, exit_code: int) -> None:
        """Event-loop side of a child exit: the 0/42/43/44 contract
        applied to routing, the dead worker's poller stopped, and the
        dispatcher woken so queued work re-routes to survivors."""
        if replica_id in self.router.replicas:
            self.router.report_exit(replica_id, exit_code)
        worker = self.workers.get(replica_id)
        if worker is not None and hasattr(worker, "stop_polling"):
            worker.stop_polling()
        if self._wake is not None:
            self._wake.set()

    def _on_replica_restart(self, replica_id: str, worker: Any) -> None:
        loop = self._loop
        if loop is None:
            return
        try:
            loop.call_soon_threadsafe(
                self._apply_replica_restart, replica_id, worker)
        except RuntimeError:
            pass

    def _apply_replica_restart(self, replica_id: str,
                               worker: Any) -> None:
        """Swap the restarted child's fresh worker into the fleet and
        rejoin it to routing immediately (its radix tree is empty —
        mark_dead dropped the old owner entries at death), THEN kick
        off best-effort warmup as a background task: rejoin/wake happen
        first, so warming can never delay readiness or block
        admissions; if it lands, ``_warm_replica`` re-teaches the
        router the warmed chains."""
        if worker is None:
            return
        old = self.workers.get(replica_id)
        if old is not None and hasattr(old, "stop_polling"):
            old.stop_polling()
        self.workers[replica_id] = worker
        if self._tick_cb is not None:
            worker.tick_listeners.append(self._tick_cb)
        if replica_id in self.router.replicas:
            self.router.rejoin(replica_id)
        if self._wake is not None:
            self._wake.set()
        if hasattr(worker, "warm_start") and not self._closing:
            asyncio.ensure_future(self._warm_replica(replica_id, worker))

    # -- warm rejoin orchestration -----------------------------------------
    def _warm_donor_candidates(
        self, replica_id: str,
    ) -> List[Tuple[str, Dict[str, Any]]]:
        """Rank live peers as warmup donors, healthiest first: free-page
        headroom (a loaded donor shouldn't also feed a transfer) plus
        prefix-map size as a fraction of its pool (a donor with no
        registered pages has nothing to give)."""
        ranked: List[Tuple[float, str, Dict[str, Any]]] = []
        for rid, worker in self.workers.items():
            if rid == replica_id or not worker.alive:
                continue
            address = getattr(worker, "address", None)
            if not address:
                continue
            snap = worker.gauges()
            free = snap.get("page_pool_free", 0.0)
            used = snap.get("pages_in_use", 0.0)
            total = free + used
            headroom = free / total if total else 0.0
            map_fraction = (snap.get("prefix_pages", 0.0) / total
                            if total else 0.0)
            ranked.append((headroom + map_fraction, rid, address))
        ranked.sort(key=lambda t: (-t[0], t[1]))
        return [(rid, address) for _score, rid, address in ranked]

    async def _warm_replica(self, replica_id: str, worker: Any) -> None:
        """Best-effort warmup of a restarted replica from its peers.
        Runs as a detached task AFTER the replica rejoined routing; the
        blocking pull rides an executor thread, so neither readiness
        nor admissions wait on it. Every failure mode ends in the cold
        rejoin the fleet already survives."""
        donors = self._warm_donor_candidates(replica_id)
        if not donors:
            self._emit_warmup(replica_id, status="cold", donor=None,
                              pages=0, seconds=0.0,
                              detail="no live peers")
            return
        started = time.monotonic()
        loop = asyncio.get_running_loop()
        payload = [address for _rid, address in donors]
        try:
            summary = await loop.run_in_executor(
                None, worker.warm_start, payload)
        except Exception:
            logger.exception("warmup of replica %s raised", replica_id)
            summary = None
        elapsed = time.monotonic() - started
        if worker is not self.workers.get(replica_id):
            return  # replaced again mid-warm: stale result, drop it
        if not summary:
            self._emit_warmup(replica_id, status="cold", donor=None,
                              pages=0, seconds=round(elapsed, 4),
                              detail="warm_start unreachable")
            return
        pages = int(summary.get("pages", 0) or 0)
        if pages > 0:
            self._warm_pages[replica_id] = \
                self._warm_pages.get(replica_id, 0.0) + pages
            self.warm_hist.observe(elapsed)
            for tokens in summary.get("chains", []):
                self.router.learn_owner(tokens, replica_id)
            if self._wake is not None:
                self._wake.set()
        self._emit_warmup(
            replica_id, status=str(summary.get("status", "cold")),
            donor=summary.get("donor"), pages=pages,
            seconds=round(elapsed, 4),
            chunks_dropped=summary.get("chunks_dropped", 0),
            attempts=summary.get("attempts", 0))

    def _emit_warmup(self, replica_id: str, **record: Any) -> None:
        logger.info("warm rejoin: replica %s %s (%s pages, donor %s)",
                    replica_id, record.get("status"),
                    record.get("pages"), record.get("donor"))
        if self.exporter is not None:
            try:
                self.exporter.emit("warmup",
                                   {"replica": replica_id, **record})
            except Exception:
                logger.exception("warmup telemetry export failed")

    async def stop(self, *, drain: bool = True,
                   timeout_s: float = 60.0) -> None:
        """Graceful shutdown: stop accepting, abort the queued backlog
        (the engine's drain semantics: queued-but-never-dispatched ends
        ``aborted``), drain the replicas (in-flight streams end
        normally), flush the final metrics export."""
        if self._closing:
            return
        self._closing = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        # queued-but-not-dispatched requests end aborted NOW — a
        # SIGTERM grace period has no room for unbounded backlog
        for _tenant, pending, _cost in self.admission.queue.drain_all():
            self._finish_local(
                pending, "aborted", "gateway draining: not yet dispatched")
        for worker in self.workers.values():
            if worker.alive:
                worker.shutdown(drain=drain)
        loop = asyncio.get_running_loop()
        deadline = time.monotonic() + timeout_s
        for worker in self.workers.values():
            # join in the executor: the event loop must keep running so
            # in-flight SSE handlers can flush the tokens/done events the
            # draining workers are still pushing
            await loop.run_in_executor(
                None, worker.join, max(0.1, deadline - time.monotonic()))
            if hasattr(worker, "stop_polling"):
                worker.stop_polling()
        if self._dispatch_task is not None:
            self._wake.set()
            self._dispatch_task.cancel()
            try:
                await self._dispatch_task
            except (asyncio.CancelledError, Exception):
                pass
        # let the in-flight handlers consume their terminal events and
        # write their responses before the caller tears the loop down
        flush_deadline = time.monotonic() + 10.0
        while (self._open_generates > 0
               and time.monotonic() < flush_deadline):
            await asyncio.sleep(0.01)
        await asyncio.sleep(0)
        self._export(final=True)
        logger.info("serving gateway stopped (drained=%s)", drain)

    # -- sync harness (tests + scripts) -----------------------------------
    def start_in_thread(self) -> "ServingGateway":
        """Run the gateway on its own event-loop thread and return once
        the port is bound — the harness tests and the smoke script use
        this; production entry points drive ``start()`` directly."""
        started = threading.Event()
        error: List[BaseException] = []

        def _run() -> None:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            try:
                loop.run_until_complete(self.start())
            except BaseException as exc:  # surface bind errors
                error.append(exc)
                started.set()
                return
            started.set()
            try:
                loop.run_forever()
            finally:
                loop.close()
                self._thread_stopped.set()

        self._thread = threading.Thread(
            target=_run, name="serving-gateway", daemon=True)
        self._thread.start()
        started.wait(timeout=30.0)
        if error:
            raise error[0]
        if self.port is None:
            raise RuntimeError("gateway failed to start within 30s")
        return self

    def stop_sync(self, *, drain: bool = True,
                  timeout_s: float = 60.0) -> None:
        if self._thread is None or self._loop is None:
            return
        fut = asyncio.run_coroutine_threadsafe(
            self.stop(drain=drain, timeout_s=timeout_s), self._loop)
        fut.result(timeout=timeout_s + 10.0)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread_stopped.wait(timeout=10.0)
        self._thread.join(timeout=10.0)

    # -- dispatch ----------------------------------------------------------
    async def _dispatch_loop(self) -> None:
        while not self._closing:
            await self._wake.wait()
            self._wake.clear()
            try:
                self._dispatch_ready()
            except asyncio.CancelledError:
                raise
            except Exception:
                # a dispatcher death would strand every queued client;
                # log and keep pumping
                logger.exception("dispatch iteration failed")

    def _dispatch_ready(self) -> None:
        """Pump the fair queue into the replicas until headroom runs
        out (one wake's worth of work; synchronous, so it is atomic
        w.r.t. the handlers sharing the event loop)."""
        if not any(w.alive for w in self.workers.values()):
            # fleet gone: nothing will ever tick again — answer the
            # backlog instead of letting clients hang
            for _t, pending, _c in self.admission.queue.drain_all():
                self._finish_local(pending, "rejected",
                                   "no healthy replica")
            return
        # replicas that can take one more submit RIGHT NOW; a request
        # whose prefix-affine target is full is HELD (affinity beats a
        # cold prefill elsewhere) but must not freeze dispatch to the
        # other replicas — we keep scanning past it while any replica
        # still has headroom. Submits from THIS pump are closures the
        # worker has not executed yet, so the engine's queue gauge is
        # stale by exactly `pumped[rid]` — count them ourselves or one
        # pump could pour the whole backlog into a single replica.
        pumped: Dict[str, int] = {rid: 0 for rid in self.workers}

        def _room(rid: str, worker: EngineWorker) -> bool:
            snap = worker.gauges()
            return (snap.get("queue_depth", 0.0) + pumped[rid]
                    < max(1.0, snap.get("num_slots", 1.0)))

        open_replicas = {
            rid for rid, w in self.workers.items()
            if w.alive and _room(rid, w)}
        headroom = self._fleet_headroom()
        held = []
        try:
            while open_replicas:
                entry = self.admission.next_ready()
                if entry is None:
                    return
                tenant, pending, cost = entry
                now = time.monotonic()
                if pending.cancelled is not None:
                    continue  # its handler already answered (disconnect)
                if pending.deadline is not None \
                        and now >= pending.deadline:
                    self._finish_local(
                        pending, "timeout",
                        "deadline exceeded in the gateway queue")
                    continue
                try:
                    with self._span("gw.route"):
                        replica_id = self.router.route(
                            pending.req.prompt, headroom=headroom)
                except NoReplicaAvailable:
                    self._finish_local(pending, "rejected",
                                       "no healthy replica")
                    continue
                worker = self.workers[replica_id]
                if not worker.alive:
                    self.router.mark_dead(replica_id, worker.exit_code)
                    self.admission.requeue(tenant, pending, cost)
                    continue
                if replica_id not in open_replicas:
                    held.append(entry)
                    continue
                self._dispatch_count += 1
                self._submit_to(worker, replica_id, pending)
                pumped[replica_id] += 1
                if not _room(replica_id, worker):
                    open_replicas.discard(replica_id)
                if self.injector is not None and \
                        self.injector.take_gw_replica_down(
                            self._dispatch_count):
                    self.router.mark_dead(replica_id, 44)
                    worker.fail()
                    open_replicas.discard(replica_id)
                if self.injector is not None and \
                        self.injector.take_gw_replica_crash(
                            self._dispatch_count):
                    # process-level SIGKILL (in-process workers degrade
                    # to thread death); the crash is OBSERVED, never
                    # announced — the reader threads synthesize the
                    # aborted terminal, the poller/supervisor flip
                    # liveness and the router learns via report_exit
                    worker.kill()
                    open_replicas.discard(replica_id)
                if self.injector is not None and \
                        self.injector.take_gw_replica_hang(
                            self._dispatch_count):
                    # wedge the replica's step loop: no ticks, no
                    # watchdog beats — its serving watchdog exits 44
                    # and the supervisor restarts it with backoff
                    worker.stall(3600.0)
                    open_replicas.discard(replica_id)
        finally:
            # held requests go back to the FRONT of their tenant queues
            # in reverse pop order — fair-queue positions preserved
            for tenant, pending, cost in reversed(held):
                self.admission.requeue(tenant, pending, cost)

    def _submit_to(self, worker: EngineWorker, replica_id: str,
                   pending: _Pending) -> None:
        pending.replica_id = replica_id
        pending.dispatch_t = time.monotonic()
        self._req_event("e", pending.trace_id, "gw.queued")
        self._req_event("b", pending.trace_id, "gw.stream",
                        replica=replica_id)
        loop = self._loop
        chan = pending.chan

        def _push(kind: str, payload: Any) -> None:
            try:
                loop.call_soon_threadsafe(chan.put_nowait, (kind, payload))
            except RuntimeError:
                pass  # loop closed: the client is gone anyway

        # the request aged in the gateway queue; the engine deadline
        # continues the ORIGINAL budget, not a fresh one
        ttl = (max(0.001, pending.deadline - time.monotonic())
               if pending.deadline is not None else None)
        worker.submit(
            pending.req,
            lambda rid, toks: _push("tokens", (rid, toks)),
            lambda result: _push("done", result),
            ttl_s=ttl,
            on_submitted=lambda rid: _push("submitted", rid),
        )

    # -- request bookkeeping ----------------------------------------------
    def _finish_local(self, pending: _Pending, outcome: str,
                      detail: str) -> None:
        """Terminal a request that never reached an engine (gateway
        queue timeout / drain / no replica); its handler answers with
        the synthesized result."""
        if pending.cancelled is not None:
            return
        pending.cancelled = outcome
        pending.chan.put_nowait(("local", (outcome, detail)))

    def _finish_unqueued(self, outcome: str, status: int,
                         trace_id: Optional[str], tenant: str,
                         arrival_t: float) -> None:
        """Terminal a request refused BEFORE admission (parse failure,
        draining gateway) through the same bookkeeping point as every
        other outcome — the access log and span close cover 400s too."""
        req = GenerateRequest(prompt=[], tenant=tenant, stream=False,
                              trace_id=trace_id)
        pending = _Pending(req, deadline=None, trace_id=trace_id,
                           arrival_t=arrival_t)
        self._record_outcome(pending, outcome, status)

    def _record_outcome(self, pending: _Pending, outcome: str,
                        status: int) -> None:
        """The single per-request terminal bookkeeping point: outcome
        counters, per-tenant latency histograms, the ``access`` JSONL
        record, and the request's gateway-span close."""
        if pending.synthetic:
            self.metrics.storm_outcomes[outcome] += 1
            return
        self.metrics.record_response(outcome, status)
        now = time.monotonic()
        tenant = pending.req.tenant
        result = pending.result
        # only SERVED outcomes feed the SLO latency quantiles
        # (slo.LATENCY_OUTCOMES): a shed/rejected refusal terminates in
        # microseconds, and folding those into the histograms would drag
        # p99 down exactly when overload makes served traffic slowest.
        # TTFT/TPOT are observed at token arrival (served by
        # definition); the access record keeps every timing regardless.
        served = outcome in LATENCY_OUTCOMES
        queue_wait = None
        if pending.enqueue_t is not None:
            # WFQ wait: enqueue -> dispatch, or -> terminal when it
            # never dispatched (timed out / shed / drained in the queue)
            queue_wait = (pending.dispatch_t or now) - pending.enqueue_t
            if served:
                self.hists.observe("queue_wait", tenant, queue_wait)
            if pending.dispatch_t is None:
                self._req_event("e", pending.trace_id, "gw.queued",
                                outcome=outcome)
        ttft = None
        if pending.first_token_t is not None:
            ttft = pending.first_token_t - pending.arrival_t
        e2e = now - pending.arrival_t
        if served:
            self.hists.observe("e2e", tenant, e2e)
            if result is not None and result.prefill_s is not None:
                self.hists.observe("prefill", tenant, result.prefill_s)
        if pending.dispatch_t is not None:
            self._req_event("e", pending.trace_id, "gw.stream",
                            outcome=outcome)
        self._req_event("e", pending.trace_id, "gw.request",
                        outcome=outcome, status=status)
        if self.exporter is not None:
            record = {
                "tenant": tenant,
                "outcome": outcome,
                "status": status,
                "trace_id": pending.trace_id,
                "request_id": pending.request_id,
                "replica": pending.replica_id,
                "stream": pending.req.stream,
                "prompt_tokens": len(pending.req.prompt),
                "tokens": pending.token_count,
                "queue_wait_s": queue_wait,
                "engine_queue_wait_s": (
                    result.queue_wait_s if result is not None else None),
                "prefill_s": (
                    result.prefill_s if result is not None else None),
                "ttft_s": ttft,
                "e2e_s": e2e,
                "prefix_hit": (
                    bool(result.prefix_hit) if result is not None
                    else False),
            }
            try:
                self.exporter.emit("access", record)
            except Exception:
                logger.exception("access record export failed")
        self._responses_since_export += 1
        if self.exporter is not None and \
                self._responses_since_export >= self.export_every:
            self._export()

    def _export(self, final: bool = False) -> None:
        if self.exporter is None:
            return
        self._responses_since_export = 0
        try:
            self.exporter.emit("gateway_metrics", self.snapshot())
            hist_record = self.hists.to_record()
            if hist_record:
                self.exporter.emit("latency_histograms", hist_record)
        except Exception:
            logger.exception("gateway metrics export failed")

    def snapshot(self) -> Dict[str, float]:
        """The gateway's flat gauge/counter record — the
        ``gateway_metrics`` JSONL kind and the /metrics exposition."""
        return self.metrics.snapshot(
            tenant_depths=self.admission.depths(),
            shed_count=self.admission.shed_count,
            router_snapshot=self.router.snapshot(),
        )

    # -- HTTP --------------------------------------------------------------
    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        try:
            # HTTP/1.1 keep-alive on the read-only endpoints: a
            # scrape-heavy Prometheus consumer polls /metrics (and a
            # load balancer /healthz) every few seconds, and paying a
            # TCP handshake per scrape is pure overhead (ROADMAP
            # front-door item). Generate requests keep one-shot
            # connections — an SSE stream owns its socket until the
            # terminal event anyway.
            while True:
                request = await self._read_request(reader)
                if request is None:
                    return
                method, path, headers, body = request
                route = path.split("?")[0]
                if route == "/v1/generate":
                    if method != "POST":
                        await self._respond_json(
                            writer, 405, {"detail": "POST only"})
                        return
                    await self._handle_generate(reader, writer, headers,
                                                body)
                    return
                keep_alive = (
                    headers.get("connection", "").lower() != "close"
                    and not self._closing)
                if route in ("/metrics", "/metrics/"):
                    await self._handle_metrics(writer,
                                               keep_alive=keep_alive)
                elif route in ("/healthz", "/healthz/"):
                    await self._handle_healthz(writer,
                                               keep_alive=keep_alive)
                else:
                    await self._respond_json(
                        writer, 404, {"detail": f"no route {path!r}"})
                    return
                if not keep_alive:
                    return
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError):
            pass
        except ProtocolError as exc:  # framing violation at the read
            try:                      # layer (bad/oversized length)
                await self._respond_json(writer, exc.status,
                                         {"detail": str(exc)})
            except Exception:
                pass
        except Exception:
            logger.exception("connection handler failed")
            try:
                await self._respond_json(
                    writer, 500, {"detail": "internal error"})
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_request(
        self, reader: asyncio.StreamReader
    ) -> Optional[Tuple[str, str, Dict[str, str], bytes]]:
        line = await asyncio.wait_for(
            reader.readline(), timeout=HEADER_TIMEOUT_S)
        if not line.strip():
            return None
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            return None
        method, path = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        for _ in range(MAX_HEADER_LINES):
            raw = await asyncio.wait_for(
                reader.readline(), timeout=HEADER_TIMEOUT_S)
            if raw in (b"\r\n", b"\n", b""):
                break
            key, _, value = raw.decode("latin-1").partition(":")
            headers[key.strip().lower()] = value.strip()
        raw_length = headers.get("content-length", "0") or "0"
        try:
            length = int(raw_length)
        except ValueError:
            raise ProtocolError(
                f"invalid Content-Length {raw_length!r}") from None
        if length < 0:
            raise ProtocolError(f"invalid Content-Length {length}")
        if length > MAX_BODY_BYTES:
            raise ProtocolError(f"body too large ({length} bytes)",
                                status=413)
        body = await reader.readexactly(length) if length else b""
        return method, path, headers, body

    async def _respond_json(self, writer: asyncio.StreamWriter, status: int,
                            payload: Dict[str, Any],
                            extra_headers: Tuple[Tuple[str, str], ...] = (),
                            keep_alive: bool = False) -> None:
        body = json.dumps(payload).encode()
        head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
                "Content-Type: application/json",
                f"Content-Length: {len(body)}",
                f"Connection: {'keep-alive' if keep_alive else 'close'}"]
        head += [f"{k}: {v}" for k, v in extra_headers]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        await writer.drain()

    def metric_families(self) -> List[Dict[str, Any]]:
        """The /metrics exposition as structured families: unlabeled
        gateway counters/gauges (the reference's names), tenant-
        and replica-labeled series where an identity is involved —
        labels, not name mangling, carry the untrusted strings — and
        the per-tenant latency distributions as real histogram
        families."""
        families: List[Dict[str, Any]] = []
        base = self.metrics.snapshot(
            tenant_depths={}, shed_count=self.admission.shed_count,
            router_snapshot=self.router.snapshot())
        for key in sorted(base):
            ftype = "gauge" if key in ("sse_streams_open",) \
                or key.startswith("router_") else "counter"
            families.append({"name": key, "type": ftype,
                             "samples": [(None, base[key])]})
        families.append({
            "name": "tenant_queue_depth", "type": "gauge",
            "samples": [({"tenant": t}, d)
                        for t, d in sorted(self.admission.depths().items())],
        })
        families.append({
            "name": "gateway_shed_by_tenant", "type": "counter",
            "samples": [
                ({"tenant": t}, c) for t, c in
                sorted(self.admission.shed_by_tenant.items())],
        })
        if self.supervisor is not None:
            status = self.supervisor.status()
            families.append({
                "name": "replica_restarts_total", "type": "counter",
                "samples": [
                    ({"replica": rid}, s.get("restarts_total", 0))
                    for rid, s in sorted(status.items())],
            })
            families.append({
                "name": "replica_up", "type": "gauge",
                "samples": [
                    ({"replica": rid},
                     1.0 if s.get("state") == "up" else 0.0)
                    for rid, s in sorted(status.items())],
            })
        families.append({
            "name": "replica_warm_pages_total", "type": "counter",
            "samples": [
                ({"replica": rid}, float(self._warm_pages.get(rid, 0.0)))
                for rid in sorted(self.workers)],
        })
        if self.warm_hist.count:
            families.append({
                "name": "warm_transfer_seconds", "type": "histogram",
                "series": [(None, self.warm_hist)],
            })
        # disaggregated replicas: per-request handoff latency (prefill
        # done -> decode slot bound). In-process engines expose the
        # histogram object directly; the per-slice GAUGES ride the
        # generic engine_* export below (busy fractions, handoff
        # counters — every DisaggMetrics.snapshot() key).
        handoff_series = []
        for rid, worker in sorted(self.workers.items()):
            hist = getattr(
                getattr(worker, "engine", None), "metrics", None)
            hist = hist.hist.get("handoff") if hist is not None else None
            if hist is not None and hist.count:
                handoff_series.append(({"replica": rid}, hist))
        if handoff_series:
            families.append({
                "name": "handoff_seconds", "type": "histogram",
                "series": handoff_series,
            })
        engine_samples: Dict[str, List] = {}
        for rid, worker in self.workers.items():
            for key, value in worker.gauges().items():
                engine_samples.setdefault(key, []).append(
                    ({"replica": rid}, value))
        for key in sorted(engine_samples):
            families.append({"name": f"engine_{key}", "type": "gauge",
                             "samples": engine_samples[key]})
        for metric in HIST_METRICS:
            series = self.hists.series(metric)
            if not series:
                continue
            families.append({
                "name": f"request_{metric}_seconds", "type": "histogram",
                "series": [({"tenant": t}, h)
                           for t, h in sorted(series.items())],
            })
        return families

    async def _handle_metrics(self, writer: asyncio.StreamWriter,
                              keep_alive: bool = False) -> None:
        body = render_families(self.metric_families()).encode()
        head = ("HTTP/1.1 200 OK\r\n"
                "Content-Type: text/plain; version=0.0.4\r\n"
                f"Content-Length: {len(body)}\r\n"
                "Connection: "
                f"{'keep-alive' if keep_alive else 'close'}\r\n\r\n"
                ).encode()
        writer.write(head + body)
        await writer.drain()

    def slo_status(self) -> Optional[Dict[str, Any]]:
        """Live SLO verdict from the in-process histograms + outcome
        counters (None when no targets are configured)."""
        if self.slo_targets is None:
            return None

        def quantile(metric: str, q: float) -> Optional[float]:
            merged = self.hists.merged(metric)
            return merged.quantile(q) if merged is not None else None

        return evaluate_slo(self.slo_targets, quantile_fn=quantile,
                            outcomes=self.metrics.outcomes)

    async def _handle_healthz(self, writer: asyncio.StreamWriter,
                              keep_alive: bool = False) -> None:
        replicas: Dict[str, Any] = {}
        any_alive = False
        supervisor_status = (self.supervisor.status()
                             if self.supervisor is not None else {})
        for rid, worker in self.workers.items():
            snap = worker.gauges() if worker.alive else {}
            any_alive = any_alive or worker.alive
            replicas[rid] = {
                "alive": worker.alive,
                "exit_code": worker.exit_code,
                "queue_depth": snap.get("queue_depth"),
                "slot_occupancy": snap.get("slot_occupancy"),
                "pages_in_use": snap.get("pages_in_use"),
                "page_pool_free": snap.get("page_pool_free"),
                "prefix_pages": snap.get("prefix_pages"),
                "warm_pages": snap.get("warm_pages_total"),
            }
            if "prefill_slice_devices" in snap:
                # disaggregated replica: per-slice health (the decode
                # slice's pool rides the base pages_in_use /
                # page_pool_free gauges above)
                replicas[rid]["disagg"] = {
                    "prefill_slice": {
                        "devices": snap.get("prefill_slice_devices"),
                        "pages_in_use": snap.get("prefill_pages_in_use"),
                        "pool_free": snap.get("prefill_pool_free"),
                        "busy_fraction":
                            snap.get("prefill_slice_busy_fraction"),
                    },
                    "decode_slice": {
                        "devices": snap.get("decode_slice_devices"),
                        "pages_in_use": snap.get("pages_in_use"),
                        "pool_free": snap.get("page_pool_free"),
                        "busy_fraction":
                            snap.get("decode_slice_busy_fraction"),
                    },
                    "handoffs": snap.get("handoffs"),
                    "handoff_failures": snap.get("handoff_failures"),
                    "pages_handed_off": snap.get("pages_handed_off"),
                }
            # process state: from the supervisor when one runs the
            # fleet, else whatever the worker itself knows (a remote
            # worker learns its child's pid from /healthz)
            proc_state = supervisor_status.get(rid)
            if proc_state is not None:
                replicas[rid].update({
                    "pid": proc_state.get("pid"),
                    "state": proc_state.get("state"),
                    "restarts_total": proc_state.get("restarts_total"),
                    "restarts_consecutive":
                        proc_state.get("restarts_consecutive"),
                    "last_exit_code": proc_state.get("last_exit_code"),
                })
            elif getattr(worker, "pid", None) is not None:
                replicas[rid]["pid"] = worker.pid
        healthy = any_alive and not self._closing
        payload = {
            "v": protocol.PROTOCOL_VERSION,
            "status": ("ok" if healthy
                       else "draining" if self._closing else "dead"),
            "backlog": len(self.admission.queue),
            "replicas": replicas,
        }
        slo = self.slo_status()
        if slo is not None:
            payload["slo"] = slo
        await self._respond_json(writer, 200 if healthy else 503, payload,
                                 keep_alive=keep_alive)

    # -- generate ----------------------------------------------------------
    def _inject_tenant_storm(self, count: int) -> None:
        """The gw_tenant_storm drill: one synthetic tenant floods the
        fair queue. The storm requests run for real (tiny, 1-2 tokens)
        but answer no socket — their outcomes land in the drill-side
        counters so HTTP conservation stays exact."""
        for _ in range(count):
            self.metrics.injected_storm_requests += 1
            req = GenerateRequest(prompt=[1], max_new_tokens=1,
                                  tenant="storm", stream=False)
            pending = _Pending(req, deadline=None, synthetic=True)
            shed = self.admission.offer("storm", pending, float(req.cost))
            if shed is not None:
                self.metrics.storm_outcomes[shed.outcome] += 1
                continue
            asyncio.ensure_future(self._reap_synthetic(pending))
        self._wake.set()

    async def _reap_synthetic(self, pending: _Pending) -> None:
        while True:
            kind, payload = await pending.chan.get()
            if kind == "done":
                self.metrics.storm_outcomes[payload.outcome] += 1
                return
            if kind == "local":
                self.metrics.storm_outcomes[payload[0]] += 1
                return

    async def _handle_generate(self, reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter,
                               headers: Dict[str, str],
                               body: bytes) -> None:
        self._open_generates += 1
        try:
            await self._handle_generate_inner(reader, writer, headers,
                                              body)
        finally:
            self._open_generates -= 1

    async def _handle_generate_inner(self, reader: asyncio.StreamReader,
                                     writer: asyncio.StreamWriter,
                                     headers: Dict[str, str],
                                     body: bytes) -> None:
        arrival_t = time.monotonic()
        self.metrics.http_requests_received += 1
        arrival_n = self.metrics.http_requests_received
        if self.injector is not None:
            storm = self.injector.take_gw_tenant_storm(arrival_n)
            if storm:
                self._inject_tenant_storm(storm)
        # W3C trace context: accept the client's traceparent, mint a
        # fresh trace otherwise — a malformed header degrades to a new
        # trace, NEVER an error (fuzz-tested); the response echoes the
        # trace id with the gateway's span id as the new parent
        parent = protocol.parse_traceparent(headers.get("traceparent"))
        trace_id = parent[0] if parent else protocol.new_trace_id()
        span_id = protocol.new_span_id()
        traceparent_echo = (
            ("traceparent", protocol.make_traceparent(trace_id, span_id)),)
        self._req_event("b", trace_id, "gw.request",
                        parent_span=parent[1] if parent else None)
        try:
            with self._span("gw.parse", bytes=len(body)):
                req = protocol.parse_generate_request(
                    body, header_tenant=headers.get("x-tenant"))
        except ProtocolError as exc:
            self._finish_unqueued(
                "rejected", protocol.BAD_REQUEST_STATUS, trace_id,
                headers.get("x-tenant") or protocol.DEFAULT_TENANT,
                arrival_t)
            await self._respond_json(
                writer, protocol.BAD_REQUEST_STATUS,
                protocol.error_payload(str(exc)),
                extra_headers=traceparent_echo)
            return
        req.trace_id = trace_id
        if self._closing:
            self._finish_unqueued("rejected", 503, trace_id, req.tenant,
                                  arrival_t)
            await self._respond_json(
                writer, 503,
                protocol.error_payload("gateway is draining"),
                extra_headers=traceparent_echo)
            return
        ttl = req.ttl_s if req.ttl_s is not None else (
            self.default_ttl_s if self.default_ttl_s > 0 else None)
        deadline = time.monotonic() + ttl if ttl else None
        pending = _Pending(req, deadline=deadline, trace_id=trace_id,
                           parent_span=parent[1] if parent else None,
                           arrival_t=arrival_t)
        shed = self.admission.offer(req.tenant, pending, float(req.cost))
        if shed is not None:
            status = protocol.STATUS_BY_OUTCOME[shed.outcome]
            extra: Tuple[Tuple[str, str], ...] = traceparent_echo
            retry_s = None
            if shed.outcome == "shed":  # backing off helps: say how long
                retry_s = shed.retry_after_s
                extra = extra + (("Retry-After",
                                  str(max(1, int(round(retry_s))))),)
            self._record_outcome(pending, shed.outcome, status)
            await self._respond_json(
                writer, status,
                protocol.error_payload(
                    shed.reason, outcome=shed.outcome,
                    retry_after_s=retry_s),
                extra_headers=extra)
            return
        pending.enqueue_t = time.monotonic()
        self._req_event("b", trace_id, "gw.queued", tenant=req.tenant)
        self._wake.set()
        if req.stream:
            await self._stream_response(reader, writer, pending,
                                        traceparent_echo)
        else:
            await self._unary_response(writer, pending, traceparent_echo)

    async def _await_terminal(
        self, pending: _Pending,
        on_tokens: Optional[Callable[[List[int]], Any]] = None,
        disconnect: Optional[asyncio.Task] = None,
    ) -> Tuple[str, int, Dict[str, Any]]:
        """Drive one pending request to its terminal record:
        ``(outcome, http_status, done_payload)``. Streams pass
        ``on_tokens`` (an async callable writing SSE frames) and a
        ``disconnect`` watch task; a disconnect mid-flight cancels the
        request in its engine (pages released) and synthesizes the
        ``aborted`` terminal."""
        req = pending.req
        while True:
            get = asyncio.ensure_future(pending.chan.get())
            waits = {get}
            if disconnect is not None:
                waits.add(disconnect)
            done, _ = await asyncio.wait(
                waits, return_when=asyncio.FIRST_COMPLETED)
            if disconnect is not None and disconnect in done:
                detail = "client disconnected mid-stream"
                if get.done() and not get.cancelled():
                    # the channel get completed in the SAME loop turn:
                    # its event must not be dropped — a 'submitted'/
                    # 'tokens' carries the engine id the cancel needs,
                    # a 'done' means there is nothing left to cancel
                    kind, payload = get.result()
                    if kind == "submitted":
                        pending.request_id = payload
                    elif kind == "tokens":
                        pending.request_id = payload[0]
                    elif kind == "done":
                        pending.cancelled = "aborted"  # client gone
                        pending.result = payload
                        return "aborted", \
                            protocol.STATUS_BY_OUTCOME["aborted"], \
                            protocol.result_payload(
                                payload.request_id, outcome="aborted",
                                finish_reason="aborted",
                                token_ids=list(payload.tokens),
                                prompt_tokens=len(req.prompt),
                                detail=detail,
                                trace_id=pending.trace_id)
                else:
                    get.cancel()
                self._cancel_disconnected(pending, detail)
                return "aborted", protocol.STATUS_BY_OUTCOME["aborted"], \
                    protocol.result_payload(
                        pending.request_id if pending.request_id is not None
                        else -1,
                        outcome="aborted", finish_reason="aborted",
                        token_ids=[], prompt_tokens=len(req.prompt),
                        detail=detail, trace_id=pending.trace_id)
            kind, payload = get.result()
            if kind == "submitted":
                pending.request_id = payload
            elif kind == "tokens":
                rid, token_ids = payload
                pending.request_id = rid
                # token-arrival stamps as the CLIENT experiences them —
                # TTFT/TPOT measured at the event loop, after the
                # worker-bridge trampoline, per tenant
                now = time.monotonic()
                if pending.first_token_t is None:
                    pending.first_token_t = now
                    self.hists.observe(
                        "ttft", req.tenant, now - pending.arrival_t)
                elif pending.last_token_t is not None:
                    self.hists.observe(
                        "tpot", req.tenant, now - pending.last_token_t)
                pending.last_token_t = now
                pending.token_count += len(token_ids)
                if on_tokens is not None:
                    await on_tokens(rid, token_ids)
            elif kind == "done":
                result: RequestResult = payload
                pending.request_id = result.request_id
                pending.result = result
                return result.outcome, \
                    protocol.STATUS_BY_OUTCOME[result.outcome], \
                    protocol.result_payload(
                        result.request_id,
                        outcome=result.outcome,
                        finish_reason=result.finish_reason,
                        token_ids=list(result.tokens),
                        prompt_tokens=len(req.prompt),
                        detail=result.detail,
                        trace_id=pending.trace_id)
            elif kind == "local":
                outcome, detail = payload
                return outcome, protocol.STATUS_BY_OUTCOME[outcome], \
                    protocol.result_payload(
                        -1, outcome=outcome, finish_reason=outcome,
                        token_ids=[], prompt_tokens=len(req.prompt),
                        detail=detail, trace_id=pending.trace_id)

    async def _reap_disconnected(self, pending: _Pending,
                                 detail: str) -> None:
        """The stream's handler has already answered ``aborted``; keep
        consuming the channel until the engine id appears (on the
        ``submitted`` event or riding a ``tokens`` event), cancel the
        request there (pages released), and swallow its terminal."""
        cancelled = False
        while True:
            kind, payload = await pending.chan.get()
            rid = None
            if kind == "submitted":
                rid = payload
            elif kind == "tokens":
                rid = payload[0]
            elif kind in ("done", "local"):
                return
            if rid is not None and not cancelled \
                    and pending.replica_id is not None:
                cancelled = True
                self.workers[pending.replica_id].cancel(rid, detail)

    async def _unary_response(self, writer: asyncio.StreamWriter,
                              pending: _Pending,
                              extra_headers: Tuple[Tuple[str, str], ...] = (),
                              ) -> None:
        outcome, status, payload = await self._await_terminal(pending)
        self._record_outcome(pending, outcome, status)
        extra = extra_headers
        if outcome == "shed":
            # every 429 carries a Retry-After, including fairness
            # evictions decided after this arrival was queued
            extra = extra + (("Retry-After", str(max(1, int(round(
                self.admission.retry_after_hint()))))),)
        await self._respond_json(writer, status, payload,
                                 extra_headers=extra)

    async def _stream_response(self, reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter,
                               pending: _Pending,
                               extra_headers: Tuple[Tuple[str, str], ...] = (),
                               ) -> None:
        self.metrics.sse_streams_open += 1
        self.metrics.sse_streams_total += 1
        # an SSE client signals disconnect by closing its socket — the
        # read side completes (EOF/reset) while the stream is mid-flight
        disconnect = asyncio.ensure_future(self._watch_disconnect(reader))
        recorded = False
        try:
            head = ["HTTP/1.1 200 OK",
                    "Content-Type: text/event-stream",
                    "Cache-Control: no-cache",
                    "Connection: close"]
            head += [f"{k}: {v}" for k, v in extra_headers]
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode())
            await writer.drain()

            async def _write_tokens(rid: int, token_ids: List[int]) -> None:
                writer.write(protocol.format_sse_event(
                    "token", protocol.token_payload(rid, token_ids)))
                await writer.drain()

            outcome, status, payload = await self._await_terminal(
                pending, on_tokens=_write_tokens, disconnect=disconnect)
            self._record_outcome(pending, outcome, status)
            recorded = True
            try:
                writer.write(protocol.format_sse_event("done", payload))
                await writer.drain()
            except (ConnectionError, RuntimeError):
                pass  # client gone: the outcome is already recorded
        except (ConnectionError, OSError):
            # a WRITE failed before the disconnect watcher saw the EOF —
            # same situation, same path: cancel the request (pages
            # released) and record its terminal, or conservation breaks
            if not recorded:
                self._cancel_disconnected(pending,
                                          "client connection lost")
                self._record_outcome(
                    pending, "aborted",
                    protocol.STATUS_BY_OUTCOME["aborted"])
                recorded = True
        finally:
            self.metrics.sse_streams_open -= 1
            if not disconnect.done():
                disconnect.cancel()

    def _cancel_disconnected(self, pending: _Pending, detail: str) -> None:
        """Stop decoding for a dead socket: cancel in the engine if the
        id is known, otherwise reap it as soon as the id trampolines
        back; queued-but-undispatched entries are skipped by the
        dispatcher via ``pending.cancelled``."""
        if pending.cancelled is not None:
            return
        pending.cancelled = "aborted"
        if pending.replica_id is not None:
            if pending.request_id is not None:
                self.workers[pending.replica_id].cancel(
                    pending.request_id, detail)
            else:
                asyncio.ensure_future(
                    self._reap_disconnected(pending, detail))

    async def _watch_disconnect(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                chunk = await reader.read(4096)
                if not chunk:
                    return
        except (ConnectionError, asyncio.CancelledError):
            return
