"""Host-side span tracing: Chrome-trace-event JSON and a crash-report
tail (counterpart of scaletorch_tpu/telemetry/spans.py).

Where a ``MetricsLogger`` line says *how fast* a step was, the span
stream says *where the host's time went* — data fetch vs step dispatch
vs checkpoint save on the trainer, admission vs prefill vs decode on the
inference engine. Spans are Chrome trace events (the ``traceEvents``
JSON array), so a run's timeline loads in Perfetto or
``chrome://tracing``.

Two contracts every instrumentation site relies on:

  * **disabled is free** — a disabled tracer costs one branch per call
    site (``if tracer is not None`` at the caller, or the
    ``self.enabled`` check inside every method).
  * **spans never force a device sync** — a span measures HOST time: the
    time to *queue* work on the card, not to finish it. A
    ``step_dispatch`` span that closes in milliseconds is healthy while
    the card is still busy; the device-side truth lives in the anomaly
    profiler's ``torch.profiler`` windows (telemetry/profiling.py). No
    tracer method reads a device value. (The engine's ``decode`` span
    does cover the step's one token copy back to the host, because the
    engine makes that copy inside it, as the reference's span covers its
    host read of the tokens.)

Durability: events append to the trace file as they complete (capped at
``max_events``, with the drop count recorded). The file is a valid JSON
array after ``close()``; before that it lacks the terminator, which
Perfetto and ``load_trace`` tolerate. Independently of the file, an
in-memory ``tail()`` of the newest events rides crash reports and
SIGUSR1 live snapshots.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import IO, Any, Dict, List, Optional


class _NoopSpan:
    """Shared do-nothing context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NOOP_SPAN = _NoopSpan()


class _Span:
    """An open span; closing it (context-manager exit) records the event."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str,
                 args: Optional[Dict[str, Any]]) -> None:
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = tracer._now_us()

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> None:
        self._tracer._complete(self.name, self._t0, self.args)


class SpanTracer:
    """Low-overhead host-side tracer writing Chrome trace events.

    Three event surfaces:

      * ``span(name, **args)`` — a context manager timing one host-side
        region as a complete event (``ph: "X"``);
      * ``phase(name, step=...)`` — a *phase track*: each call closes the
        previously open phase span and opens the next, so the train
        loop's existing watchdog beat sites (``step_boundary`` /
        ``data_fetch`` / ``step_dispatch`` / ``checkpoint``) double as
        span boundaries and liveness + tracing share one vocabulary;
      * ``instant(name)`` / ``counter(name, value)`` — point events and
        counter tracks (``ph: "i"`` / ``"C"``).

    ``path=None`` keeps the tracer memory-only (tail still collected);
    ``enabled=False`` makes every method a single-branch no-op.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        process_index: int = 0,
        role: str = "train",
        max_events: int = 200_000,
        tail_size: int = 256,
        enabled: bool = True,
    ) -> None:
        self.enabled = enabled
        self.path = path
        self.process_index = process_index
        self.role = role
        self.max_events = max_events
        self.events_written = 0
        self.events_dropped = 0
        self._tail: deque = deque(maxlen=tail_size)
        # Reentrant: the SIGUSR1 live-snapshot handler runs on the main
        # thread and reads tail() — which must not deadlock when the
        # signal interrupted the same thread mid-_emit.
        self._lock = threading.RLock()
        self._file: Optional[IO[str]] = None
        self._first_event = True
        self._closed = False
        # epoch pairing: ts fields are perf_counter microseconds offset
        # from this origin; wall_time_origin in metadata lets a reader
        # align the trace with log timestamps
        self._origin = time.perf_counter()
        self._wall_origin = time.time()
        self._phase_name: Optional[str] = None
        self._phase_t0 = 0
        self._phase_args: Optional[Dict[str, Any]] = None

    # ---- clock -----------------------------------------------------------
    def _now_us(self) -> int:
        return int((time.perf_counter() - self._origin) * 1e6)

    # ---- public API ------------------------------------------------------
    def span(self, name: str, **args: Any):
        """Context manager timing one host-side region (dispatch, not
        device completion — see the module contract)."""
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, args or None)

    def phase(self, name: str, step: Optional[int] = None) -> None:
        """Close the open phase span (if any) and start ``name``. The
        trainer's ``_beat`` sites call this, so the span vocabulary IS
        the watchdog phase vocabulary."""
        if not self.enabled:
            return
        now = self._now_us()
        if self._phase_name is not None:
            self._emit(self._complete_event(
                self._phase_name, self._phase_t0, now - self._phase_t0,
                self._phase_args))
        self._phase_name = name
        self._phase_t0 = now
        self._phase_args = {"step": step} if step is not None else None

    def end_phase(self) -> None:
        """Close the open phase span without starting another (loop
        exit)."""
        if not self.enabled or self._phase_name is None:
            return
        now = self._now_us()
        self._emit(self._complete_event(
            self._phase_name, self._phase_t0, now - self._phase_t0,
            self._phase_args))
        self._phase_name = None
        self._phase_args = None

    def instant(self, name: str, **args: Any) -> None:
        if not self.enabled:
            return
        self._emit({
            "name": name, "ph": "i", "s": "p",
            "ts": self._now_us(),
            "pid": self.process_index, "tid": threading.get_ident() & 0xFFFF,
            "cat": "host", **({"args": args} if args else {}),
        })

    def counter(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        self._emit({
            "name": name, "ph": "C",
            "ts": self._now_us(),
            "pid": self.process_index, "tid": threading.get_ident() & 0xFFFF,
            "args": {"value": value},
        })

    # ---- request-scoped async events -------------------------------------
    # Chrome async events ("b"/"n"/"e") are keyed by (cat, id) rather
    # than by thread: every event sharing an id renders on ONE async
    # track no matter which thread emitted it, so a request's lifecycle
    # correlates across threads. The id is the request's trace_id; the
    # tid still records which thread emitted each event.

    def async_event(self, ph: str, name: str, trace_id: str,
                    **args: Any) -> None:
        """One async event: ``ph`` is ``"b"`` (begin), ``"e"`` (end —
        matched to its begin by (cat, id, name)) or ``"n"``
        (instant)."""
        if not self.enabled:
            return
        if ph not in ("b", "e", "n"):
            raise ValueError(f"async ph must be 'b'/'e'/'n', got {ph!r}")
        self._emit(self._async_event(ph, name, trace_id, args))

    def async_begin(self, name: str, trace_id: str, **args: Any) -> None:
        """Open one async span (``ph: "b"``) on the ``trace_id`` track."""
        self.async_event("b", name, trace_id, **args)

    def async_end(self, name: str, trace_id: str, **args: Any) -> None:
        """Close the matching ``async_begin``."""
        self.async_event("e", name, trace_id, **args)

    def async_instant(self, name: str, trace_id: str, **args: Any) -> None:
        """Point event on the ``trace_id`` track (``ph: "n"``)."""
        self.async_event("n", name, trace_id, **args)

    def _async_event(self, ph: str, name: str, trace_id: str,
                     args: Dict[str, Any]) -> dict:
        ev = {
            "name": name, "ph": ph, "cat": "request", "id": str(trace_id),
            "ts": self._now_us(),
            "pid": self.process_index, "tid": threading.get_ident() & 0xFFFF,
        }
        if args:
            ev["args"] = args
        return ev

    def tail(self, last_n: Optional[int] = None) -> List[dict]:
        """The newest retained events (crash-report / live-snapshot
        surface); independent of the trace file."""
        with self._lock:
            records = list(self._tail)
        if last_n is not None:
            records = records[-last_n:]
        return records

    def flush(self) -> None:
        if self._file is not None:
            with self._lock:
                if self._file is not None:
                    self._file.flush()

    def close(self) -> None:
        """Finish the open phase and terminate the trace file so it is
        valid JSON. Idempotent; the tracer stays readable (``tail``)
        but records nothing further."""
        self.end_phase()
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self.enabled = False
            if self._file is not None:
                if self.events_dropped:
                    # the promised drop record: a reader of a capped
                    # trace can see the timeline is incomplete and by
                    # how much
                    drop = {
                        "name": "events_dropped", "ph": "M",
                        "pid": self.process_index, "tid": 0,
                        "args": {"count": self.events_dropped},
                    }
                    prefix = "" if self._first_event else ",\n"
                    self._file.write(prefix + json.dumps(drop))
                self._file.write("\n]\n")
                self._file.close()
                self._file = None

    # ---- event plumbing --------------------------------------------------
    def _complete(self, name: str, t0_us: int,
                  args: Optional[Dict[str, Any]]) -> None:
        self._emit(self._complete_event(
            name, t0_us, self._now_us() - t0_us, args))

    def _complete_event(self, name: str, ts: int, dur: int,
                        args: Optional[Dict[str, Any]]) -> dict:
        ev = {
            "name": name, "ph": "X", "ts": ts, "dur": max(dur, 0),
            "pid": self.process_index, "tid": threading.get_ident() & 0xFFFF,
            "cat": "host",
        }
        if args:
            ev["args"] = args
        return ev

    def _emit(self, event: dict) -> None:
        with self._lock:
            if self._closed:
                return
            self._tail.append(event)
            if self.path is None:
                self.events_written += 1
                return
            if self.events_written >= self.max_events:
                self.events_dropped += 1
                return
            if self._file is None:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                self._file = open(self.path, "w")
                self._file.write("[\n")
                for meta in self._metadata_events():
                    self._file.write(json.dumps(meta) + ",\n")
            if not self._first_event:
                self._file.write(",\n")
            self._first_event = False
            self._file.write(json.dumps(event))
            self.events_written += 1

    def _metadata_events(self) -> List[dict]:
        return [
            {
                "name": "process_name", "ph": "M", "pid": self.process_index,
                "tid": 0,
                "args": {"name": f"scaletorch-{self.role}"
                                 f"-proc{self.process_index}"},
            },
            {
                "name": "trace_origin", "ph": "M", "pid": self.process_index,
                "tid": 0,
                "args": {"wall_time_origin": self._wall_origin,
                         "clock": "perf_counter_us"},
            },
        ]


def load_trace(path: str) -> List[dict]:
    """Read a trace file back as its event list — accepts both the
    closed (valid JSON) and the crashed (unterminated) form, the same
    leniency Perfetto applies."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        # unterminated array from a run that never reached close()
        text = text.rstrip().rstrip(",")
        return json.loads(text + "\n]")
