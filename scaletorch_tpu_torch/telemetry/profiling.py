"""Anomaly-triggered device profiling and live snapshots (counterpart of
scaletorch_tpu/telemetry/profiling.py).

Host-side spans (telemetry/spans.py) show where the *host* spent time;
when a step is anomalously slow the question is what the *card* was
doing, and by the time an operator attaches a profiler by hand the
anomaly is gone. Three pieces:

  * ``SlowStepDetector`` — a step-wall-time EMA and spike factor (the
    DivergenceSentinel's shape): a step slower than ``spike_factor`` x
    its EMA is an anomaly; anomalous times never feed the EMA.
  * ``AnomalyProfiler`` — arms a BOUNDED profiler window over the next
    ``window_steps`` steps when the detector fires (at most
    ``max_captures`` per run), and takes a manual ``--profile_steps
    start:stop`` window. Captures land under ``<telemetry_dir>/
    profiles/``.
  * ``LiveSnapshotter`` — a SIGUSR1 handler that dumps the span tail, the
    monitor ring buffer and every thread's stack to a JSON file without
    stopping the run. It reads host-side state only.

The default backend is ``TorchProfilerBackend``: ``torch.profiler`` with
the CPU and CUDA activities, a Chrome trace per window. On an H100 the
trace drops the device records of the first kernels it sees and can drop
those of the last ones, so the backend launches ``PAD_KERNELS`` small
kernels before and after the window (traced and left out), reads only
the calls inside its window span, and reports the launches whose record
is still missing (``launches_lost``) with a warning: a window is never
read short in silence. The backend is injectable (tests use a recording
fake).
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from scaletorch_tpu_torch.utils.logger import get_logger


def parse_profile_steps(spec: str) -> Optional[Tuple[int, int]]:
    """``"start:stop"`` -> (start, stop) with 1 <= start < stop; "" ->
    None. The window is [start, stop): profiling starts when step
    ``start`` begins and stops when step ``stop`` begins."""
    if not spec:
        return None
    parts = spec.split(":")
    try:
        if len(parts) != 2:
            raise ValueError
        start, stop = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"profile_steps must be 'start:stop' (integers), got {spec!r}"
        ) from None
    if start < 1 or stop <= start:
        raise ValueError(
            f"profile_steps needs 1 <= start < stop, got {spec!r}"
        )
    return start, stop


class SlowStepDetector:
    """Step-time EMA + spike factor (the DivergenceSentinel shape,
    pointed at wall time instead of loss)."""

    def __init__(self, spike_factor: float, *, ema_beta: float = 0.9,
                 warmup_steps: int = 1) -> None:
        if spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must be > 1, got {spike_factor}"
            )
        if not 0.0 <= ema_beta < 1.0:
            raise ValueError(f"ema_beta must be in [0, 1), got {ema_beta}")
        self.spike_factor = spike_factor
        self.ema_beta = ema_beta
        self.warmup_steps = warmup_steps
        self.ema: Optional[float] = None
        self.observed = 0
        self.spikes = 0

    def observe(self, step_time: float) -> bool:
        """Feed one step's wall time; True when it spiked. The first
        ``warmup_steps`` observations are DISCARDED entirely — a cold
        first step (kernel builds and loads, allocator warm-up) is orders
        of magnitude over steady state
        and would poison the baseline if it seeded the EMA; the next
        observation seeds it. Anomalous times never feed the EMA."""
        self.observed += 1
        if self.observed <= self.warmup_steps:
            return False
        if self.ema is None:
            self.ema = step_time
            return False
        if step_time > self.spike_factor * self.ema:
            self.spikes += 1
            return True
        self.ema = self.ema_beta * self.ema + (1 - self.ema_beta) * step_time
        return False


# kernel-launch calls of the runtime and driver APIs: each leaves one
# device record carrying its correlation id
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx")
# small kernels launched (and synchronised) before and after a window,
# outside its span: they take the head and tail records a trace drops
PAD_KERNELS = 64
WINDOW_SPAN = "telemetry.profile_window"


def window_records(events, span: str = WINDOW_SPAN) -> Dict[str, Any]:
    """The device records of the calls made inside the ``span`` span of a
    ``torch.profiler`` trace (``prof.profiler.kineto_results.events()``):
    kernels and device µs in all and by kernel name, the kernel launches
    made (``LAUNCH_APIS`` calls) and those with no device record
    (``launches_lost``). A graph replay's kernels are counted as
    recorded; a replay that lost some is not detected here."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type() != cuda]
    marks = [e for e in host if e.name() == span]
    lo, hi = (marks[0].start_ns(), marks[0].end_ns()) if marks else (0, -1)
    calls = [e for e in host if lo <= e.start_ns() <= hi
             and e.name().startswith("cu")]
    made = {e.correlation_id() for e in calls}
    launches = {e.correlation_id() for e in calls if e.name() in LAUNCH_APIS}
    recorded, by_name, device_ns = set(), {}, 0
    for e in events:
        if (e.device_type() == cuda and not e.is_user_annotation()
                and e.correlation_id() in made):
            recorded.add(e.correlation_id())
            by_name[e.name()] = by_name.get(e.name(), 0) + 1
            device_ns += e.duration_ns()
    return {"kernels": sum(by_name.values()), "device_us": 1e-3 * device_ns,
            "launches": len(launches),
            "launches_lost": len(launches - recorded), "by_name": by_name}


class TorchProfilerBackend:
    """Start/stop adapter over ``torch.profiler`` (imported when a window
    starts). ``start`` waits for the card, opens the profile (CPU, and
    CUDA when the card is there), launches ``PAD_KERNELS`` kernels, waits
    and opens the window span; ``stop`` waits, closes the span, launches
    the trailing pad, waits, closes the profile, writes ``trace.json``
    (Chrome trace) and ``window.json`` (``window_records`` plus the
    seconds ``start`` and ``stop`` took) into the window's directory, and
    returns the ``window_records``."""

    def __init__(self) -> None:
        self._prof = None
        self._span = None
        self._dir: Optional[str] = None
        self._start_s = 0.0

    @staticmethod
    def _cuda() -> bool:
        import torch

        return torch.cuda.is_available() and torch.cuda.is_initialized()

    def _pad(self) -> None:
        import torch

        if self._cuda():
            x = torch.zeros(1, device="cuda")
            for _ in range(PAD_KERNELS):
                x.add_(1)
            torch.cuda.synchronize()

    def start(self, log_dir: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        t0 = time.perf_counter()
        cuda = self._cuda()
        if cuda:
            torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._pad()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self._dir = log_dir
        self._start_s = time.perf_counter() - t0

    def stop(self) -> Dict[str, Any]:
        import torch

        t0 = time.perf_counter()
        prof, self._prof = self._prof, None
        if self._cuda():
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._span = None
        self._pad()
        prof.__exit__(None, None, None)
        stop_s = time.perf_counter() - t0
        records = window_records(prof.profiler.kineto_results.events())
        prof.export_chrome_trace(os.path.join(self._dir, "trace.json"))
        records.update(start_s=self._start_s, stop_s=stop_s)
        with open(os.path.join(self._dir, "window.json"), "w") as f:
            json.dump(records, f, indent=1)
        return records


class AnomalyProfiler:
    """Bounded profiler capture windows, armed by slow steps or a manual
    step range.

    Call ``before_step(step)`` at the loop boundary (the step about to
    run) and ``after_step(step, step_time)`` once it finishes; both are
    single-branch no-ops while nothing is armed. A detector fire arms a
    window over the next ``window_steps`` steps; the manual window
    ``profile_steps=(start, stop)`` covers [start, stop). Windows never
    overlap and anomaly captures are capped at ``max_captures``.
    ``captures`` records every window (trigger, steps, directory, and
    whatever the backend's ``stop`` returned: ``TorchProfilerBackend``'s
    kernel records and ``launches_lost``) for logs and tests.
    """

    def __init__(
        self,
        telemetry_dir: str,
        *,
        window_steps: int = 3,
        spike_factor: float = 0.0,
        max_captures: int = 1,
        profile_steps: Optional[Tuple[int, int]] = None,
        backend: Optional[Any] = None,
    ) -> None:
        if window_steps < 1:
            raise ValueError(f"window_steps must be >= 1, got {window_steps}")
        self.telemetry_dir = telemetry_dir
        self.window_steps = window_steps
        self.max_captures = max_captures
        self.profile_steps = profile_steps
        self.detector = (
            SlowStepDetector(spike_factor) if spike_factor else None
        )
        self._backend = (backend if backend is not None
                         else TorchProfilerBackend())
        self.captures: List[Dict[str, Any]] = []
        self._active: Optional[Dict[str, Any]] = None
        self._anomaly_captures = 0
        self._manual_done = False
        self._broken = False

    @property
    def active(self) -> bool:
        return self._active is not None

    def before_step(self, step: int) -> None:
        """Boundary hook, called with the step about to run: opens the
        manual window at its start step and closes any window whose
        stop step arrived."""
        if self._active is not None and step >= self._active["stop_step"]:
            self._stop()
        if (self.profile_steps is not None and not self._manual_done
                and self._active is None):
            start, stop = self.profile_steps
            # >= not ==: a resumed run whose global step already passed
            # `start` still captures the remainder of the window (and a
            # window entirely in the past warns instead of silently
            # never firing).
            if step >= stop:
                self._manual_done = True
                get_logger().warning(
                    f"--profile_steps {start}:{stop} window is already "
                    f"past at step {step} (resumed run?): no manual "
                    f"capture will be taken"
                )
            elif step >= start:
                self._manual_done = True
                self._start("manual", step, stop)

    def after_step(self, step: int, step_time: float) -> None:
        """Per-step hook: feeds the slow-step detector and arms an
        anomaly window over the next ``window_steps`` steps when it
        fires (bounded by ``max_captures``)."""
        if self._active is not None:
            if step + 1 >= self._active["stop_step"]:
                self._stop()
            return
        if self.detector is None:
            return
        spiked = self.detector.observe(step_time)
        if (spiked and self._anomaly_captures < self.max_captures
                and not self._broken):
            self._anomaly_captures += 1
            get_logger().warning(
                f"slow step detected at step {step} "
                f"({step_time:.3f}s > {self.detector.spike_factor:g}x EMA "
                f"{self.detector.ema:.3f}s): profiling the next "
                f"{self.window_steps} steps"
            )
            self._start("slow_step", step + 1, step + 1 + self.window_steps)

    def close(self) -> None:
        """Stop an in-flight window (run ended mid-capture)."""
        if self._active is not None:
            self._stop()

    # ---- window mechanics ------------------------------------------------
    def _start(self, trigger: str, start_step: int, stop_step: int) -> None:
        log_dir = os.path.join(
            self.telemetry_dir, "profiles", f"{trigger}_step{start_step}"
        )
        try:
            os.makedirs(log_dir, exist_ok=True)
            self._backend.start(log_dir)
        except Exception as exc:
            # profiling is diagnostics, never a crash reason — degrade
            # and stop re-arming (a broken backend would fail every time)
            self._broken = True
            get_logger().warning(f"profiler capture unavailable: {exc!r}")
            return
        self._active = {
            "trigger": trigger, "start_step": start_step,
            "stop_step": stop_step, "dir": log_dir,
        }

    def _stop(self) -> None:
        window = self._active
        self._active = None
        try:
            records = self._backend.stop()
        except Exception as exc:
            self._broken = True
            get_logger().warning(f"profiler stop failed: {exc!r}")
            return
        if isinstance(records, dict):
            window.update(records)
            if records.get("launches_lost"):
                get_logger().warning(
                    f"profiler window {window['dir']} lost the device "
                    f"records of {records['launches_lost']} of "
                    f"{records['launches']} kernel launches: its device "
                    "time reads low")
        self.captures.append(window)
        get_logger().info(
            f"profiler window captured: steps "
            f"[{window['start_step']}, {window['stop_step']}) "
            f"({window['trigger']}) -> {window['dir']}"
        )


class LiveSnapshotter:
    """SIGUSR1 -> dump a live post-mortem WITHOUT stopping the run.

    The handler runs in the main thread between bytecodes (CPython
    signal semantics), writes
    ``<telemetry_dir>/live_snapshot_<n>.json`` — the ``snapshot_fn``
    payload (span tail, monitor ring buffer, counters, current step)
    plus every thread's stack — and returns. Install/uninstall are
    no-ops off the main thread or where SIGUSR1 does not exist, so
    tests and notebook embeddings never crash on it."""

    def __init__(self, telemetry_dir: str,
                 snapshot_fn: Optional[Callable[[], dict]] = None) -> None:
        self.telemetry_dir = telemetry_dir
        self.snapshot_fn = snapshot_fn
        self.snapshots_written = 0
        self._prev_handler: Any = None
        self._installed = False

    def install(self, snapshot_fn: Optional[Callable[[], dict]] = None) -> bool:
        if snapshot_fn is not None:
            self.snapshot_fn = snapshot_fn
        if self._installed:
            return True
        signum = getattr(signal, "SIGUSR1", None)
        if signum is None:
            return False
        try:
            self._prev_handler = signal.signal(signum, self._handle)
        except ValueError:
            # not the main thread (e.g. a worker harness): no handler
            return False
        self._installed = True
        return True

    def uninstall(self) -> None:
        if not self._installed:
            return
        try:
            signal.signal(signal.SIGUSR1, self._prev_handler or signal.SIG_DFL)
        except ValueError:
            pass
        self._installed = False

    def _handle(self, signum, frame) -> None:
        # local import keeps module load light; dump_thread_stacks is
        # pure-Python introspection, safe in a handler context
        from scaletorch_tpu_torch.resilience_distributed import (
            dump_thread_stacks,
        )

        payload: Dict[str, Any] = {"time": time.time()}
        try:
            if self.snapshot_fn is not None:
                payload.update(self.snapshot_fn())
        except Exception as exc:  # a snapshot must never kill the run
            payload["snapshot_error"] = repr(exc)
        payload["thread_stacks"] = dump_thread_stacks()
        self.snapshots_written += 1
        path = os.path.join(
            self.telemetry_dir, f"live_snapshot_{self.snapshots_written}.json"
        )
        try:
            os.makedirs(self.telemetry_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(payload, f, indent=1, default=repr)
        except OSError as exc:
            get_logger().error(f"live snapshot failed: {exc!r}")
            return
        get_logger().info(f"live snapshot written to {path}")

    # context-manager sugar for tests / serving loops
    def __enter__(self) -> "LiveSnapshotter":
        self.install()
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()
