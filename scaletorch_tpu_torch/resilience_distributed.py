"""Resilience across the training loop's threads and processes: the
exit codes, the hang watchdog and crash reports (the single-process
subset of scaletorch_tpu/resilience_distributed.py).

  * ``CoordinatedResilience`` — the layer the trainer talks to for every
    control decision. The port runs one process, so it has no decision
    bus and takes its uncoordinated arms: ``coordinated`` is False and
    ``should_stop``, ``verify_agreement``, ``after_step``, ``counters``
    and ``straggler_counters`` pass through to the local
    ``ResilienceManager``.
  * ``HangWatchdog`` — a background heartbeat thread. The train loop (or
    the engine) beats it at each phase; if no beat lands within the
    timeout it dumps every Python thread's stack, writes a crash report
    and exits with ``WATCHDOG_EXIT_CODE`` so a launcher restarts the job
    instead of waiting forever. It can fire while the main thread is
    blocked in a CUDA synchronisation only if that wait releases the GIL.
  * ``write_crash_report`` — one JSON post-mortem per abort path
    (sentinel abort, rollback budget exhausted, watchdog fired).

``DecisionBus``, ``FileBus``, ``FileMembershipStore`` and
``ElasticCoordinator`` (the multi-process decisions and elastic
membership) wait for ROADMAP Queue 1 item 6.

Exit-code contract:

  * 0   — graceful, including a preempted run that saved its state
  * 42  — ``TrainingDivergedError`` (sentinel abort / budget exhausted)
  * 43  — hang watchdog fired (restartable: state is on disk up to the
          last periodic or emergency checkpoint)
  * 44  — serving stall watchdog fired (``inference/resilience.py``
          ``make_serving_watchdog``: a wedged ``InferenceEngine.step()``)
  * 130 — operator KeyboardInterrupt
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from scaletorch_tpu_torch.env import env_override
from scaletorch_tpu_torch.resilience import (
    ResilienceManager,
    TrainingDivergedError,
)
from scaletorch_tpu_torch.utils.logger import get_logger

DIVERGED_EXIT_CODE = 42
WATCHDOG_EXIT_CODE = 43
# a wedged InferenceEngine.step() (serving watchdog, inference/resilience.py)
SERVING_STALL_EXIT_CODE = 44


# --------------------------------------------------------------------------
# Decisions
# --------------------------------------------------------------------------


def hang_timeout_from_config(cfg) -> float:
    return float(env_override(
        "SCALETORCH_TPU_FT_HANG_TIMEOUT",
        getattr(cfg, "ft_hang_timeout", 0.0),
    ))


def coordinate_from_config(cfg) -> bool:
    return bool(env_override(
        "SCALETORCH_TPU_FT_COORDINATE",
        getattr(cfg, "ft_coordinate", True),
    ))


class CoordinatedResilience:
    """The control-decision layer over ``ResilienceManager``.

    With one process there is no fleet to agree with, so every method
    takes the reference's uncoordinated arm: a transparent pass-through
    to the local manager. ``enabled`` keeps the ``ft_coordinate`` knob;
    ``straggler`` stays None (the detector rides the multi-process
    observation gather, ROADMAP Queue 1 item 6).
    """

    def __init__(self, manager: ResilienceManager, *,
                 enabled: bool = True) -> None:
        self.manager = manager
        self.enabled = enabled
        self.straggler = None

    @classmethod
    def from_config(cls, cfg, manager: ResilienceManager
                    ) -> "CoordinatedResilience":
        return cls(manager, enabled=coordinate_from_config(cfg))

    @property
    def coordinated(self) -> bool:
        return False

    def should_stop(self) -> bool:
        """The stop poll at a step boundary: this process's preemption
        request."""
        return self.manager.stop_requested

    def verify_agreement(self, name: str, value: Any) -> None:
        """Every process holds the same ``value``: trivially true for
        one."""
        return None

    def after_step(
        self,
        step: int,
        metrics: Dict[str, Any],
        *,
        rollback: Optional[Callable[[], bool]] = None,
        position: Optional[int] = None,
        telemetry: Optional[Dict[str, Any]] = None,
    ) -> tuple:
        """``ResilienceManager.after_step``'s ``(metrics, action)``;
        ``position`` and ``telemetry`` are what a coordinated run
        gathers across processes, unused with one."""
        return self.manager.after_step(step, metrics, rollback=rollback)

    def counters(self) -> Dict[str, float]:
        return self.manager.counters()

    def straggler_counters(self) -> Dict[str, float]:
        """Straggler counters for the metrics extras: {} without a
        detector attached, as on every one-process run."""
        if self.straggler is None:
            return {}
        return self.straggler.counters()


# --------------------------------------------------------------------------
# Hang watchdog
# --------------------------------------------------------------------------


def dump_thread_stacks() -> Dict[str, str]:
    """Formatted Python stacks of every live thread, keyed by name —
    the first thing a hang post-mortem needs (which frame is sitting
    inside the wedged wait?)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, str] = {}
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, f"thread-{ident}")
        out[name] = "".join(traceback.format_stack(frame))
    return out


class HangWatchdog:
    """Background heartbeat monitor: no ``beat()`` within ``timeout``
    seconds → dump thread stacks + crash report, then ``exit_fn(43)``.

    The default ``exit_fn`` is ``os._exit`` on purpose: a hang usually
    means the main thread is wedged (a dead device, a stuck read), and a
    polite ``sys.exit`` from a daemon thread would never unwind it —
    the launcher's restart policy is the recovery path, and state is on
    disk up to the last checkpoint. Tests inject a recorder instead.

    The watchdog is a Python thread, so it runs only when the main thread
    releases the GIL; a CUDA synchronisation (``torch.cuda.synchronize``,
    ``.item()``) releases it while it waits.
    """

    def __init__(
        self,
        timeout: float,
        *,
        poll_interval: Optional[float] = None,
        crash_report: Optional[Callable[[dict], Optional[str]]] = None,
        exit_fn: Callable[[int], None] = os._exit,
        exit_code: int = WATCHDOG_EXIT_CODE,
    ) -> None:
        if timeout <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got {timeout}")
        self.timeout = timeout
        self.poll_interval = (
            poll_interval if poll_interval is not None
            else max(0.05, min(timeout / 4.0, 5.0))
        )
        self.crash_report = crash_report
        self.exit_fn = exit_fn
        self.exit_code = exit_code
        self.fired = False
        self.last_step: Optional[int] = None
        self.last_phase: str = "start"
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self, step: Optional[int] = None, phase: str = "step") -> None:
        """Record progress (cheap; called from the train loop's phases)."""
        if step is not None:
            self.last_step = step
        self.last_phase = phase
        self._last_beat = time.monotonic()

    def start(self) -> "HangWatchdog":
        self._last_beat = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="scaletorch-hang-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, self.poll_interval * 4))
            self._thread = None

    def __enter__(self) -> "HangWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            stalled = time.monotonic() - self._last_beat
            if stalled < self.timeout:
                continue
            self.fired = True
            info = {
                "reason": (
                    f"hang watchdog: no training progress for "
                    f"{stalled:.1f}s (timeout {self.timeout:g}s); last "
                    f"phase {self.last_phase!r} at step {self.last_step}"
                ),
                "step": self.last_step,
                "phase": self.last_phase,
                "stalled_seconds": stalled,
                "timeout": self.timeout,
                "exit_code": self.exit_code,
                "thread_stacks": dump_thread_stacks(),
            }
            get_logger().error(info["reason"])
            if self.crash_report is not None:
                try:
                    self.crash_report(info)  # logs its own path
                except Exception as exc:  # the exit below must still run
                    get_logger().error(f"crash report failed: {exc!r}")
            self.exit_fn(self.exit_code)
            return  # injected exit_fn (tests) does not terminate us


# --------------------------------------------------------------------------
# Crash reports
# --------------------------------------------------------------------------


def config_fingerprint(cfg) -> Dict[str, Any]:
    """Stable digest + the identity fields a post-mortem reads first."""
    try:
        import dataclasses as _dc

        d = {k: repr(v) for k, v in sorted(_dc.asdict(cfg).items())}
    except Exception:
        d = {"repr": repr(cfg)}
    digest = hashlib.sha256(
        json.dumps(d, sort_keys=True).encode()
    ).hexdigest()[:16]
    keys = ("model_type", "total_train_steps", "seed", "divergence_policy",
            "data_parallel_size", "tensor_parallel_size",
            "pipeline_parallel_size", "context_parallel_size",
            "expert_parallel_size")
    return {
        "sha256": digest,
        **{k: getattr(cfg, k) for k in keys if hasattr(cfg, k)},
    }


def write_crash_report(
    reason: str,
    step: Optional[int],
    *,
    directory: str = "results",
    config: Any = None,
    monitor_records: Optional[List[dict]] = None,
    last_metrics: Optional[List[dict]] = None,
    counters: Optional[Dict[str, float]] = None,
    thread_stacks: Optional[Dict[str, str]] = None,
    span_tail: Optional[List[dict]] = None,
    process_index: int = 0,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Persist a JSON post-mortem; returns the path. Never raises to the
    caller's caller — an abort path must abort, not crash inside its own
    diagnostics (I/O errors are logged and an empty path returned).
    ``span_tail`` is the telemetry tracer's newest span events — the
    host-side timeline right up to the fault, next to the monitor ring
    buffer."""
    suffix = f"_proc{process_index}" if process_index else ""
    path = os.path.join(
        directory, f"crash_report_step{step if step is not None else 'NA'}"
        f"{suffix}.json"
    )
    report = {
        "reason": reason,
        "step": step,
        "time": time.time(),
        "process_index": process_index,
        "config_fingerprint": (
            config_fingerprint(config) if config is not None else None
        ),
        "counters": counters or {},
        "last_metrics": last_metrics or [],
        "monitor_records": monitor_records or [],
        "span_timeline_tail": span_tail or [],
        "thread_stacks": thread_stacks or {},
        **(extra or {}),
    }
    try:
        os.makedirs(directory, exist_ok=True)
        with open(path, "w") as f:
            json.dump(report, f, indent=1, default=repr)
    except OSError as exc:
        get_logger().error(f"could not write crash report {path}: {exc!r}")
        return ""
    get_logger().error(f"crash report written to {path}")
    return path
