"""Serving resilience (counterpart of scaletorch_tpu/inference/
resilience.py): terminal outcomes, fault injection and the stall
watchdog of ``InferenceEngine``.

  * a **terminal-outcome taxonomy** — every submitted request ends in
    exactly ONE of ``TERMINAL_OUTCOMES``; the engine keeps
    ``requests_submitted == sum(outcomes)`` once drained:

      - ``ok``          finished normally (eos / length / max_seq)
      - ``timeout``     per-request deadline exceeded, queued or
                        mid-decode; partial tokens are attached
      - ``shed``        dropped oldest-first by bounded admission
      - ``rejected``    failed validation at submit under
                        ``strict_submit=False``
      - ``quarantined`` the slot's logits went non-finite; the slot is
                        retired, its cache lines cleared, and the engine
                        keeps serving the other slots
      - ``aborted``     the engine gave up: ``run(max_steps)``
                        exhausted, ``drain()``, or ``cancel()``

  * ``ServingFaultInjector`` — config/env-driven serving faults (NaN
    logits at a decode step, a slow decode, a submit storm, a deadline
    storm), and the gateway drills' counters (``take_gw_*``), which the
    serving gateway reads (ROADMAP Queue 1 item 8).

  * ``make_serving_watchdog`` — ``HangWatchdog`` pointed at the engine: a
    stalled ``step()`` writes a crash report with the engine's counters
    and span tail and exits ``SERVING_STALL_EXIT_CODE`` (44).

Graceful drain lives on the engine (``InferenceEngine.drain``), wired to
the training stack's ``PreemptionHandler``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Optional

from scaletorch_tpu_torch.env import env_override
from scaletorch_tpu_torch.resilience_distributed import (
    SERVING_STALL_EXIT_CODE,
    HangWatchdog,
    write_crash_report,
)
from scaletorch_tpu_torch.utils.logger import get_logger

__all__ = [
    "TERMINAL_OUTCOMES",
    "EngineDraining",
    "ServingFaultInjector",
    "SERVING_STALL_EXIT_CODE",
    "make_serving_watchdog",
]

# Every submitted request ends in exactly one of these (RequestResult
# .outcome); the engine's conservation invariant sums over them.
TERMINAL_OUTCOMES = (
    "ok", "timeout", "shed", "rejected", "quarantined", "aborted",
)


class EngineDraining(RuntimeError):
    """Raised by ``submit()`` (strict mode) once ``drain()`` has stopped
    admissions — the serving loop is shutting down."""


# --------------------------------------------------------------------------
# Fault injection
# --------------------------------------------------------------------------


@dataclass
class ServingFaultInjector:
    """Config/env-driven serving fault hooks. All knobs default to off (0).

    Steps are DECODE steps, 1-based: ``at_step == k`` fires on the tick
    that runs the k-th decode step of the engine's lifetime.

    * ``nan_logits_at_step`` / ``nan_logits_slot`` — before decode step
      k, fill slot ``nan_logits_slot``'s KV-cache lines with NaN so its
      logits go non-finite that step (a poison request), driving the
      quarantine path. The write is the quarantine's in-place masked
      fill (``make_fill_slots_step``): the captured steps' buffers keep
      their storage, so nothing is captured again.
    * ``slow_decode_at_step`` / ``slow_decode_seconds`` — stall the
      engine once before decode step k, simulating a wedged device
      dispatch for the serving watchdog.
    * ``submit_storm_at_step`` / ``submit_storm_count`` — inject a burst
      of n one-token requests at step k, driving bounded admission and
      oldest-first shedding.
    * ``deadline_storm_at_step`` — force every in-flight request's
      deadline (queued and mid-decode) into the past at step k, driving
      the ``timeout`` paths at admission and decode.

    Gateway drills (serving/gateway.py; the counting unit is HTTP
    requests, 1-based, not decode steps — the gateway is upstream of
    the engine's tick clock):

    * ``gw_tenant_storm_at`` / ``gw_tenant_storm_count`` — when the k-th
      generate request arrives, one synthetic tenant (``storm``) floods
      the admission queue with n requests, driving weighted-fair
      queueing (the victim tenants keep their WFQ share) and
      shed-before-latency backpressure (HTTP 429 + Retry-After).
    * ``gw_replica_down_at`` — when the k-th request is DISPATCHED to a
      replica, the router marks that replica dead mid-stream (exit-code
      contract, as if it exited 43/44): its in-flight requests end
      ``aborted``, queued requests re-route to the surviving replicas.
    * ``gw_replica_crash_at`` — when the k-th request is DISPATCHED,
      SIGKILL that replica's child process (``worker.kill()``; an
      in-process worker degrades to thread death). Nothing is
      announced: the gateway must OBSERVE the crash — the reader
      threads synthesize the ``aborted`` terminals, the poller flips
      liveness, the supervisor restarts the child with backoff.
    * ``gw_replica_hang_at`` — when the k-th request is DISPATCHED,
      stall that replica's step loop (``worker.stall()``): no ticks,
      no watchdog beats, so its armed serving watchdog fires exit 44
      and the supervisor treats it as a crash.

    Env overrides (present-wins, the ``env.env_override`` contract
    shared with the training ``FaultInjector``):
    ``SCALETORCH_TPU_FT_SERVE_NAN_STEP``, ``.._SERVE_NAN_SLOT``,
    ``.._SERVE_SLOW_STEP``, ``.._SERVE_SLOW_SECONDS``,
    ``.._SERVE_SUBMIT_STORM_STEP``, ``.._SERVE_SUBMIT_STORM_COUNT``,
    ``.._SERVE_DEADLINE_STORM_STEP``; gateway:
    ``SCALETORCH_TPU_FT_GW_TENANT_STORM_AT``,
    ``.._GW_TENANT_STORM_COUNT``, ``.._GW_REPLICA_DOWN_AT``,
    ``.._GW_REPLICA_CRASH_AT``, ``.._GW_REPLICA_HANG_AT``,
    ``.._GW_WARM_DONOR_CRASH_AT``, ``.._GW_WARM_CORRUPT_CHUNK_AT``.
    """

    nan_logits_at_step: int = 0
    nan_logits_slot: int = 0
    slow_decode_at_step: int = 0
    slow_decode_seconds: float = 30.0
    submit_storm_at_step: int = 0
    submit_storm_count: int = 8
    deadline_storm_at_step: int = 0
    gw_tenant_storm_at: int = 0
    gw_tenant_storm_count: int = 8
    gw_replica_down_at: int = 0
    gw_replica_crash_at: int = 0
    gw_replica_hang_at: int = 0
    gw_warm_donor_crash_at: int = 0
    gw_warm_corrupt_chunk_at: int = 0
    _nan_fired: bool = field(default=False, repr=False)
    _slow_fired: bool = field(default=False, repr=False)
    _storm_fired: bool = field(default=False, repr=False)
    _deadline_fired: bool = field(default=False, repr=False)
    _gw_storm_fired: bool = field(default=False, repr=False)
    _gw_down_fired: bool = field(default=False, repr=False)
    _gw_crash_fired: bool = field(default=False, repr=False)
    _gw_hang_fired: bool = field(default=False, repr=False)
    _gw_warm_crash_fired: bool = field(default=False, repr=False)
    _gw_warm_corrupt_fired: bool = field(default=False, repr=False)

    @classmethod
    def from_config(cls, cfg) -> "ServingFaultInjector":
        def env_or(name: str, cfg_field: str, default):
            return env_override(name, getattr(cfg, cfg_field, default))

        return cls(
            nan_logits_at_step=int(env_or(
                "SCALETORCH_TPU_FT_SERVE_NAN_STEP",
                "ft_serve_nan_at_step", 0)),
            nan_logits_slot=int(env_or(
                "SCALETORCH_TPU_FT_SERVE_NAN_SLOT",
                "ft_serve_nan_slot", 0)),
            slow_decode_at_step=int(env_or(
                "SCALETORCH_TPU_FT_SERVE_SLOW_STEP",
                "ft_serve_slow_at_step", 0)),
            slow_decode_seconds=float(env_or(
                "SCALETORCH_TPU_FT_SERVE_SLOW_SECONDS",
                "ft_serve_slow_seconds", 30.0)),
            submit_storm_at_step=int(env_or(
                "SCALETORCH_TPU_FT_SERVE_SUBMIT_STORM_STEP",
                "ft_serve_submit_storm_at_step", 0)),
            submit_storm_count=int(env_or(
                "SCALETORCH_TPU_FT_SERVE_SUBMIT_STORM_COUNT",
                "ft_serve_submit_storm_count", 8)),
            deadline_storm_at_step=int(env_or(
                "SCALETORCH_TPU_FT_SERVE_DEADLINE_STORM_STEP",
                "ft_serve_deadline_storm_at_step", 0)),
            gw_tenant_storm_at=int(env_or(
                "SCALETORCH_TPU_FT_GW_TENANT_STORM_AT",
                "ft_gw_tenant_storm_at", 0)),
            gw_tenant_storm_count=int(env_or(
                "SCALETORCH_TPU_FT_GW_TENANT_STORM_COUNT",
                "ft_gw_tenant_storm_count", 8)),
            gw_replica_down_at=int(env_or(
                "SCALETORCH_TPU_FT_GW_REPLICA_DOWN_AT",
                "ft_gw_replica_down_at", 0)),
            gw_replica_crash_at=int(env_or(
                "SCALETORCH_TPU_FT_GW_REPLICA_CRASH_AT",
                "ft_gw_replica_crash_at", 0)),
            gw_replica_hang_at=int(env_or(
                "SCALETORCH_TPU_FT_GW_REPLICA_HANG_AT",
                "ft_gw_replica_hang_at", 0)),
            gw_warm_donor_crash_at=int(env_or(
                "SCALETORCH_TPU_FT_GW_WARM_DONOR_CRASH_AT",
                "ft_gw_warm_donor_crash_at", 0)),
            gw_warm_corrupt_chunk_at=int(env_or(
                "SCALETORCH_TPU_FT_GW_WARM_CORRUPT_CHUNK_AT",
                "ft_gw_warm_corrupt_chunk_at", 0)),
        )

    @property
    def active(self) -> bool:
        return bool(self.nan_logits_at_step or self.slow_decode_at_step
                    or self.submit_storm_at_step
                    or self.deadline_storm_at_step
                    or self.gw_tenant_storm_at
                    or self.gw_replica_down_at
                    or self.gw_replica_crash_at
                    or self.gw_replica_hang_at
                    or self.gw_warm_donor_crash_at
                    or self.gw_warm_corrupt_chunk_at)

    def take_nan_logits(self, step: int) -> Optional[int]:
        """Slot index to poison before decode step ``step``, or None."""
        if self.nan_logits_at_step and step == self.nan_logits_at_step \
                and not self._nan_fired:
            self._nan_fired = True
            get_logger().warning(
                f"serving fault injection: NaN logits in slot "
                f"{self.nan_logits_slot} at decode step {step}"
            )
            return max(0, self.nan_logits_slot)
        return None

    def take_slow_decode(self, step: int) -> float:
        """Seconds to stall before decode step ``step`` (0 = no stall)."""
        if self.slow_decode_at_step and step == self.slow_decode_at_step \
                and not self._slow_fired:
            self._slow_fired = True
            get_logger().warning(
                f"serving fault injection: stalling {self.slow_decode_seconds:g}s "
                f"before decode step {step}"
            )
            return self.slow_decode_seconds
        return 0.0

    def take_submit_storm(self, step: int) -> int:
        """Number of storm requests to inject at step ``step``."""
        if self.submit_storm_at_step and step == self.submit_storm_at_step \
                and not self._storm_fired:
            self._storm_fired = True
            get_logger().warning(
                f"serving fault injection: submit storm of "
                f"{self.submit_storm_count} requests at decode step {step}"
            )
            return max(0, self.submit_storm_count)
        return 0

    def take_deadline_storm(self, step: int) -> bool:
        """True when every in-flight deadline must be forced expired."""
        if self.deadline_storm_at_step \
                and step == self.deadline_storm_at_step \
                and not self._deadline_fired:
            self._deadline_fired = True
            get_logger().warning(
                f"serving fault injection: deadline storm at decode "
                f"step {step}"
            )
            return True
        return False

    def take_gw_tenant_storm(self, http_request: int) -> int:
        """Number of storm-tenant requests the gateway must inject when
        the ``http_request``-th (1-based) generate request arrives."""
        if self.gw_tenant_storm_at \
                and http_request == self.gw_tenant_storm_at \
                and not self._gw_storm_fired:
            self._gw_storm_fired = True
            get_logger().warning(
                f"gateway fault injection: tenant storm of "
                f"{self.gw_tenant_storm_count} requests at HTTP request "
                f"{http_request}"
            )
            return max(0, self.gw_tenant_storm_count)
        return 0

    def take_gw_replica_down(self, dispatch: int) -> bool:
        """True when the replica receiving the ``dispatch``-th (1-based)
        routed request must be marked dead mid-stream."""
        if self.gw_replica_down_at \
                and dispatch == self.gw_replica_down_at \
                and not self._gw_down_fired:
            self._gw_down_fired = True
            get_logger().warning(
                f"gateway fault injection: marking the routed replica "
                f"dead at dispatch {dispatch}"
            )
            return True
        return False

    def take_gw_replica_crash(self, dispatch: int) -> bool:
        """True when the replica receiving the ``dispatch``-th (1-based)
        routed request must be SIGKILL'd (process fleet) / thread-killed
        (in-process) — the crash the gateway must survive by observation
        alone."""
        if self.gw_replica_crash_at \
                and dispatch == self.gw_replica_crash_at \
                and not self._gw_crash_fired:
            self._gw_crash_fired = True
            get_logger().warning(
                f"gateway fault injection: killing the routed replica's "
                f"process at dispatch {dispatch}"
            )
            return True
        return False

    def take_gw_replica_hang(self, dispatch: int) -> bool:
        """True when the replica receiving the ``dispatch``-th (1-based)
        routed request must stall its step loop (the serving watchdog
        should fire exit 44)."""
        if self.gw_replica_hang_at \
                and dispatch == self.gw_replica_hang_at \
                and not self._gw_hang_fired:
            self._gw_hang_fired = True
            get_logger().warning(
                f"gateway fault injection: stalling the routed replica's "
                f"step loop at dispatch {dispatch}"
            )
            return True
        return False

    def take_gw_warm_donor_crash(self, chunk: int) -> bool:
        """True when the donor replica must SIGKILL itself after
        streaming the ``chunk``-th (1-based) warm-transfer frame — the
        mid-transfer donor death the recipient must survive by falling
        back to the next peer (or a cold rejoin)."""
        if self.gw_warm_donor_crash_at \
                and chunk == self.gw_warm_donor_crash_at \
                and not self._gw_warm_crash_fired:
            self._gw_warm_crash_fired = True
            get_logger().warning(
                f"gateway fault injection: donor self-SIGKILL after "
                f"warm-transfer chunk {chunk}"
            )
            return True
        return False

    def take_gw_warm_corrupt_chunk(self, chunk: int) -> bool:
        """True when the donor must flip bytes in the ``chunk``-th
        (1-based) warm-transfer frame AFTER checksumming it — the
        recipient must detect the mismatch, drop that chunk, and keep
        the rest of the stream."""
        if self.gw_warm_corrupt_chunk_at \
                and chunk == self.gw_warm_corrupt_chunk_at \
                and not self._gw_warm_corrupt_fired:
            self._gw_warm_corrupt_fired = True
            get_logger().warning(
                f"gateway fault injection: corrupting warm-transfer "
                f"chunk {chunk} in flight"
            )
            return True
        return False


# --------------------------------------------------------------------------
# Serving stall watchdog
# --------------------------------------------------------------------------


def make_serving_watchdog(
    engine,
    timeout: float,
    *,
    crash_report_dir: str = "results",
    exit_fn: Callable[[int], None] = os._exit,
    attach: bool = True,
) -> HangWatchdog:
    """A ``HangWatchdog`` pointed at an ``InferenceEngine``.

    ``engine.step()`` beats the watchdog each tick; a ``step()`` that
    stalls past ``timeout`` seconds (a wedged device dispatch, a dead
    device) dumps every thread stack plus
    the engine's metrics snapshot — including the per-outcome counters,
    so the post-mortem shows what the engine had admitted/shed/
    quarantined when it died — to ``crash_report_dir`` and exits
    ``SERVING_STALL_EXIT_CODE`` (44). Same fire-dump-exit discipline,
    crash-report plumbing, and launcher contract as the training
    watchdog; tests inject a recording ``exit_fn``.

    With ``attach`` (default) the watchdog is installed as
    ``engine.watchdog`` so ``step()`` beats it; the caller still owns
    start/stop (``with make_serving_watchdog(...):``).
    """

    def _report(info: dict) -> None:
        monitor = getattr(engine, "monitor", None)
        tracer = getattr(engine, "tracer", None)
        write_crash_report(
            info.get("reason", "serving stall watchdog fired"),
            engine.metrics.decode_steps,
            directory=crash_report_dir,
            counters=engine.metrics.snapshot(),
            monitor_records=(
                list(monitor.records) if monitor is not None else None
            ),
            thread_stacks=info.get("thread_stacks"),
            # the engine's span timeline (tick/admission/prefill/decode)
            # right up to the stall, as in training crash reports
            span_tail=(tracer.tail() if tracer is not None else None),
            extra={
                "serving": True,
                "exit_code": SERVING_STALL_EXIT_CODE,
                "pending_requests": engine.pending,
            },
        )

    wd = HangWatchdog(
        timeout,
        crash_report=_report,
        exit_fn=exit_fn,
        exit_code=SERVING_STALL_EXIT_CODE,
    )
    if attach:
        engine.watchdog = wd
    return wd
