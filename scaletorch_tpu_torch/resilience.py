"""Fault tolerance of the port (counterpart of scaletorch_tpu/
resilience.py): divergence sentinel, preemption shutdown, I/O retries and
fault injection.

A NaN loss, a preempted machine or one flaky checkpoint write must
degrade a run, not kill it. This module is the host-side half of the
resilience layer; the device-side half is ``guarded_update``
(trainer/optimizer.py), which rejects an update whose loss or global
gradient norm is non-finite inside the train step.

  * ``DivergenceSentinel`` tracks a loss EMA on the host and classifies
    each step as ok or anomalous (non-finite, or a spike); the policy
    maps an anomaly to skip, rollback or abort.
  * ``PreemptionHandler`` turns SIGTERM/SIGINT into "checkpoint at the
    next step boundary and exit cleanly". Its signal handler only sets a
    flag and logs: it runs on the main thread between bytecodes, possibly
    right after a blocking CUDA synchronisation, and touches no tensor.
  * ``retry_with_backoff`` runs retriable I/O (checkpoint saves and
    restores, the loader's step-batch reads) with exponential backoff.
  * ``FaultInjector`` holds the config/env-driven drills (a NaN loss,
    failed saves, a SIGTERM, a hang, a corrupt batch, a slow step, a
    kill) so the recovery paths are exercised end to end.
  * ``ResilienceManager`` binds them into the per-step protocol of the
    training loop.

The serving counterpart is ``inference/resilience.py``; the engine reuses
``PreemptionHandler`` to drain on SIGTERM.
"""

from __future__ import annotations

import math
import os
import random
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from scaletorch_tpu_torch.env import env_override
from scaletorch_tpu_torch.utils.logger import get_logger

DIVERGENCE_POLICIES = ("skip", "rollback", "abort")


class TrainingDivergedError(RuntimeError):
    """Raised when the divergence sentinel decides the run cannot continue
    (policy='abort', or too many consecutive anomalies under any policy)."""


class PreemptionRequested(RuntimeError):
    """Raised by PreemptionHandler.check() when a shutdown signal arrived
    (only used by callers that prefer control flow over polling)."""


# --------------------------------------------------------------------------
# Divergence sentinel
# --------------------------------------------------------------------------


@dataclass
class DivergenceSentinel:
    """Host-side anomaly tracker over the per-step loss.

    ``observe(loss)`` returns the action for this step: ``"ok"``,
    ``"skip"`` or ``"rollback"`` — or raises ``TrainingDivergedError``
    when the policy is ``abort`` or ``max_consecutive_anomalies``
    consecutive anomalies accumulate (0 disables the consecutive cap).

    An anomaly is a non-finite loss, or — when ``spike_factor`` > 0 and
    the EMA is warmed up — a loss above ``spike_factor * ema``. Anomalous
    losses never feed the EMA, so one spike cannot drag the baseline up
    and mask the next one.
    """

    policy: str = "skip"
    spike_factor: float = 0.0
    ema_beta: float = 0.98
    max_consecutive_anomalies: int = 3
    max_rollbacks: int = 3

    ema: Optional[float] = None
    consecutive: int = 0
    total_anomalies: int = 0
    nonfinite_losses: int = 0
    loss_spikes: int = 0
    rollbacks: int = 0

    def __post_init__(self) -> None:
        if self.policy not in DIVERGENCE_POLICIES:
            raise ValueError(
                f"divergence policy must be one of {DIVERGENCE_POLICIES}, "
                f"got {self.policy!r}"
            )

    def observe(self, loss: float, step: Optional[int] = None) -> str:
        loss = float(loss)
        nonfinite = not math.isfinite(loss)
        spike = (
            not nonfinite
            and self.spike_factor > 0
            and self.ema is not None
            and loss > self.spike_factor * self.ema
        )
        if not (nonfinite or spike):
            self.consecutive = 0
            self.ema = (
                loss if self.ema is None
                else self.ema_beta * self.ema + (1 - self.ema_beta) * loss
            )
            return "ok"

        self.consecutive += 1
        self.total_anomalies += 1
        if nonfinite:
            self.nonfinite_losses += 1
        else:
            self.loss_spikes += 1
        where = f" at step {step}" if step is not None else ""
        kind = "non-finite" if nonfinite else (
            f"spiking (> {self.spike_factor:g}x ema {self.ema:.4g})"
        )
        if self.policy == "abort":
            raise TrainingDivergedError(
                f"loss {loss} is {kind}{where} and divergence_policy='abort'"
            )
        if (self.max_consecutive_anomalies > 0
                and self.consecutive >= self.max_consecutive_anomalies):
            raise TrainingDivergedError(
                f"{self.consecutive} consecutive anomalous losses"
                f"{where} (last: {loss}, {kind}) — aborting "
                f"(max_consecutive_anomalies={self.max_consecutive_anomalies})"
            )
        return self.policy

    def ensure_rollback_budget(self) -> None:
        """Raise BEFORE another rollback would exceed ``max_rollbacks`` —
        the abort must precede the expensive restore+retrain cycle, not
        follow it (a persistently-bad data region must not loop)."""
        if self.max_rollbacks > 0 and self.rollbacks >= self.max_rollbacks:
            raise TrainingDivergedError(
                f"another rollback would exceed the budget of "
                f"{self.max_rollbacks} (already performed "
                f"{self.rollbacks}) — aborting"
            )

    def note_rollback(self) -> None:
        """Record a completed rollback."""
        self.rollbacks += 1
        self.consecutive = 0

    def counters(self) -> Dict[str, float]:
        """Anomaly counters for the metrics stream / monitor ring buffer."""
        return {
            "anomalies": float(self.total_anomalies),
            "nonfinite_losses": float(self.nonfinite_losses),
            "loss_spikes": float(self.loss_spikes),
            "rollbacks": float(self.rollbacks),
        }


# --------------------------------------------------------------------------
# Preemption-safe shutdown
# --------------------------------------------------------------------------


class PreemptionHandler:
    """SIGTERM/SIGINT → "emergency-checkpoint at the next step boundary".

    The handler only sets a flag; the training loop polls ``requested``
    between steps, saves, and exits cleanly — signal-async-safety stays
    trivial, no tensor is touched from the handler, and a step already
    queued on the card is never interrupted. A second
    SIGINT falls through to KeyboardInterrupt so an operator can still
    force-kill a wedged run.

    ``install()`` is a no-op off the main thread (CPython restricts
    ``signal.signal`` to it) and restores the previous handlers on
    ``uninstall()``/context exit, so library users and tests are never
    left with hijacked signals.
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)):
        self.signals = signals
        self._requested = False
        self._signum: Optional[int] = None
        self._sigint_count = 0
        self._previous: Dict[int, Any] = {}
        self._installed = False

    @property
    def requested(self) -> bool:
        return self._requested

    @property
    def signum(self) -> Optional[int]:
        return self._signum

    def _handle(self, signum, frame) -> None:
        # only repeated SIGINTs escalate — a SIGTERM followed by one
        # ctrl-C must still get its graceful emergency checkpoint
        if signum == signal.SIGINT:
            self._sigint_count += 1
            if self._sigint_count > 1:
                raise KeyboardInterrupt
        self._requested = True
        self._signum = signum
        get_logger().warning(
            f"received signal {signum}: requesting emergency checkpoint at "
            "the next step boundary (send SIGINT again to force-exit)"
        )

    def trigger(self, signum: int = signal.SIGTERM) -> None:
        """Simulate signal delivery (fault injection / tests)."""
        self._handle(signum, None)

    def install(self) -> "PreemptionHandler":
        if threading.current_thread() is not threading.main_thread():
            get_logger().warning(
                "PreemptionHandler.install skipped: not on the main thread"
            )
            return self
        for s in self.signals:
            self._previous[s] = signal.signal(s, self._handle)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
        self._installed = False

    def check(self) -> None:
        if self._requested:
            raise PreemptionRequested(f"signal {self._signum} received")

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


# --------------------------------------------------------------------------
# Retriable I/O
# --------------------------------------------------------------------------


def retry_with_backoff(
    fn: Callable[[], Any],
    *,
    retries: int = 3,
    base_delay: float = 0.5,
    max_delay: float = 8.0,
    jitter: float = 0.5,
    retriable: Tuple[type, ...] = (Exception,),
    describe: str = "operation",
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Run ``fn`` with exponential backoff + jitter on retriable failure.

    ``retries`` is the number of RE-tries: the call is attempted at most
    ``retries + 1`` times; the final failure re-raises. Delays follow
    ``base_delay * 2**attempt`` capped at ``max_delay``, each scaled by a
    uniform ``[1, 1 + jitter]`` factor so a fleet of preempted workers
    does not stampede shared storage in lockstep.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except retriable as exc:
            if attempt >= retries:
                raise
            delay = min(max_delay, base_delay * (2 ** attempt))
            delay *= 1.0 + random.random() * max(jitter, 0.0)
            get_logger().warning(
                f"{describe} failed (attempt {attempt + 1}/{retries + 1}): "
                f"{exc!r}; retrying in {delay:.2f}s"
            )
            sleep(delay)
            attempt += 1


# --------------------------------------------------------------------------
# Fault injection
# --------------------------------------------------------------------------


class HostKilledError(BaseException):
    """Raised by a test-mode ``deliver_kill`` to unwind a simulated host
    thread the way os._exit(1) removes a real process: NOT an Exception
    subclass, so no resilience handler between the injection site and
    the host's top level can swallow it."""


@dataclass
class FaultInjector:
    """Config/env-driven fault hooks. All knobs default to off (0).

    * ``nan_at_step`` — replace the reported loss with NaN once, after
      optimizer step k, simulating a diverged step for the sentinel.
    * ``fail_saves`` — make the first n checkpoint-save attempts raise
      (consumed by CheckpointManager), proving the retry/backoff path.
    * ``sigterm_at_step`` — deliver a real SIGTERM to this process after
      optimizer step k, simulating preemption. ``sigterm_host`` restricts
      delivery to one process index (the multi-host drill: exactly ONE
      worker is preempted and the fleet must still stop together).
    * ``hang_at_step`` / ``hang_seconds`` — stall the step boundary once
      after step k, simulating a dead collective for the hang watchdog.
    * ``bad_batch_at_step`` — every read of stream position k raises a
      retriable I/O error (a corrupt shard: deterministic, so retries
      fail and the loader's skip-and-log path must retire the region).
    * ``kill_host_at_step`` / ``kill_host`` — hard-kill exactly one host
      after optimizer step k (the elastic drill: survivors must remesh
      and continue, not restart the fleet).
    * ``host_hang_elastic`` — stall the ``kill_host``-selected host past
      the elastic epoch-bus deadline once after step k, so the fleet
      evicts a live-but-wedged peer (it later rejoins).

    Env overrides (taking precedence over config so a running job can be
    probed without a config edit): ``SCALETORCH_TPU_FT_NAN_STEP``,
    ``SCALETORCH_TPU_FT_FAIL_SAVES``, ``SCALETORCH_TPU_FT_SIGTERM_STEP``,
    ``SCALETORCH_TPU_FT_SIGTERM_HOST``, ``SCALETORCH_TPU_FT_HANG_STEP``,
    ``SCALETORCH_TPU_FT_BAD_BATCH_STEP``,
    ``SCALETORCH_TPU_FT_KILL_HOST_STEP``, ``SCALETORCH_TPU_FT_KILL_HOST``,
    ``SCALETORCH_TPU_FT_HOST_HANG_ELASTIC``.
    """

    nan_at_step: int = 0
    fail_saves: int = 0
    sigterm_at_step: int = 0
    sigterm_host: int = -1
    hang_at_step: int = 0
    hang_seconds: float = 120.0
    bad_batch_at_step: int = 0
    slow_step_at_step: int = 0
    slow_step_seconds: float = 0.5
    kill_host_at_step: int = 0
    kill_host: int = -1
    host_hang_elastic: int = 0
    host_hang_seconds: float = 30.0
    # host identity for the one-host drills; None = the process group's
    # rank when one is initialised, else 0 (tests set it explicitly)
    host_index: Optional[int] = None
    # signal delivery override for simulated hosts (tests route this to a
    # host-local PreemptionHandler.trigger; None = real os.kill)
    deliver_signal: Optional[Callable[[int], None]] = field(
        default=None, repr=False)
    # kill delivery override for simulated hosts (tests raise a
    # HostKilledError that unwinds the host thread; None = os._exit(1),
    # the crash-family exit the elastic launcher relaunches per-rank)
    deliver_kill: Optional[Callable[[], None]] = field(
        default=None, repr=False)
    nan_fired_step: Optional[int] = field(default=None, repr=False)
    _nan_fired: bool = field(default=False, repr=False)
    _sigterm_fired: bool = field(default=False, repr=False)
    _hang_fired: bool = field(default=False, repr=False)
    _slow_fired: bool = field(default=False, repr=False)
    _kill_fired: bool = field(default=False, repr=False)
    _elastic_hang_fired: bool = field(default=False, repr=False)

    @classmethod
    def from_config(cls, cfg) -> "FaultInjector":
        def env_or(name: str, cfg_field: str, default: int = 0) -> int:
            # present-wins (an explicit 0 CANCELS a config-armed drill):
            # the shared contract lives in env.env_override
            return int(env_override(
                name, getattr(cfg, cfg_field, default)))

        return cls(
            nan_at_step=env_or("SCALETORCH_TPU_FT_NAN_STEP",
                               "ft_nan_at_step"),
            fail_saves=env_or("SCALETORCH_TPU_FT_FAIL_SAVES",
                              "ft_fail_saves"),
            sigterm_at_step=env_or("SCALETORCH_TPU_FT_SIGTERM_STEP",
                                   "ft_sigterm_at_step"),
            sigterm_host=env_or("SCALETORCH_TPU_FT_SIGTERM_HOST",
                                "ft_sigterm_host", default=-1),
            hang_at_step=env_or("SCALETORCH_TPU_FT_HANG_STEP",
                                "ft_hang_at_step"),
            hang_seconds=float(getattr(cfg, "ft_hang_seconds", 120.0)),
            bad_batch_at_step=env_or("SCALETORCH_TPU_FT_BAD_BATCH_STEP",
                                     "ft_bad_batch_at_step"),
            slow_step_at_step=env_or("SCALETORCH_TPU_FT_SLOW_STEP_STEP",
                                     "ft_slow_step_at_step"),
            slow_step_seconds=float(env_override(
                "SCALETORCH_TPU_FT_SLOW_STEP_SECONDS",
                getattr(cfg, "ft_slow_step_seconds", 0.5))),
            kill_host_at_step=env_or("SCALETORCH_TPU_FT_KILL_HOST_STEP",
                                     "ft_kill_host_at_step"),
            kill_host=env_or("SCALETORCH_TPU_FT_KILL_HOST",
                             "ft_kill_host", default=-1),
            host_hang_elastic=env_or("SCALETORCH_TPU_FT_HOST_HANG_ELASTIC",
                                     "ft_host_hang_elastic"),
            host_hang_seconds=float(
                getattr(cfg, "ft_host_hang_seconds", 30.0)),
        )

    @property
    def active(self) -> bool:
        return bool(self.nan_at_step or self.fail_saves
                    or self.sigterm_at_step or self.hang_at_step
                    or self.bad_batch_at_step or self.slow_step_at_step
                    or self.kill_host_at_step or self.host_hang_elastic)

    def _host(self) -> int:
        if self.host_index is not None:
            return self.host_index
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
        return 0

    def corrupt_metrics(self, step: int, metrics: Dict[str, Any]
                        ) -> Dict[str, Any]:
        if self.nan_at_step and step == self.nan_at_step \
                and not self._nan_fired:
            self._nan_fired = True
            self.nan_fired_step = step
            get_logger().warning(
                f"fault injection: NaN loss at step {step}"
            )
            return {**metrics, "loss": float("nan")}
        return metrics

    def maybe_sigterm(self, step: int) -> None:
        if self.sigterm_at_step and step == self.sigterm_at_step \
                and not self._sigterm_fired:
            if self.sigterm_host >= 0 and self._host() != self.sigterm_host:
                return  # the drill preempts exactly one worker
            self._sigterm_fired = True
            get_logger().warning(
                f"fault injection: SIGTERM after step {step}"
                + (f" on host {self.sigterm_host}"
                   if self.sigterm_host >= 0 else "")
            )
            if self.deliver_signal is not None:
                self.deliver_signal(signal.SIGTERM)
            else:
                os.kill(os.getpid(), signal.SIGTERM)

    def maybe_hang(self, step: int) -> None:
        """Stall the step boundary once (simulated dead collective) so
        the hang watchdog's fire-dump-exit path is testable end to end."""
        if self.hang_at_step and step == self.hang_at_step \
                and not self._hang_fired:
            self._hang_fired = True
            get_logger().warning(
                f"fault injection: hanging for {self.hang_seconds:g}s "
                f"after step {step}"
            )
            time.sleep(self.hang_seconds)

    def maybe_kill(self, step: int) -> None:
        """Elastic drill: hard-kill the ``kill_host``-selected host after
        optimizer step k. Fires BEFORE the decision gather, so the dead
        host simply never shows up in its peers' collective — the
        host-loss shape the elastic coordinator remeshes around. Default
        delivery is ``os._exit(1)`` (crash-family exit: the elastic
        launcher relaunches just this rank); tests override
        ``deliver_kill`` to unwind the simulated host thread."""
        if self.kill_host_at_step and step == self.kill_host_at_step \
                and not self._kill_fired:
            if self.kill_host >= 0 and self._host() != self.kill_host:
                return  # the drill kills exactly one worker
            self._kill_fired = True
            get_logger().warning(
                f"fault injection: killing host {self._host()} after "
                f"step {step}"
            )
            if self.deliver_kill is not None:
                self.deliver_kill()
            else:
                os._exit(1)

    def maybe_elastic_hang(self, step: int) -> None:
        """Elastic drill: stall the ``kill_host``-selected host past the
        epoch-bus deadline once, so its peers' collective times out and
        the fleet evicts a live-but-wedged peer (which must then park
        and rejoin). Unlike ``maybe_hang`` — the whole-run watchdog
        drill — this is scoped to one host and sized against the
        elastic deadline, not the watchdog timeout."""
        if self.host_hang_elastic and step == self.host_hang_elastic \
                and not self._elastic_hang_fired:
            if self.kill_host >= 0 and self._host() != self.kill_host:
                return
            self._elastic_hang_fired = True
            get_logger().warning(
                f"fault injection: host {self._host()} hanging "
                f"{self.host_hang_seconds:g}s across the elastic "
                f"deadline after step {step}"
            )
            time.sleep(self.host_hang_seconds)

    def maybe_slow_step(self, step: int) -> None:
        """Telemetry drill: stall step ``step`` at its boundary once, so
        its wall time spikes and the slow-step detector
        (telemetry/profiling.py) arms a bounded profiler window. A
        pure delay — unlike ``maybe_hang`` it is sized to stay well
        under any watchdog timeout."""
        if self.slow_step_at_step and step == self.slow_step_at_step \
                and not self._slow_fired:
            self._slow_fired = True
            get_logger().warning(
                f"fault injection: slowing step {step} by "
                f"{self.slow_step_seconds:g}s"
            )
            time.sleep(self.slow_step_seconds)

    def take_bad_read(self, position: int) -> bool:
        """True when the batch read at absolute stream ``position`` must
        fail. Deliberately NOT consumed-once: a corrupt shard fails every
        retry, which is exactly what forces the skip-and-log path."""
        return bool(self.bad_batch_at_step
                    and position == self.bad_batch_at_step)

    def take_save_failure(self) -> bool:
        """Consume one injected save failure (CheckpointManager calls this
        once per save attempt)."""
        if self.fail_saves > 0:
            self.fail_saves -= 1
            return True
        return False


# --------------------------------------------------------------------------
# Orchestration: one object the training loop talks to
# --------------------------------------------------------------------------


@dataclass
class ResilienceManager:
    """Binds sentinel + injector + preemption into the per-step protocol
    a training loop follows (Trainer.train and the hermetic fault-injection
    test harness share this object, so the recovery logic under test IS
    the production logic):

      1. ``after_step(step, metrics, rollback=...)`` — apply injected
         metric corruption, classify the loss, run the rollback callback
         when the policy asks for one, then deliver any injected SIGTERM.
      2. ``stop_requested`` — poll at each step boundary; when True, save
         an emergency checkpoint and exit cleanly.
    """

    sentinel: Optional[DivergenceSentinel] = None
    injector: FaultInjector = field(default_factory=FaultInjector)
    preemption: Optional[PreemptionHandler] = None
    sentinel_frequency: int = 1

    @classmethod
    def from_config(cls, cfg) -> "ResilienceManager":
        freq = getattr(cfg, "sentinel_frequency", 1)
        if freq < 0:
            # follow the logging cadence: those steps already materialise
            # the loss for the console line, so the sentinel's host sync
            # is free there
            freq = max(1, getattr(cfg, "log_frequency", 1))
        sentinel = None
        if freq > 0:
            sentinel = DivergenceSentinel(
                policy=getattr(cfg, "divergence_policy", "skip"),
                spike_factor=getattr(cfg, "loss_spike_factor", 0.0),
                ema_beta=getattr(cfg, "loss_ema_beta", 0.98),
                max_consecutive_anomalies=getattr(
                    cfg, "max_consecutive_anomalies", 3),
                max_rollbacks=getattr(cfg, "max_rollbacks", 3),
            )
        return cls(
            sentinel=sentinel,
            injector=FaultInjector.from_config(cfg),
            sentinel_frequency=freq,
        )

    @property
    def stop_requested(self) -> bool:
        return self.preemption is not None and self.preemption.requested

    def install_preemption_handler(self) -> None:
        if self.preemption is None:
            self.preemption = PreemptionHandler().install()

    def uninstall_preemption_handler(self) -> None:
        if self.preemption is not None:
            self.preemption.uninstall()
            self.preemption = None

    def after_step(
        self,
        step: int,
        metrics: Dict[str, Any],
        *,
        rollback: Optional[Callable[[], bool]] = None,
    ) -> Tuple[Dict[str, Any], str]:
        """Returns ``(metrics, action)``; ``action`` in ok|skip|rollback.

        ``rollback`` is called when the policy asks for one and must
        return True if it actually restored a checkpoint — False (or no
        callback) downgrades the anomaly to a skip. ``metrics["loss"]``
        is materialised to a host float only when the sentinel actually
        samples this step (``sentinel_frequency``), so runs that want
        full async dispatch can trade detection latency for it. May
        raise ``TrainingDivergedError`` (abort policy /
        consecutive-anomaly or rollback budget exhausted).
        """
        metrics = self.injector.corrupt_metrics(step, metrics)
        action = "ok"
        # an injected-NaN drill must be observed even when this is not a
        # sampled step — otherwise the drill silently proves nothing
        forced = self.injector.nan_fired_step == step
        if (self.sentinel is not None and self.sentinel_frequency > 0
                and (forced or step % self.sentinel_frequency == 0)):
            action = self.sentinel.observe(float(metrics["loss"]), step)
            if action == "rollback":
                self.sentinel.ensure_rollback_budget()
                if rollback is not None and rollback():
                    self.sentinel.note_rollback()
                else:
                    get_logger().warning(
                        "divergence_policy='rollback' but no checkpoint "
                        "is available: skipping the anomalous step instead"
                    )
                    action = "skip"
            if action == "skip":
                get_logger().warning(
                    f"anomalous loss {float(metrics['loss'])} at step "
                    f"{step}: batch skipped (the in-step guard rejected "
                    "the update if it was non-finite)"
                )
        self.injector.maybe_sigterm(step)
        self.injector.maybe_hang(step)
        return metrics, action

    def counters(self) -> Dict[str, float]:
        return self.sentinel.counters() if self.sentinel is not None else {}
