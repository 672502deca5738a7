"""Replica process supervision: spawn, probe, restart, give up.

Counterpart of scaletorch_tpu/serving/supervisor.py (standard library
only); the port's spawner (``scaletorch_tpu_torch.serve``) launches
``python -m scaletorch_tpu_torch.replica`` children.

The gateway's fleet half (serving/remote.py) makes a replica a child
process; this module makes the fleet SELF-HEALING. One monitor thread
owns the process table and applies the exit-code contract
(docs/fault_tolerance.md) to serving replicas:

  * exit 0        — intentional drain (SIGTERM or ``POST /v1/drain``):
                    the replica leaves rotation quietly, NO restart.
  * exit 42/43/44 — the crash family (divergence sentinel, hang
                    watchdog, serving stall watchdog): restart with
                    capped exponential backoff + jitter.
  * any other     — same crash treatment (a SIGKILL'd child reports a
    non-zero       negative returncode; an import error reports 1 —
                    either way the replica did not CHOOSE to leave).
  * flapping      — ``flap_max_restarts`` restarts inside
                    ``flap_window_s`` marks the replica permanently
                    ``failed``: no more restarts, the router stops
                    learning it, the fleet shrinks and keeps serving.

This is the serving twin of ``launch.py``'s training
restart loop (which restarts the WHOLE fleet together, because a
training collective cannot survive a lone member). Serving replicas
share no collective, so the supervisor restarts them independently —
same exit codes, different blast radius. The two policies are
cross-referenced in docs/fault_tolerance.md so they cannot drift.

State machine per replica::

    starting --READY--> up --exit 0--------------------> drained
       |                 \\--exit !=0 (quota left)-----> backoff
       |                  \\--exit !=0 (flapping)------> failed
       '--ready timeout--> backoff --timer--> starting
    backoff counts as a restart attempt; ``restarts_consecutive``
    resets after ``healthy_reset_s`` of uptime, so a replica that
    crashes once a day never escalates its backoff.

Every transition emits a ``supervisor`` JSONL record (a registered
telemetry kind) and is visible live in the gateway's ``/healthz``
(state, pid, restart counters, last exit code) and ``/metrics``
(``replica_restarts_total{replica=...}``).

Pure stdlib, no torch — unit-testable with scripted fake processes.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

from scaletorch_tpu_torch.serving.router import CRASH_EXIT_CODES
from scaletorch_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

READY_PREFIX = "READY port="
READY_UDS_PREFIX = "READY uds="

# Replica lifecycle states surfaced on /healthz.
STATES = ("starting", "up", "backoff", "drained", "failed", "stopped")


class _Replica:
    """Monitor-thread-owned state of one supervised child."""

    __slots__ = ("replica_id", "state", "proc", "port", "pid",
                 "last_exit_code", "restarts_total",
                 "restarts_consecutive", "restart_stamps", "started_at",
                 "restart_at", "worker")

    def __init__(self, replica_id: str) -> None:
        self.replica_id = replica_id
        self.state = "starting"
        self.proc: Any = None
        # TCP port (int) or UDS socket path (str) from the READY line
        self.port: Optional[Any] = None
        self.pid: Optional[int] = None
        self.last_exit_code: Optional[int] = None
        self.restarts_total = 0
        self.restarts_consecutive = 0
        self.restart_stamps: Deque[float] = deque()
        self.started_at: Optional[float] = None
        self.restart_at: Optional[float] = None  # backoff timer deadline
        self.worker: Any = None


class ReplicaSupervisor:
    """Spawn/probe/restart a fleet of replica child processes.

    Parameters
    ----------
    spawn_fn : ``(replica_id) -> Popen-like`` — must expose ``pid``,
        ``poll()``, ``wait()``, ``terminate()``, ``kill()`` and a
        line-iterable text ``stdout`` on which the child prints
        ``READY port=<n>`` once its socket is bound (``scaletorch_tpu_torch.replica``
        does; the unit tests script a fake).
    worker_factory : optional ``(replica_id, port, proc) -> worker`` —
        builds the gateway-side handle (``RemoteEngineWorker`` started
        against the child's port) after each successful (re)spawn.
    on_exit : optional ``(replica_id, exit_code)`` — fired on the
        monitor thread whenever a child exits (the gateway trampolines
        this into ``router.report_exit``).
    on_restart : optional ``(replica_id, worker)`` — fired on the
        monitor thread once a replacement child is READY and its worker
        built (the gateway swaps its worker table and rejoins routing).
    backoff_base_s / backoff_max_s / backoff_jitter :
        restart n sleeps ``min(max, base * 2**(n-1)) * (1 + jitter*u)``
        with ``u ~ U[0,1)`` — capped exponential with jitter so a
        correlated fleet crash does not restart in lockstep.
    flap_window_s / flap_max_restarts : a replica restarted
        ``flap_max_restarts`` times within ``flap_window_s`` seconds is
        marked ``failed`` permanently (crash loops burn CPU and churn
        the router for zero served tokens).
    healthy_reset_s : uptime that resets ``restarts_consecutive`` (the
        backoff exponent) — occasional crashes stay at base backoff.
    ready_timeout_s : max wait for ``READY port=`` before the attempt
        itself counts as a crash (exit code None) and backs off.
    exporter : optional ``TelemetryExporter`` — every transition is a
        ``supervisor`` JSONL record.
    rng : injectable ``random.Random`` (tests seed it to pin jitter).
    """

    def __init__(
        self,
        spawn_fn: Callable[[str], Any],
        replica_ids: Sequence[str],
        *,
        worker_factory: Optional[Callable[[str, int, Any], Any]] = None,
        on_exit: Optional[Callable[[str, Optional[int]], None]] = None,
        on_restart: Optional[Callable[[str, Any], None]] = None,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 30.0,
        backoff_jitter: float = 0.5,
        flap_window_s: float = 60.0,
        flap_max_restarts: int = 5,
        healthy_reset_s: float = 30.0,
        ready_timeout_s: float = 120.0,
        poll_interval_s: float = 0.05,
        exporter: Any = None,
        rng: Optional[random.Random] = None,
    ) -> None:
        if not replica_ids:
            raise ValueError("supervisor needs at least one replica id")
        if len(set(replica_ids)) != len(replica_ids):
            raise ValueError(f"duplicate replica ids: {list(replica_ids)}")
        self._spawn_fn = spawn_fn
        self.worker_factory = worker_factory
        self.on_exit = on_exit
        self.on_restart = on_restart
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.backoff_jitter = backoff_jitter
        self.flap_window_s = flap_window_s
        self.flap_max_restarts = flap_max_restarts
        self.healthy_reset_s = healthy_reset_s
        self.ready_timeout_s = ready_timeout_s
        self.poll_interval_s = poll_interval_s
        self.exporter = exporter
        self._rng = rng if rng is not None else random.Random()
        self._lock = threading.Lock()
        self._replicas: Dict[str, _Replica] = {
            rid: _Replica(rid) for rid in replica_ids}
        self._stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="replica-supervisor",
            daemon=True)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> Dict[str, Any]:
        """Spawn every replica, wait for its READY line, build its
        worker, start the monitor. Returns ``{replica_id: worker}``
        (workers are None without a ``worker_factory``). A replica that
        fails its FIRST boot raises — a fleet that cannot start at all
        is a configuration error, not a fault to ride through."""
        workers: Dict[str, Any] = {}
        for rid, rep in self._replicas.items():
            if not self._spawn_once(rep):
                self.stop(drain=False)
                raise RuntimeError(
                    f"replica {rid} failed its first boot "
                    f"(exit {rep.last_exit_code})")
            workers[rid] = rep.worker
        self._monitor.start()
        return workers

    def stop(self, *, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop supervising and stop the children: SIGTERM for a clean
        drain (exit 0), SIGKILL without ``drain`` or past the timeout."""
        self._stop.set()
        if self._monitor.is_alive():
            self._monitor.join(timeout=timeout_s)
        with self._lock:
            reps = list(self._replicas.values())
        deadline = time.monotonic() + timeout_s
        for rep in reps:
            proc = rep.proc
            if proc is None or proc.poll() is not None:
                continue
            try:
                if drain:
                    proc.terminate()
                else:
                    proc.kill()
            except OSError:
                pass
        for rep in reps:
            proc = rep.proc
            if proc is None:
                continue
            try:
                proc.wait(max(0.1, deadline - time.monotonic()))
            except Exception:
                try:
                    proc.kill()
                    proc.wait(5.0)
                except Exception:
                    pass
            with self._lock:
                if rep.state not in ("failed",):
                    rep.state = "stopped"
                if proc.returncode is not None \
                        and rep.last_exit_code is None:
                    rep.last_exit_code = proc.returncode

    # -- observability -----------------------------------------------------
    def status(self) -> Dict[str, Dict[str, Any]]:
        """Per-replica process state for /healthz and /metrics."""
        out: Dict[str, Dict[str, Any]] = {}
        now = time.monotonic()
        with self._lock:
            for rid, rep in self._replicas.items():
                out[rid] = {
                    "state": rep.state,
                    "pid": rep.pid,
                    "port": rep.port,
                    "restarts_total": rep.restarts_total,
                    "restarts_consecutive": rep.restarts_consecutive,
                    "last_exit_code": rep.last_exit_code,
                    "next_restart_in_s": (
                        max(0.0, rep.restart_at - now)
                        if rep.restart_at is not None
                        and rep.state == "backoff" else None),
                }
        return out

    def replica_status(self, replica_id: str) -> Dict[str, Any]:
        return self.status().get(replica_id, {})

    def _emit(self, event: str, rep: _Replica, **extra: Any) -> None:
        logger.info("supervisor: replica %s %s%s", rep.replica_id, event,
                    f" {extra}" if extra else "")
        if self.exporter is None:
            return
        record = {
            "replica": rep.replica_id,
            "event": event,
            "state": rep.state,
            "pid": rep.pid,
            "exit_code": rep.last_exit_code,
            "restarts_total": rep.restarts_total,
        }
        record.update(extra)
        try:
            self.exporter.emit("supervisor", record)
        except Exception:
            logger.exception("supervisor telemetry export failed")

    # -- spawn / ready -----------------------------------------------------
    def _wait_ready(self, proc: Any) -> Optional[Any]:
        """Read the child's stdout until ``READY port=<n>`` (returns the
        port, an int) or ``READY uds=<path>`` (returns the socket path,
        a str — the UDS transport's address), or EOF/timeout/death
        (returns None). The remaining stdout is pumped by a daemon
        thread so a chatty child never blocks on a full pipe."""
        deadline = time.monotonic() + self.ready_timeout_s
        port: Optional[Any] = None
        stdout = getattr(proc, "stdout", None)
        if stdout is None:
            return None
        box: List[Optional[str]] = []

        def _readline() -> None:
            try:
                box.append(stdout.readline())
            except (OSError, ValueError):
                box.append(None)

        while time.monotonic() < deadline:
            box.clear()
            t = threading.Thread(target=_readline, daemon=True)
            t.start()
            t.join(max(0.05, deadline - time.monotonic()))
            if not box:
                continue  # timed out mid-line; re-check the deadline
            line = box[0]
            if not line:
                return None  # EOF: the child died before READY
            line = line.strip()
            if line.startswith(READY_PREFIX):
                try:
                    port = int(line[len(READY_PREFIX):].split()[0])
                except (ValueError, IndexError):
                    return None
                break
            if line.startswith(READY_UDS_PREFIX):
                try:
                    port = line[len(READY_UDS_PREFIX):].split()[0]
                except IndexError:
                    return None
                if not port:
                    return None
                break
        if port is None:
            return None

        def _pump() -> None:
            try:
                for _ in stdout:
                    pass
            except (OSError, ValueError):
                pass

        threading.Thread(target=_pump, name="replica-stdout-pump",
                         daemon=True).start()
        return port

    def _spawn_once(self, rep: _Replica) -> bool:
        """One spawn attempt: fork, wait READY, build the worker.
        Returns False on any failure (caller decides backoff/fail)."""
        rep.state = "starting"
        rep.restart_at = None
        try:
            proc = self._spawn_fn(rep.replica_id)
        except Exception:
            logger.exception("spawn of replica %s raised", rep.replica_id)
            rep.last_exit_code = None
            return False
        rep.proc = proc
        rep.pid = getattr(proc, "pid", None)
        self._emit("spawn", rep)
        port = self._wait_ready(proc)
        if port is None:
            rc = proc.poll()
            if rc is None:
                try:
                    proc.kill()
                    proc.wait(5.0)
                except Exception:
                    pass
                rc = proc.poll()
            rep.last_exit_code = rc
            self._emit("ready_timeout", rep)
            return False
        rep.port = port
        worker = None
        if self.worker_factory is not None:
            try:
                worker = self.worker_factory(rep.replica_id, port, proc)
            except Exception:
                logger.exception("worker factory for replica %s failed",
                                 rep.replica_id)
                try:
                    proc.kill()
                    proc.wait(5.0)
                except Exception:
                    pass
                rep.last_exit_code = proc.poll()
                return False
        rep.worker = worker
        rep.state = "up"
        rep.started_at = time.monotonic()
        self._emit("ready", rep, port=port)
        return True

    # -- the exit-code contract --------------------------------------------
    def _backoff_s(self, attempt: int) -> float:
        base = min(self.backoff_max_s,
                   self.backoff_base_s * (2 ** max(0, attempt - 1)))
        return base * (1.0 + self.backoff_jitter * self._rng.random())

    def _handle_exit(self, rep: _Replica, exit_code: Optional[int]) -> None:
        """Apply the contract to one observed child exit (monitor
        thread). Mutates ``rep`` under the lock, then fires callbacks
        outside it."""
        now = time.monotonic()
        with self._lock:
            rep.last_exit_code = exit_code
            rep.pid = None
            uptime = (now - rep.started_at) \
                if rep.started_at is not None else 0.0
            if exit_code == 0:
                rep.state = "drained"
            else:
                if uptime >= self.healthy_reset_s:
                    rep.restarts_consecutive = 0
                rep.restart_stamps.append(now)
                while rep.restart_stamps and \
                        now - rep.restart_stamps[0] > self.flap_window_s:
                    rep.restart_stamps.popleft()
                if len(rep.restart_stamps) >= self.flap_max_restarts:
                    rep.state = "failed"
                else:
                    rep.restarts_consecutive += 1
                    rep.restarts_total += 1
                    rep.state = "backoff"
                    rep.restart_at = now + self._backoff_s(
                        rep.restarts_consecutive)
            state = rep.state
        reason = "clean drain" if exit_code == 0 else \
            CRASH_EXIT_CODES.get(exit_code, "crash")
        if state == "drained":
            self._emit("drained", rep, reason=reason)
        elif state == "failed":
            self._emit("flapping", rep, reason=reason,
                       window_s=self.flap_window_s)
        else:
            self._emit("crash", rep, reason=reason,
                       backoff_s=round(rep.restart_at - now, 3))
        if self.on_exit is not None:
            try:
                self.on_exit(rep.replica_id,
                             exit_code if exit_code is not None else 1)
            except Exception:
                logger.exception("on_exit callback failed")

    def _try_restart(self, rep: _Replica) -> None:
        """One due restart attempt (monitor thread, outside the lock:
        spawning and READY-waiting are slow)."""
        if self._spawn_once(rep):
            self._emit("restart", rep, port=rep.port)
            if self.on_restart is not None:
                try:
                    self.on_restart(rep.replica_id, rep.worker)
                except Exception:
                    logger.exception("on_restart callback failed")
            return
        # the attempt itself crashed: treat like an exit and re-apply
        # the contract (backoff escalates, flap detection still counts)
        self._handle_exit(rep, rep.last_exit_code)

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            with self._lock:
                reps = list(self._replicas.values())
            now = time.monotonic()
            for rep in reps:
                if self._stop.is_set():
                    return
                if rep.state == "up":
                    proc = rep.proc
                    rc = proc.poll() if proc is not None else None
                    if rc is not None:
                        self._handle_exit(rep, rc)
                elif rep.state == "backoff" and rep.restart_at is not None \
                        and now >= rep.restart_at:
                    self._try_restart(rep)
