"""Cross-host straggler detection riding the per-step decision gather
(counterpart of scaletorch_tpu/telemetry/stragglers.py).

At fleet scale one slow host sets the pace for every collective — and
nothing in a lockstep SPMD run *says* so: every host's step time is the
straggler's step time once the collectives synchronise, so the only
place the skew is visible is the HOST-side interval between dispatching
steps (data fetch, host preprocessing, checkpoint I/O). This module
measures exactly that, with ZERO new collectives: each host's step
wall-time and data-fetch time ride the per-step
``CoordinatedResilience`` observation gather that multi-host runs
already pay for, and host 0 reduces them:

  * every logging step, host 0 logs p50 / max / argmax-host for step
    time and data-fetch time — the one-line answer to "which host is
    slow?" the multihost launcher otherwise cannot give;
  * a host persistently above ``factor`` x the median of the *other*
    hosts (leave-one-out, so its own slowness cannot mask it; for
    ``patience`` consecutive observations) raises the named
    ``straggler_flags`` counter (and ``straggler_host`` gauge), which
    rides the metrics extras into the ring buffer, the JSONL export
    and crash reports.

Single-process runs have no fleet to compare against; the detector is
simply not attached there. Over processes the trainer attaches it when
``straggler_factor`` is set, and the per-process times ride the
coordinated decision's observation gather (``resilience_distributed.
CoordinatedResilience.after_step``): rank 0 observes, no collective of
its own.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from scaletorch_tpu_torch.utils.logger import get_logger


def _median(values: List[float]) -> float:
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


class StragglerDetector:
    """Reduce per-host ``{step_time, data_fetch_time}`` observations
    into a fleet summary + a persistent-straggler counter.

    ``observe(step, per_host)`` is called by host 0 with the gathered
    observations (``None`` entries tolerated — a host may omit
    telemetry); returns the summary dict for that step, or ``None``
    when fewer than two hosts reported. State is host-0-local: the
    counters feed host 0's metrics line, which is the only console line
    a multi-host run prints anyway."""

    def __init__(
        self,
        *,
        factor: float = 2.0,
        patience: int = 3,
        log_frequency: int = 1,
        tracer: Any = None,
    ) -> None:
        if factor <= 1.0:
            raise ValueError(f"straggler factor must be > 1, got {factor}")
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.factor = factor
        self.patience = patience
        self.log_frequency = max(1, log_frequency)
        self.tracer = tracer
        # consecutive over-threshold observations per host index
        self._streaks: Dict[int, int] = {}
        self.straggler_flags = 0
        self.straggler_host = -1
        self.last_summary: Optional[Dict[str, float]] = None

    def observe(self, step: int,
                per_host: List[Optional[dict]]) -> Optional[Dict[str, float]]:
        times = [
            (i, float(o["step_time"]))
            for i, o in enumerate(per_host)
            if o is not None and o.get("step_time") is not None
        ]
        if len(times) < 2:
            return None
        step_vals = [t for _, t in times]
        med = _median(step_vals)
        max_host, max_val = max(times, key=lambda it: it[1])
        summary: Dict[str, float] = {
            "step_time_p50": med,
            "step_time_max": max_val,
            "step_time_argmax_host": float(max_host),
        }
        fetch = [
            (i, float(o["data_fetch_time"]))
            for i, o in enumerate(per_host)
            if o is not None and o.get("data_fetch_time") is not None
        ]
        if len(fetch) >= 2:
            f_host, f_val = max(fetch, key=lambda it: it[1])
            summary.update(
                data_fetch_p50=_median([v for _, v in fetch]),
                data_fetch_max=f_val,
                data_fetch_argmax_host=float(f_host),
            )

        # persistence: a streak of `patience` observations over
        # factor x the median of the OTHER hosts flags the host (and
        # keeps flagging while the streak holds — a counter that stops
        # moving means recovery). Leave-one-out matters: a straggler's
        # own time would otherwise drag the median up with it, and on a
        # 2-host fleet make the threshold unreachable (t > t + peer).
        flagged_now = -1
        flagged_med = 0.0
        for idx, (i, t) in enumerate(times):
            peer_med = _median(
                [v for j, (_, v) in enumerate(times) if j != idx])
            if peer_med > 0 and t > self.factor * peer_med:
                self._streaks[i] = self._streaks.get(i, 0) + 1
                if self._streaks[i] >= self.patience:
                    self.straggler_flags += 1
                    self.straggler_host = i
                    flagged_now = i
                    flagged_med = peer_med
            else:
                self._streaks[i] = 0
                if self.straggler_host == i:
                    self.straggler_host = -1
        self.last_summary = summary

        if step % self.log_frequency == 0:
            line = (
                f"step {step:>6} | host step-time p50 {med * 1e3:.1f}ms "
                f"max {max_val * 1e3:.1f}ms (host {max_host})"
            )
            if "data_fetch_max" in summary:
                line += (
                    f" | data-fetch p50 {summary['data_fetch_p50'] * 1e3:.1f}ms"
                    f" max {summary['data_fetch_max'] * 1e3:.1f}ms "
                    f"(host {int(summary['data_fetch_argmax_host'])})"
                )
            get_logger().info(line)
        if flagged_now >= 0:
            get_logger().warning(
                f"persistent straggler: host {flagged_now} has been > "
                f"{self.factor:g}x the median of the other hosts' step "
                f"time for >= {self.patience} consecutive observations "
                f"(latest {dict(times)[flagged_now] * 1e3:.1f}ms vs peer "
                f"median {flagged_med * 1e3:.1f}ms)"
            )
        if self.tracer is not None:
            self.tracer.counter("straggler_flags", self.straggler_flags)
        return summary

    def counters(self) -> Dict[str, float]:
        """Named counters for the metrics extras / ring buffer: total
        flags raised plus the currently-flagged host (-1 = none)."""
        return {
            "straggler_flags": float(self.straggler_flags),
            "straggler_host": float(self.straggler_host),
        }
