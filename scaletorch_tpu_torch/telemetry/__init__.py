"""Unified observability of the port (counterpart of
scaletorch_tpu/telemetry/): spans, anomaly profiling, stragglers, export
and latency histograms.

One layer shared by the trainer and the inference engine:

  * ``spans``      — host-side span tracing (Chrome trace events and a
                     crash-report tail; never forces a device sync)
  * ``profiling``  — slow-step-triggered and manual ``torch.profiler``
                     windows, SIGUSR1 live snapshots
  * ``stragglers`` — per-host step and data-fetch times of a
                     multi-process run, riding the coordinated decision's
                     gather
  * ``export``     — schema-versioned JSONL event stream and an optional
                     Prometheus text endpoint
  * ``histogram``  — log-bucketed latency histograms

``Telemetry`` is the per-process facade: built from config (enabled by
``--telemetry_dir`` / ``SCALETORCH_TPU_TELEMETRY_DIR``), it owns the
tracer, exporter, profiler and snapshotter so the trainer and the
serving loop wire one object, not four. Disabled, every component is
``None`` and each instrumentation site costs one branch.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from scaletorch_tpu_torch.env import env_override
from scaletorch_tpu_torch.telemetry.export import (
    SCHEMA_VERSION,
    PrometheusEndpoint,
    TelemetryExporter,
    read_jsonl,
    render_families,
    render_prometheus,
)
from scaletorch_tpu_torch.telemetry.histogram import (
    DEFAULT_SCHEMA,
    BucketSchema,
    LogHistogram,
    TenantHistograms,
)
from scaletorch_tpu_torch.telemetry.profiling import (
    AnomalyProfiler,
    LiveSnapshotter,
    SlowStepDetector,
    TorchProfilerBackend,
    parse_profile_steps,
)
from scaletorch_tpu_torch.telemetry.spans import (
    NOOP_SPAN,
    SpanTracer,
    load_trace,
)
from scaletorch_tpu_torch.telemetry.stragglers import StragglerDetector
from scaletorch_tpu_torch.utils.logger import get_logger

__all__ = [
    "Telemetry",
    "SpanTracer",
    "NOOP_SPAN",
    "load_trace",
    "TelemetryExporter",
    "PrometheusEndpoint",
    "SCHEMA_VERSION",
    "BucketSchema",
    "DEFAULT_SCHEMA",
    "LogHistogram",
    "TenantHistograms",
    "read_jsonl",
    "render_families",
    "render_prometheus",
    "AnomalyProfiler",
    "SlowStepDetector",
    "TorchProfilerBackend",
    "LiveSnapshotter",
    "StragglerDetector",
    "parse_profile_steps",
    "telemetry_dir_from_config",
]


def telemetry_dir_from_config(cfg) -> Optional[str]:
    """Resolve the telemetry directory: the env var when PRESENT
    (including explicitly empty = off, the shared present-wins
    contract), else the config field."""
    value = env_override(
        "SCALETORCH_TPU_TELEMETRY_DIR",
        getattr(cfg, "telemetry_dir", None) or "",
    )
    return value or None


class Telemetry:
    """Per-process observability facade.

    Holds at most one of each: ``tracer`` (SpanTracer), ``exporter``
    (TelemetryExporter), ``profiler`` (AnomalyProfiler), ``snapshotter``
    (LiveSnapshotter) — any of which may be ``None`` when its surface
    is disabled, so call sites stay single-branch. ``disabled()`` is
    the canonical all-``None`` instance a loop can hold unconditionally.
    """

    def __init__(
        self,
        *,
        tracer: Optional[SpanTracer] = None,
        exporter: Optional[TelemetryExporter] = None,
        profiler: Optional[AnomalyProfiler] = None,
        snapshotter: Optional[LiveSnapshotter] = None,
        directory: Optional[str] = None,
    ) -> None:
        self.tracer = tracer
        self.exporter = exporter
        self.profiler = profiler
        self.snapshotter = snapshotter
        self.directory = directory

    @classmethod
    def disabled(cls) -> "Telemetry":
        return cls()

    @property
    def enabled(self) -> bool:
        return self.directory is not None

    @classmethod
    def from_config(cls, cfg, *, process_index: int = 0,
                    role: str = "train") -> "Telemetry":
        """Build the facade from a ``ScaleTorchTPUArguments``-shaped
        config. ``--telemetry_dir`` unset (and no env override) returns
        the disabled facade; profiling triggers are independent knobs
        within it."""
        directory = telemetry_dir_from_config(cfg)
        if directory is None:
            # config validation rejects profiler knobs without a dir;
            # this catches the env-only corner (SCALETORCH_TPU_PROFILE_
            # STEPS set, no dir anywhere) so the ask is never silent
            if env_override("SCALETORCH_TPU_PROFILE_STEPS", ""):
                get_logger().warning(
                    "SCALETORCH_TPU_PROFILE_STEPS is set but no telemetry "
                    "directory is configured — no profile will be captured"
                )
            return cls.disabled()
        tracer = SpanTracer(
            os.path.join(directory, f"trace_proc{process_index}.trace.json"),
            process_index=process_index,
            role=role,
            max_events=getattr(cfg, "trace_max_events", 200_000),
            tail_size=getattr(cfg, "span_tail_size", 256),
        )
        exporter = TelemetryExporter(
            os.path.join(directory, f"events_proc{process_index}.jsonl"),
            process_index=process_index,
        )
        profiler = None
        spike = float(getattr(cfg, "profile_on_slow_step", 0.0))
        manual = parse_profile_steps(str(env_override(
            "SCALETORCH_TPU_PROFILE_STEPS",
            getattr(cfg, "profile_steps", "") or "",
        )))
        if spike or manual is not None:
            profiler = AnomalyProfiler(
                directory,
                window_steps=getattr(cfg, "profile_window_steps", 3),
                spike_factor=spike,
                max_captures=getattr(cfg, "profile_max_captures", 1),
                profile_steps=manual,
            )
        snapshotter = LiveSnapshotter(directory)
        return cls(
            tracer=tracer, exporter=exporter, profiler=profiler,
            snapshotter=snapshotter, directory=directory,
        )

    # ---- convenience passthroughs (all single-branch when disabled) ------
    def span_tail(self, last_n: Optional[int] = None) -> List[dict]:
        return self.tracer.tail(last_n) if self.tracer is not None else []

    def export(self, kind: str, record: Dict[str, Any]) -> None:
        if self.exporter is not None:
            self.exporter.emit(kind, record)

    def flush(self) -> None:
        if self.tracer is not None:
            self.tracer.flush()

    def close(self) -> None:
        """Flush and terminate every surface (idempotent)."""
        if self.profiler is not None:
            self.profiler.close()
        if self.snapshotter is not None:
            self.snapshotter.uninstall()
        if self.tracer is not None:
            self.tracer.close()
        if self.exporter is not None:
            self.exporter.close()
