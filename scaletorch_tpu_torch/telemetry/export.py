"""Machine-readable telemetry export: JSONL event stream + Prometheus
(counterpart of scaletorch_tpu/telemetry/export.py).

The consumers the ROADMAP names — a load-aware serving scheduler, fleet
log aggregation, the future front door's admission control — all need
metrics they can *parse*, not console lines. Two surfaces:

  * ``TelemetryExporter`` — an append-only JSONL stream (one event per
    line) merging the trainer's ``MetricsLogger`` step records and the
    engine's ``EngineMetrics`` snapshots into ONE schema-versioned
    format. Each line carries ``v`` (schema version), ``kind``
    (one of ``KNOWN_KINDS`` — ``train_step`` / ``engine_metrics`` /
    ``gateway_metrics`` — or free-form), ``time`` and ``proc``; the
    rest is the flat numeric record. Version policy: additive field
    changes keep ``v``; renames/removals/semantic changes bump it
    (the reference's docs/observability.md).
  * ``PrometheusEndpoint`` — an optional stdlib-only HTTP endpoint
    serving the text exposition format from a caller-supplied
    ``metrics_fn`` (e.g. ``engine.metrics.snapshot``), so live
    occupancy/TTFT is scrapeable without adding dependencies. Bind
    port 0 for an ephemeral port (tests); the serving front door reads
    ``endpoint.port`` after ``start()``.

Both are pure host-side I/O — nothing here touches a device value.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import IO, Any, Callable, Dict, Optional

from scaletorch_tpu_torch.utils.logger import get_logger

# Bump on renames/removals/semantic changes; additive fields keep it.
SCHEMA_VERSION = 1

# The event kinds the framework itself emits on the JSONL stream — ONE
# schema, no parallel pipelines: the trainer's per-step records
# (trainer/metrics.py), the engine's EngineMetrics snapshots
# (inference/engine.py), the gateway's GatewayMetrics snapshots
# (serving/gateway.py: per-tenant queue depth, shed/429 counts, SSE
# streams open, router prefix-hit rate), the gateway's per-request
# ``access`` records (one per terminal HTTP outcome: tenant, outcome,
# status, trace_id, queue_wait/ttft/e2e, tokens, prefix_hit, replica)
# and its ``latency_histograms`` records (TenantHistograms.to_record —
# sparse per-tenant bucket state, mergeable offline by slo_check).
# ``warmup`` records one peer-to-peer warm-rejoin attempt per restart
# (replica, status warmed/partial/cold, donor, pages, seconds,
# chunks_dropped, attempts). ``membership`` records one elastic-fleet
# transition per rank (resilience_distributed.ElasticCoordinator:
# transition steady/suspect/shrink/grow/join/parked, epoch, members,
# num_hosts, rank, lost, joined, step). ``disagg`` records the
# disaggregated engine's per-slice state alongside each
# ``engine_metrics`` snapshot (inference/disagg.py: slice device
# counts, handoff counters/bytes, prefill-pool occupancy, per-slice
# busy fractions). Free-form kinds are allowed;
# these are the ones consumers can rely on. Adding a kind is additive —
# v stays 1.
KNOWN_KINDS = ("train_step", "engine_metrics", "gateway_metrics",
               "access", "latency_histograms", "supervisor", "warmup",
               "membership", "disagg")


class TelemetryExporter:
    """Append-only JSONL event stream (one line per event, flushed per
    line so a crash loses at most the in-flight event)."""

    def __init__(self, path: str, *, process_index: int = 0) -> None:
        self.path = path
        self.process_index = process_index
        self.events_written = 0
        self._lock = threading.Lock()
        self._file: Optional[IO[str]] = None
        self._closed = False

    def emit(self, kind: str, record: Dict[str, Any]) -> None:
        """Write one event line. ``record`` must be JSON-serialisable
        (flat numeric dicts from MetricsLogger / EngineMetrics are);
        non-serialisable values are repr'd rather than dropped."""
        line = json.dumps(
            {
                "v": SCHEMA_VERSION,
                "kind": kind,
                "time": time.time(),
                "proc": self.process_index,
                **record,
            },
            default=repr,
        )
        with self._lock:
            if self._closed:
                return
            if self._file is None:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                self._file = open(self.path, "a")
            self._file.write(line + "\n")
            self._file.flush()
            self.events_written += 1

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._file is not None:
                self._file.close()
                self._file = None


def read_jsonl(path: str) -> list:
    """Read an exported stream back (tests / offline analysis)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


_METRIC_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

_METRIC_TYPES = ("gauge", "counter", "histogram")


def sanitize_metric_name(name: str) -> str:
    return _METRIC_NAME_RE.sub("_", str(name))


def escape_label_value(value: str) -> str:
    """Prometheus exposition label-value escaping. Label values carry
    UNTRUSTED client strings (tenant names reach /metrics verbatim), so
    backslash, double-quote and newline must be escaped or a hostile
    tenant name corrupts — or fabricates — exposition lines."""
    return (str(value).replace("\\", "\\\\")
            .replace("\n", "\\n").replace('"', '\\"'))


def format_labels(labels: Optional[Dict[str, Any]]) -> str:
    """``{k: v}`` -> ``{k="v",...}`` (sorted, escaped); "" when empty."""
    if not labels:
        return ""
    inner = ",".join(
        f'{sanitize_metric_name(k)}="{escape_label_value(v)}"'
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _format_le(le: Optional[float]) -> str:
    return "+Inf" if le is None else format(float(le), ".12g")


def render_families(families, *, namespace: str = "scaletorch") -> str:
    """Structured metric families -> Prometheus text exposition (0.0.4).

    Each family is a dict: ``{"name", "type"}`` plus

      * gauge/counter — ``"samples": [(labels_or_None, value)]``;
      * histogram — ``"series": [(labels_or_None, hist)]`` where
        ``hist`` quacks like ``telemetry.histogram.LogHistogram``
        (``cumulative()`` yielding ``(le_or_None, cum_count)``, plus
        ``sum``/``count``): rendered as real ``_bucket``/``_sum``/
        ``_count`` series with an ``le`` label.

    Tenant and replica identities ride LABELS (escaped — they are
    untrusted client input), never the metric name."""
    lines = []
    for family in families:
        name = f"{namespace}_{sanitize_metric_name(family['name'])}"
        ftype = family.get("type", "gauge")
        if ftype not in _METRIC_TYPES:
            raise ValueError(
                f"family {family['name']!r}: type must be one of "
                f"{_METRIC_TYPES}, got {ftype!r}")
        lines.append(f"# TYPE {name} {ftype}")
        if ftype == "histogram":
            series = list(family.get("series", ()))
            # every series of one family must expose the SAME le set:
            # consumers sum cumulative counts across label sets per le
            # (Prometheus aggregation, slo_check's scrape parser), and
            # a series whose tail buckets are elided would make that
            # sum non-monotone — pad all to the family-wide maximum
            min_buckets = max(
                (h.occupied_finite_buckets() for _, h in series),
                default=0)
            for labels, hist in series:
                base = dict(labels or {})
                for le, cum in hist.cumulative(min_buckets=min_buckets):
                    lines.append(
                        f"{name}_bucket"
                        f"{format_labels({**base, 'le': _format_le(le)})}"
                        f" {int(cum)}")
                lines.append(
                    f"{name}_sum{format_labels(base)} {float(hist.sum)}")
                lines.append(
                    f"{name}_count{format_labels(base)} {int(hist.count)}")
            continue
        for labels, value in family.get("samples", ()):
            if isinstance(value, bool) or not isinstance(
                    value, (int, float)):
                continue
            lines.append(f"{name}{format_labels(labels)} {float(value)}")
    return "\n".join(lines) + "\n"


def render_prometheus(metrics: Dict[str, float],
                      *, namespace: str = "scaletorch") -> str:
    """Flat numeric dict -> Prometheus text exposition format (0.0.4).
    Non-numeric values are skipped; names are sanitised to the metric
    charset and prefixed with ``namespace_``. (The unlabeled-gauge
    convenience wrapper over ``render_families``.)"""
    return render_families(
        ({"name": key, "type": "gauge", "samples": [(None, metrics[key])]}
         for key in sorted(metrics)
         if not isinstance(metrics[key], bool)
         and isinstance(metrics[key], (int, float))),
        namespace=namespace)


class PrometheusEndpoint:
    """Minimal ``/metrics`` HTTP endpoint over a metrics callback.

    ``metrics_fn`` is called per scrape on the server thread — it must
    be cheap and sync-free (``EngineMetrics.snapshot`` and
    ``MetricsLogger.history[-1]`` both qualify). Scrape errors return
    500 and never propagate into the serving loop."""

    def __init__(
        self,
        metrics_fn: Callable[[], Dict[str, float]],
        *,
        port: int = 0,
        host: str = "127.0.0.1",
        namespace: str = "scaletorch",
    ) -> None:
        self.metrics_fn = metrics_fn
        self.namespace = namespace
        self._host = host
        self._requested_port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    def start(self) -> "PrometheusEndpoint":
        endpoint = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server contract)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                try:
                    body = render_prometheus(
                        endpoint.metrics_fn(), namespace=endpoint.namespace
                    ).encode()
                except Exception as exc:  # scrape must not kill serving
                    self.send_error(500, repr(exc))
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:  # quiet scrapes
                return

        self._server = ThreadingHTTPServer(
            (self._host, self._requested_port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="scaletorch-prometheus", daemon=True,
        )
        self._thread.start()
        get_logger().info(
            f"prometheus endpoint serving on "
            f"http://{self._host}:{self.port}/metrics"
        )
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "PrometheusEndpoint":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
