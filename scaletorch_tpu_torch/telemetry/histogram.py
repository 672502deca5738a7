"""Log-bucketed latency histograms: fixed schema, mergeable, quantiles.

The latency-distribution half of the observability layer. A running
mean (``EngineMetrics.ttft_sum_s``) answers "how fast on average?" —
useless for serving, where the product question is always a tail:
"what is tenant X's p99 TTFT?". This module is the primitive that
answers it without storing samples:

  * **fixed bucket schema** — boundaries are log-spaced
    (``lo * growth**i``), identical for every histogram built from the
    same ``BucketSchema``. Two histograms with the same schema merge by
    adding bucket counts, which makes the type safe to ship across
    processes (JSONL records, replica aggregation in ``slo_check``)
    and to accumulate forever (fixed memory, no rebucketing).
  * **bounded quantile error** — a quantile estimate lands in the same
    bucket as the true order statistic, so the relative error is at
    most ``growth`` (√2 by default), and estimates are clamped to the
    observed ``[min, max]``. Property-tested against a sorted-sample
    oracle in tests/test_histogram.py.
  * **Prometheus-native** — ``cumulative()`` yields the ``le``-labeled
    cumulative counts a real ``histogram`` exposition needs
    (``_bucket`` / ``_sum`` / ``_count``; telemetry/export.py renders
    it), and ``to_dict()``/``from_dict()`` round-trip sparsely for the
    v:1-additive ``latency_histograms`` JSONL kind.

``TenantHistograms`` is the registry the gateway records into: one
histogram per (metric, tenant) with a cardinality cap — tenant names
are untrusted client input, so beyond ``max_labels`` distinct labels a
metric aggregates new ones under ``"_other"`` instead of growing
without bound.

Pure stdlib: a copy of ``scaletorch_tpu/telemetry/histogram.py`` kept
in the PyTorch package so that the port never imports the JAX package.
The two must stay byte-compatible in their ``to_dict()`` records, so a
histogram written by either side merges into the other.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "BucketSchema",
    "DEFAULT_SCHEMA",
    "LogHistogram",
    "TenantHistograms",
    "OVERFLOW_LABEL",
]

# Where over-cap tenant labels aggregate (see TenantHistograms).
OVERFLOW_LABEL = "_other"


class BucketSchema:
    """Log-spaced bucket boundaries, fixed at construction.

    Bucket ``i`` (0-indexed) covers ``(bounds[i-1], bounds[i]]`` with
    ``bounds[i] = lo * growth**i``; values ``<= lo`` land in bucket 0
    and values above the top boundary in the overflow bucket (index
    ``count``, ``le="+Inf"``). The default spans 100 µs to ~5 days at
    √2 resolution — every latency the serving path measures (TPOT
    microseconds through queue-wait minutes) fits one schema, which is
    what keeps every histogram in the system mergeable.
    """

    __slots__ = ("lo", "growth", "count", "bounds")

    def __init__(self, lo: float = 1e-4, growth: float = math.sqrt(2.0),
                 count: int = 64) -> None:
        if lo <= 0:
            raise ValueError(f"lo must be > 0, got {lo}")
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        self.lo = float(lo)
        self.growth = float(growth)
        self.count = int(count)
        self.bounds: Tuple[float, ...] = tuple(
            self.lo * self.growth ** i for i in range(self.count))

    def index(self, value: float) -> int:
        """Bucket index of ``value`` (``count`` = overflow)."""
        if value <= self.bounds[0]:
            return 0
        return bisect_left(self.bounds, value)

    def key(self) -> Tuple[float, float, int]:
        """Merge-compatibility identity."""
        return (self.lo, self.growth, self.count)

    def to_dict(self) -> Dict[str, Any]:
        return {"lo": self.lo, "growth": self.growth, "count": self.count}

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "BucketSchema":
        return cls(lo=obj["lo"], growth=obj["growth"], count=obj["count"])


DEFAULT_SCHEMA = BucketSchema()


class LogHistogram:
    """One latency distribution over a ``BucketSchema``.

    ``observe`` is the hot path: one ``bisect`` over the (64-entry)
    boundary tuple plus counter updates — cheap enough to run per
    generated token. Negative observations clamp to 0 (latencies are
    durations; a clock hiccup must not throw).
    """

    __slots__ = ("schema", "counts", "count", "sum", "min", "max")

    def __init__(self, schema: Optional[BucketSchema] = None) -> None:
        self.schema = schema or DEFAULT_SCHEMA
        # counts[i] for i < schema.count are the finite buckets;
        # counts[schema.count] is the +Inf overflow bucket
        self.counts: List[int] = [0] * (self.schema.count + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float) -> None:
        if value < 0:
            value = 0.0
        self.counts[self.schema.index(value)] += 1
        self.count += 1
        self.sum += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value

    # ---- merging ---------------------------------------------------------
    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Fold ``other`` into this histogram in place (and return
        self). Schemas must be identical — the fixed-schema contract is
        what makes cross-process merging sound."""
        if self.schema.key() != other.schema.key():
            raise ValueError(
                f"cannot merge histograms with different bucket schemas: "
                f"{self.schema.key()} vs {other.schema.key()}")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        if other.min is not None and (self.min is None
                                      or other.min < self.min):
            self.min = other.min
        if other.max is not None and (self.max is None
                                      or other.max > self.max):
            self.max = other.max
        return self

    @staticmethod
    def combined(a: "LogHistogram", b: "LogHistogram") -> "LogHistogram":
        """Pure merge: a fresh histogram holding ``a + b`` (the
        associativity property test's subject)."""
        out = LogHistogram(a.schema)
        out.merge(a)
        out.merge(b)
        return out

    # ---- quantiles -------------------------------------------------------
    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile estimate, linearly interpolated within
        its bucket and clamped to the observed ``[min, max]``. The
        estimate shares a bucket with the true order statistic, so the
        relative error is bounded by the schema's ``growth``. None when
        empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return None
        rank = max(1, math.ceil(q * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i >= self.schema.count:
                    # overflow bucket: the max is the only bound we have
                    est = self.max
                else:
                    lower = self.schema.bounds[i - 1] if i > 0 else 0.0
                    upper = self.schema.bounds[i]
                    frac = (rank - cum) / c
                    est = lower + frac * (upper - lower)
                return min(max(est, self.min), self.max)
            cum += c
        return self.max  # unreachable: counts sum to self.count

    # ---- exposition ------------------------------------------------------
    def occupied_finite_buckets(self) -> int:
        """Finite buckets up to and including the highest occupied one
        (the natural ``cumulative()`` emission length)."""
        return max(
            (i for i, c in enumerate(self.counts[:-1]) if c), default=-1
        ) + 1

    def cumulative(
        self, min_buckets: Optional[int] = None
    ) -> List[Tuple[Optional[float], int]]:
        """``(le, cumulative_count)`` pairs for the Prometheus
        ``_bucket`` series; ``le=None`` is the terminal ``+Inf``
        bucket. Empty finite buckets below the highest occupied one are
        included (cumulative counts must be complete); the tail of
        never-touched buckets is elided to keep expositions small.
        ``min_buckets`` forces at least that many finite buckets out —
        the family renderer passes the max across a family's series so
        every series exposes the SAME ``le`` set (summing cumulative
        counts across series per ``le`` — what Prometheus and
        slo_check's scrape parser do — stays monotone)."""
        out: List[Tuple[Optional[float], int]] = []
        cum = 0
        emit = self.occupied_finite_buckets()
        if min_buckets is not None:
            emit = min(max(emit, min_buckets), self.schema.count)
        for i in range(emit):
            cum += self.counts[i]
            out.append((self.schema.bounds[i], cum))
        out.append((None, self.count))
        return out

    # ---- serialization ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """Sparse JSON form (only occupied buckets) for the
        ``latency_histograms`` JSONL kind."""
        return {
            "schema": self.schema.to_dict(),
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "buckets": {str(i): c for i, c in enumerate(self.counts) if c},
        }

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "LogHistogram":
        h = cls(BucketSchema.from_dict(obj["schema"]))
        for key, c in obj.get("buckets", {}).items():
            i = int(key)
            if not 0 <= i <= h.schema.count:
                raise ValueError(f"bucket index {i} outside the schema")
            h.counts[i] = int(c)
        h.count = int(obj["count"])
        h.sum = float(obj["sum"])
        h.min = obj.get("min")
        h.max = obj.get("max")
        if sum(h.counts) != h.count:
            raise ValueError(
                f"bucket counts sum to {sum(h.counts)} but count is "
                f"{h.count}")
        return h


class TenantHistograms:
    """Per-(metric, label) histogram registry with a cardinality cap.

    The gateway records request latencies here keyed by tenant — an
    untrusted client string, so distinct labels per metric are capped
    at ``max_labels``; later labels aggregate under ``_other`` (their
    observations are kept, only the attribution coarsens). All
    histograms share one schema, so ``merged()`` (the all-tenant
    aggregate the SLO gate evaluates) and cross-process record merging
    are plain bucket addition.
    """

    def __init__(self, metrics: Sequence[str], *,
                 schema: Optional[BucketSchema] = None,
                 max_labels: int = 64) -> None:
        if max_labels < 1:
            raise ValueError(f"max_labels must be >= 1, got {max_labels}")
        self.metrics = tuple(metrics)
        self.schema = schema or DEFAULT_SCHEMA
        self.max_labels = max_labels
        self._data: Dict[str, Dict[str, LogHistogram]] = {
            m: {} for m in self.metrics}

    def observe(self, metric: str, label: str, value: float) -> None:
        series = self._data[metric]
        h = series.get(label)
        if h is None:
            if len(series) >= self.max_labels:
                label = OVERFLOW_LABEL
                h = series.get(label)
            if h is None:
                h = series[label] = LogHistogram(self.schema)
        h.observe(value)

    def get(self, metric: str, label: str) -> Optional[LogHistogram]:
        return self._data[metric].get(label)

    def series(self, metric: str) -> Dict[str, LogHistogram]:
        """label -> histogram (the /metrics exposition's view)."""
        return dict(self._data[metric])

    def merged(self, metric: str) -> Optional[LogHistogram]:
        """All labels folded into one histogram (None when empty) —
        the aggregate the SLO evaluation and live snapshots read."""
        out: Optional[LogHistogram] = None
        for h in self._data[metric].values():
            if out is None:
                out = LogHistogram(self.schema)
            out.merge(h)
        return out

    def total_count(self) -> int:
        return sum(h.count for series in self._data.values()
                   for h in series.values())

    # ---- serialization ---------------------------------------------------
    def to_record(self) -> Dict[str, Any]:
        """Flat JSON record for the ``latency_histograms`` JSONL kind:
        ``{metric: {label: sparse-histogram}}``."""
        return {
            metric: {label: h.to_dict() for label, h in series.items()}
            for metric, series in self._data.items() if series
        }

    def merge_record(self, record: Dict[str, Any]) -> None:
        """Fold one ``to_record()`` payload in (slo_check merging the
        JSONL stream back together). Unknown metrics are adopted."""
        for metric, series in record.items():
            if not isinstance(series, dict):
                continue
            dest = self._data.setdefault(metric, {})
            for label, obj in series.items():
                h = LogHistogram.from_dict(obj)
                if h.schema.key() != self.schema.key():
                    raise ValueError(
                        f"record for {metric}/{label} uses a different "
                        f"bucket schema: {h.schema.key()} vs "
                        f"{self.schema.key()}")
                if label in dest:
                    dest[label].merge(h)
                else:
                    dest[label] = h
