"""Grade serving telemetry against the SLO presets (the CI gate).

Counterpart of the reference's ``tools/slo_check.py`` over the port's
gateway: reads any mix of its observability artifacts and evaluates
them against one preset of ``serving/slo.json`` (the grammar of
``serving/slo.py``):

  * telemetry JSONL streams (positional args): per-request ``access``
    records are the primary source (exact latency samples and outcome
    counts); ``latency_histograms`` records are merged (the last
    snapshot of each process) and answer any metric without exact
    samples; the last ``gateway_metrics`` record gives the outcome
    counts when no access record exists;
  * ``--prom metrics.txt``: a scraped ``/metrics`` page, whose
    ``scaletorch_request_<metric>_seconds_bucket`` series are rebuilt
    (summed over tenant labels) and whose ``scaletorch_http_<outcome>``
    counters give the outcomes.

Usage (from the root of a checkout):
    python -m scaletorch_tpu_torch.tools.slo_check --preset tiny \\
        telemetry/gateway_events.jsonl [more.jsonl] [--prom metrics.txt]

Exit codes: 0 within the SLO, 1 a violation, 2 a usage error (missing
or malformed inputs). Its own imports are the standard library and
the port's standard-library modules (``serving/slo.py``,
``telemetry/histogram.py``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
from typing import Any, Dict, List, Optional, Tuple

from scaletorch_tpu_torch.serving.slo import (
    DEFAULT_SLO_PATH,
    LATENCY_OUTCOMES,
    evaluate_slo,
    format_report,
    load_slo,
    preset_targets,
)
from scaletorch_tpu_torch.telemetry.histogram import LogHistogram

# The gateway's histogram metric names and their access-record fields.
METRIC_FIELDS = {
    "ttft": "ttft_s",
    "queue_wait": "queue_wait_s",
    "prefill": "prefill_s",
    "e2e": "e2e_s",
    # tpot has no per-request scalar (it is per-token); histogram /
    # prometheus sources cover it
}

# The terminal-outcome taxonomy (written out: this tool imports nothing
# of the inference package).
OUTCOMES = ("ok", "shed", "timeout", "rejected", "quarantined", "aborted")

# the label block is matched GREEDILY up to the last '}' before the
# value: '}' is a legal character inside a quoted Prometheus label
# value (only \, " and newline are escaped), and tenant names are
# untrusted client strings — [^}]* would silently drop every series of
# a tenant named e.g. 'a}b' from the SLO evaluation
_PROM_LINE_RE = re.compile(r"^([A-Za-z0-9_:]+)(?:\{(.*)\})?\s+(\S+)$")
_PROM_LABEL_RE = re.compile(r'([A-Za-z0-9_]+)="((?:[^"\\]|\\.)*)"')
_PROM_BUCKET_RE = re.compile(
    r"^scaletorch_request_([a-z0-9_]+)_seconds_bucket$")


class PromHistogram:
    """A histogram reconstructed from ``_bucket`` exposition lines:
    (le, cumulative-count) pairs summed over label sets."""

    def __init__(self) -> None:
        self._by_le: Dict[float, int] = {}

    def add(self, le: float, count: int) -> None:
        self._by_le[le] = self._by_le.get(le, 0) + count

    def quantile(self, q: float) -> Optional[float]:
        if not self._by_le:
            return None
        pairs = sorted(self._by_le.items())
        total = pairs[-1][1]  # +Inf bucket is the largest le
        if total <= 0:
            return None
        rank = max(1, math.ceil(q * total))
        prev_le, prev_cum = 0.0, 0
        for le, cum in pairs:
            if cum >= rank:
                if math.isinf(le):
                    return prev_le  # best bound available
                frac = (rank - prev_cum) / max(1, cum - prev_cum)
                return prev_le + frac * (le - prev_le)
            prev_le, prev_cum = le, cum
        return pairs[-1][0]


def read_jsonl(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for n, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as exc:
                raise ValueError(f"{path}:{n}: bad JSONL line: {exc}")
    return out


def parse_prom_text(text: str) -> Tuple[Dict[str, PromHistogram],
                                        Dict[str, int]]:
    """(histograms by metric, outcome counts) from a /metrics scrape."""
    hists: Dict[str, PromHistogram] = {}
    outcomes: Dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        match = _PROM_LINE_RE.match(line)
        if match is None:
            continue
        name, raw_labels, raw_value = match.groups()
        try:
            value = float(raw_value)
        except ValueError:
            continue
        bucket = _PROM_BUCKET_RE.match(name)
        if bucket is not None:
            labels = dict(_PROM_LABEL_RE.findall(raw_labels or ""))
            le_text = labels.get("le", "")
            le = float("inf") if le_text == "+Inf" else float(le_text)
            hists.setdefault(bucket.group(1), PromHistogram()).add(
                le, int(value))
            continue
        for outcome in OUTCOMES:
            if name == f"scaletorch_http_{outcome}":
                outcomes[outcome] = outcomes.get(outcome, 0) + int(value)
    return hists, outcomes


def collect(paths: List[str], prom_path: Optional[str]):
    """Fold every input into (samples, merged histograms, outcomes,
    prom histograms)."""
    samples: Dict[str, List[float]] = {m: [] for m in METRIC_FIELDS}
    merged: Dict[str, LogHistogram] = {}
    access_outcomes: Dict[str, int] = {}
    gw_metrics_last: Optional[dict] = None
    for path in paths:
        # latency_histograms records are CUMULATIVE snapshots of one
        # process's registry (the gateway re-emits its whole state on
        # the export cadence) — merging every record would multi-count
        # early observations, so only the LAST snapshot per process per
        # stream counts; merging happens across processes/streams.
        last_hists: Dict[Any, dict] = {}
        for event in read_jsonl(path):
            kind = event.get("kind")
            if kind == "access":
                outcome = event.get("outcome", "unknown")
                access_outcomes[outcome] = \
                    access_outcomes.get(outcome, 0) + 1
                served = outcome in LATENCY_OUTCOMES
                for metric, fname in METRIC_FIELDS.items():
                    # ttft mirrors the gateway histograms: observed at
                    # token arrival, so a present sample is real served
                    # latency whatever the eventual outcome (an aborted
                    # stream's first token still arrived). The terminal
                    # latencies (queue_wait/prefill/e2e) count for
                    # SERVED outcomes only — a refusal terminates in
                    # microseconds and would drag the quantiles DOWN
                    # under the exact overload the SLO exists to catch.
                    if metric != "ttft" and not served:
                        continue
                    value = event.get(fname)
                    if isinstance(value, (int, float)) \
                            and not isinstance(value, bool):
                        samples[metric].append(float(value))
            elif kind == "latency_histograms":
                last_hists[event.get("proc", 0)] = event
            elif kind == "gateway_metrics":
                gw_metrics_last = event
        for event in last_hists.values():
            for metric, series in event.items():
                if metric in ("v", "kind", "time", "proc") \
                        or not isinstance(series, dict):
                    continue
                for _label, obj in series.items():
                    if not isinstance(obj, dict) \
                            or "buckets" not in obj:
                        continue
                    h = LogHistogram.from_dict(obj)
                    if metric in merged:
                        merged[metric].merge(h)
                    else:
                        merged[metric] = h

    outcomes = access_outcomes
    if not outcomes and gw_metrics_last is not None:
        outcomes = {o: int(gw_metrics_last.get(f"http_{o}", 0))
                    for o in OUTCOMES}

    prom_hists: Dict[str, PromHistogram] = {}
    if prom_path is not None:
        with open(prom_path) as f:
            prom_hists, prom_outcomes = parse_prom_text(f.read())
        if not outcomes:
            outcomes = prom_outcomes
    return samples, merged, outcomes, prom_hists


def make_quantile_fn(samples, merged, prom_hists):
    """Exact samples win; merged JSONL histograms next; a /metrics
    scrape last."""

    def quantile(metric: str, q: float) -> Optional[float]:
        exact = samples.get(metric)
        if exact:
            ordered = sorted(exact)
            return ordered[min(len(ordered) - 1,
                               max(0, math.ceil(q * len(ordered)) - 1))]
        if metric in merged:
            return merged[metric].quantile(q)
        if metric in prom_hists:
            return prom_hists[metric].quantile(q)
        return None

    return quantile


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("events", nargs="*",
                        help="telemetry JSONL file(s): access / "
                             "latency_histograms / gateway_metrics kinds")
    parser.add_argument("--slo", default=DEFAULT_SLO_PATH,
                        help="SLO target file (default the package's "
                             "serving/slo.json)")
    parser.add_argument("--preset", required=True,
                        help="preset name inside the SLO file")
    parser.add_argument("--prom", default=None,
                        help="a scraped /metrics exposition to evaluate "
                             "(histogram _bucket series + http_* counters)")
    args = parser.parse_args(argv)

    if not args.events and args.prom is None:
        print("slo_check: provide at least one JSONL file or --prom",
              file=sys.stderr)
        return 2
    try:
        doc = load_slo(args.slo)
        spec = preset_targets(doc, args.preset)
        for path in list(args.events) + ([args.prom] if args.prom else []):
            if not os.path.exists(path):
                raise ValueError(f"input file not found: {path}")
        samples, merged, outcomes, prom_hists = collect(
            args.events, args.prom)
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        print(f"slo_check: {exc}", file=sys.stderr)
        return 2

    result = evaluate_slo(
        spec, quantile_fn=make_quantile_fn(samples, merged, prom_hists),
        outcomes=outcomes)
    print(format_report(args.preset, result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
