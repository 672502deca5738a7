"""Serving SLOs: checked-in latency/error-budget targets + evaluation.

A copy of scaletorch_tpu/serving/slo.py (standard library only); the
port's target file is ``serving/slo.json`` beside this module
(``DEFAULT_SLO_PATH``), a copy of the reference's ``tools/slo.json``.

The serving path now measures per-tenant latency distributions
(telemetry/histogram.py) and writes per-request ``access`` records —
this module is what turns those measurements into a VERDICT: a
checked-in target file (tools/slo.json) says what "healthy" means per
deployment preset, and ``evaluate_slo`` grades observed quantiles and
outcome counts against it. Three consumers share the logic:

  * ``tools/slo_check.py`` — the CI gate: evaluates the gateway-smoke
    artifacts (access/gateway_metrics JSONL, merged histogram records,
    or a /metrics Prometheus scrape) and exits non-zero on violation;
  * the gateway's ``/healthz`` — a live ``slo`` block computed from the
    in-process histograms, so an operator (or a load balancer) sees
    budget burn without running a tool;
  * tests — the evaluation is pure, so targets are property-testable.

Target grammar (one preset entry in slo.json):

    {"min_requests": 10,            # below this: insufficient data, pass
     "error_budget": 0.01,          # tolerated failure fraction
     "targets": {"ttft_p95_s": 2.0, # <metric>_p<Q>_s: latency quantile
                 "e2e_p99_9_s": 30.0}}   # p99_9 = p99.9

Failures against the error budget are the SERVER-fault outcomes only:
``timeout`` and ``quarantined``. ``shed`` (admission policy working as
designed), ``rejected`` (client error / terminal refusal) and
``aborted`` (client walked away) spend no budget — a load-shedding
gateway protecting its latency SLO must not fail its own error SLO for
doing so. Burn rate is ``error_rate / error_budget``: > 1.0 means the
window observed is burning budget faster than allowed.

Pure stdlib — no torch, no framework imports: slo_check runs on any
interpreter, exactly like the protocol/admission modules.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

# The port's checked-in targets (a copy of the reference's tools/slo.json).
DEFAULT_SLO_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "slo.json")

SLO_VERSION = 1

# Outcomes that spend error budget (see module docstring).
FAILURE_OUTCOMES = ("timeout", "quarantined")

# Outcomes whose terminal latencies feed the SLO quantiles: requests
# the gateway actually tried to serve. A shed/rejected refusal
# terminates in microseconds — folding those near-zero e2e values into
# the histograms would drag p99 DOWN during overload, making the
# latency SLO read healthiest exactly when served traffic is slowest.
LATENCY_OUTCOMES = ("ok", "timeout")

# <metric>_p<Q>_s, with _ as the decimal point in Q (p99_9 = 99.9).
_TARGET_RE = re.compile(r"^([a-z0-9_]+?)_p(\d+(?:_\d+)?)_s$")


def parse_target_key(key: str) -> Tuple[str, float]:
    """``"ttft_p95_s"`` -> ``("ttft", 0.95)``; raises on bad grammar."""
    match = _TARGET_RE.match(key)
    if match is None:
        raise ValueError(
            f"bad SLO target key {key!r}: expected <metric>_p<Q>_s "
            f"(e.g. ttft_p95_s, e2e_p99_9_s)")
    metric, q_text = match.groups()
    q = float(q_text.replace("_", "."))
    if not 0 < q < 100:
        raise ValueError(f"bad SLO target key {key!r}: quantile {q} "
                         f"must be in (0, 100)")
    return metric, q / 100.0


def validate_preset(name: str, spec: Dict[str, Any]) -> None:
    if not isinstance(spec, dict):
        raise ValueError(f"preset {name!r} must be an object")
    budget = spec.get("error_budget", 0.0)
    if not isinstance(budget, (int, float)) or isinstance(budget, bool) \
            or not 0.0 <= budget <= 1.0:
        raise ValueError(
            f"preset {name!r}: error_budget must be in [0, 1], "
            f"got {budget!r}")
    min_requests = spec.get("min_requests", 1)
    if not isinstance(min_requests, int) or isinstance(min_requests, bool) \
            or min_requests < 0:
        raise ValueError(
            f"preset {name!r}: min_requests must be an integer >= 0, "
            f"got {min_requests!r}")
    targets = spec.get("targets", {})
    if not isinstance(targets, dict):
        raise ValueError(f"preset {name!r}: targets must be an object")
    for key, limit in targets.items():
        parse_target_key(key)
        if not isinstance(limit, (int, float)) or isinstance(limit, bool) \
                or limit <= 0:
            raise ValueError(
                f"preset {name!r}: target {key} must be a positive "
                f"number of seconds, got {limit!r}")


def load_slo(path: str) -> Dict[str, Any]:
    """Read + validate an slo.json document."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("v") != SLO_VERSION:
        raise ValueError(
            f"{path}: expected an object with v={SLO_VERSION}, "
            f"got {doc.get('v') if isinstance(doc, dict) else type(doc)}")
    presets = doc.get("presets")
    if not isinstance(presets, dict) or not presets:
        raise ValueError(f"{path}: 'presets' must be a non-empty object")
    for name, spec in presets.items():
        validate_preset(name, spec)
    return doc


def preset_targets(doc: Dict[str, Any], preset: str) -> Dict[str, Any]:
    presets = doc["presets"]
    if preset not in presets:
        raise ValueError(
            f"unknown SLO preset {preset!r}; available: "
            f"{sorted(presets)}")
    return presets[preset]


def evaluate_slo(
    spec: Dict[str, Any],
    *,
    quantile_fn: Callable[[str, float], Optional[float]],
    outcomes: Dict[str, int],
) -> Dict[str, Any]:
    """Grade observations against one preset's targets.

    ``quantile_fn(metric, q)`` returns the observed quantile in seconds
    or None when that metric has no data (the check is then recorded as
    skipped, never a violation — e.g. TPOT with single-token traffic).
    ``outcomes`` are terminal-outcome counts (the engine's taxonomy). Below
    ``min_requests`` the verdict is ``ok`` with ``insufficient_data``
    set — a freshly booted gateway is not in violation.
    """
    total = sum(outcomes.values())
    failures = sum(outcomes.get(o, 0) for o in FAILURE_OUTCOMES)
    error_rate = failures / total if total else 0.0
    budget = float(spec.get("error_budget", 0.0))
    if error_rate == 0.0:
        burn_rate = 0.0
    elif budget > 0.0:
        burn_rate = error_rate / budget
    else:
        burn_rate = float("inf")
    min_requests = int(spec.get("min_requests", 1))

    result: Dict[str, Any] = {
        "ok": True,
        "requests": total,
        "failures": failures,
        "error_rate": error_rate,
        "error_budget": budget,
        "burn_rate": burn_rate,
        "checks": [],
        "violations": [],
    }
    if total < min_requests:
        result["insufficient_data"] = True
        return result

    if burn_rate > 1.0:
        result["ok"] = False
        result["violations"].append("error_budget")
    result["checks"].append({
        "name": "error_budget", "limit": budget,
        "observed": error_rate, "ok": burn_rate <= 1.0,
    })

    for key in sorted(spec.get("targets", {})):
        limit = float(spec["targets"][key])
        metric, q = parse_target_key(key)
        observed = quantile_fn(metric, q)
        check: Dict[str, Any] = {"name": key, "limit": limit,
                                 "observed": observed}
        if observed is None:
            check["ok"] = True
            check["skipped"] = "no data"
        else:
            check["ok"] = observed <= limit
            if not check["ok"]:
                result["ok"] = False
                result["violations"].append(key)
        result["checks"].append(check)
    return result


def format_report(preset: str, result: Dict[str, Any]) -> str:
    """Human-readable verdict (slo_check's stdout)."""
    lines = [f"SLO report — preset {preset!r}: "
             f"{'OK' if result['ok'] else 'VIOLATION'}"
             f"{' (insufficient data)' if result.get('insufficient_data') else ''}"]
    lines.append(
        f"  requests={result['requests']} failures={result['failures']} "
        f"error_rate={result['error_rate']:.4f} "
        f"budget={result['error_budget']:.4f} "
        f"burn_rate={result['burn_rate']:.2f}")
    for check in result["checks"]:
        if check.get("skipped"):
            status = "SKIP"
        else:
            status = "ok" if check["ok"] else "FAIL"
        unit = "s" if check["name"] != "error_budget" else ""
        observed = check["observed"]
        observed_s = "-" if observed is None else f"{observed:.4f}{unit}"
        lines.append(
            f"  [{status:>4}] {check['name']}: observed {observed_s} "
            f"vs limit {check['limit']:.4f}{unit}")
    return "\n".join(lines)


def failure_list(outcomes: Dict[str, int]) -> List[str]:
    """The outcomes counted against the budget (docs/tests helper)."""
    return [o for o in FAILURE_OUTCOMES if outcomes.get(o, 0)]
