"""ST8xx — the per-entry communication budget gate.

The collectives each audit entry issues (``entry_audit.py``, recorded by
``recorder.py``) — per mesh axis (counts and payload MB) and per
(op, dtype) (ring-model wire MB) — are checked into
``scaletorch_tpu_torch/comm_budget.json``, and the gate fails when a
change regresses bytes or adds an unbudgeted collective:

ST801  an unbudgeted collective appeared (a new (op, dtype) wire class
       or a new axis group) — cross-rank traffic this entry never paid
       before
ST802  a budgeted quantity regressed beyond tolerance (per-key wire MB,
       per-axis payload MB or count, or the entry total)
ST803  the budget file is missing or malformed, or an audited entry has
       no budget — the gate cannot run blind

With the dp gradient mean configured int8, a silent fall-back to fp32
shows up BOTH as ST701 (``entry_audit``) and as an ST802 byte
regression on ``all-reduce:f32`` — two independent detectors.

Re-baselining after an INTENTIONAL comm change:
``python -m scaletorch_tpu_torch.analysis --tier deep --write-budget``;
commit the JSON and say what changed and why. The file records the torch
version that wrote it; under another torch a regression reports as a
warning (re-baseline advice), and deep-tier warnings do not gate the
CLI's exit code.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from .core import Finding

DEFAULT_BUDGET = Path(__file__).resolve().parent.parent / "comm_budget.json"
# Allowed growth before a budgeted quantity counts as regressed —
# covers float noise and benign instruction-scheduling drift.
DEFAULT_TOLERANCE_PCT = 10.0
# Absolute slack in MB: keys whose budget rounds to ~0 (scalar loss
# means, per-block scales) must not fail on +0.0004 MB of noise.
_ABS_SLACK_MB = 0.01

_BUDGET_FILE = "scaletorch_tpu_torch/comm_budget.json"  # finding location


def write_budget(
    path: Path, reports: Dict[str, dict], tolerance_pct: float =
    DEFAULT_TOLERANCE_PCT,
) -> None:
    """Persist per-entry comm reports as the checked-in budget."""
    doc = {
        "version": 1,
        "torch": torch.__version__,
        "tolerance_pct": tolerance_pct,
        "note": (
            "Per-entry collective budget (scaletorch_tpu_torch/analysis/"
            "budget.py). axes: recorded collectives per mesh axis group; "
            "hlo: wire bytes per (op, dtype) under the ring cost model "
            "(analysis/recorder.py), dtypes in HLO names. Regenerate "
            "after an INTENTIONAL comm change with `python -m "
            "scaletorch_tpu_torch.analysis --tier deep --write-budget` "
            "and explain the diff."
        ),
        "entries": reports,
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n",
                    encoding="utf-8")


def load_budget(path: Path) -> dict:
    """Parse the budget file; raises ValueError on unreadable/malformed
    content (the CLI maps that to a usage error, like a typo'd path)."""
    try:
        doc = json.loads(path.read_text(encoding="utf-8"))
    except OSError as exc:
        raise ValueError(f"cannot read comm budget {path}: {exc}") from exc
    except json.JSONDecodeError as exc:
        raise ValueError(
            f"comm budget {path} is not valid JSON: {exc}") from exc
    if not isinstance(doc, dict) or not isinstance(doc.get("entries"), dict):
        raise ValueError(
            f"comm budget {path} is malformed: expected an object with an "
            "'entries' mapping"
        )
    return doc


def check_budget(
    reports: Dict[str, dict],
    budget_doc: dict,
    *,
    tolerance_pct: Optional[float] = None,
) -> List[Finding]:
    """Compare freshly-audited comm reports against the checked-in
    budget. Every finding lands on the budget file, the file a
    re-baseline would touch."""
    same_torch = budget_doc.get("torch") in (None, torch.__version__)
    severity = "error" if same_torch else "warning"
    drift_note = (
        "" if same_torch else
        f" [torch {budget_doc.get('torch')} budget vs a different installed "
        "torch — if the regression is release drift, re-baseline with "
        "--write-budget]"
    )
    tol = (
        tolerance_pct if tolerance_pct is not None
        else float(budget_doc.get("tolerance_pct", DEFAULT_TOLERANCE_PCT))
    )
    entries = budget_doc["entries"]
    out: List[Finding] = []

    def regressed(now: float, budgeted: float) -> bool:
        return now > budgeted * (1.0 + tol / 100.0) + _ABS_SLACK_MB

    for name, report in sorted(reports.items()):
        budget = entries.get(name)
        if budget is None:
            out.append(Finding(
                file=_BUDGET_FILE, line=1, code="ST803", severity="error",
                message=(
                    f"audited entry {name!r} has no comm budget — add it "
                    "with --write-budget so its collectives are gated"
                ),
            ))
            continue
        out.extend(_check_keyed(
            name, "hlo", "wire_mb", report.get("hlo", {}),
            budget.get("hlo", {}), regressed, severity, drift_note,
        ))
        out.extend(_check_keyed(
            name, "axes", "payload_mb", report.get("axes", {}),
            budget.get("axes", {}), regressed, severity, drift_note,
        ))
        now_total = float(report.get("total_wire_mb", 0.0))
        budget_total = float(budget.get("total_wire_mb", 0.0))
        if regressed(now_total, budget_total):
            out.append(Finding(
                file=_BUDGET_FILE, line=1, code="ST802", severity=severity,
                message=(
                    f"entry {name!r}: total wire bytes regressed — "
                    f"{now_total:.4f} MB vs budgeted {budget_total:.4f} MB "
                    f"(tolerance {tol:g}%){drift_note}"
                ),
            ))
    return out


def _check_keyed(
    entry: str,
    section: str,
    mb_field: str,
    now: Dict[str, dict],
    budgeted: Dict[str, dict],
    regressed,
    severity: str,
    drift_note: str,
) -> List[Finding]:
    out: List[Finding] = []
    label = "wire class" if section == "hlo" else "axis group"
    for key in sorted(now):
        slot = now[key]
        ref = budgeted.get(key)
        if ref is None:
            out.append(Finding(
                file=_BUDGET_FILE, line=1, code="ST801", severity=severity,
                message=(
                    f"entry {entry!r}: unbudgeted {label} {key!r} "
                    f"({int(slot.get('count', 0))} collective(s), "
                    f"{float(slot.get(mb_field, 0.0)):.4f} MB) — new "
                    "cross-member traffic; if intentional, re-baseline "
                    f"with --write-budget{drift_note}"
                ),
            ))
            continue
        now_mb = float(slot.get(mb_field, 0.0))
        ref_mb = float(ref.get(mb_field, 0.0))
        if regressed(now_mb, ref_mb):
            out.append(Finding(
                file=_BUDGET_FILE, line=1, code="ST802", severity=severity,
                message=(
                    f"entry {entry!r}: {label} {key!r} regressed — "
                    f"{now_mb:.4f} MB vs budgeted {ref_mb:.4f} MB"
                    f"{drift_note}"
                ),
            ))
        now_n = int(slot.get("count", 0))
        ref_n = int(ref.get("count", 0))
        if now_n > ref_n:
            out.append(Finding(
                file=_BUDGET_FILE, line=1, code="ST802", severity=severity,
                message=(
                    f"entry {entry!r}: {label} {key!r} collective count "
                    f"grew {ref_n} -> {now_n} (per-collective latency is "
                    f"paid per instance){drift_note}"
                ),
            ))
    return out


def check_budget_path(
    reports: Dict[str, dict], path: Path
) -> Tuple[List[Finding], Optional[str]]:
    """(findings, usage_error). A missing/malformed budget file is a
    usage error string (exit 2 at the CLI), not a finding crash."""
    if not path.is_file():
        return [], (
            f"comm budget {path} not found — generate it with "
            "`python -m scaletorch_tpu_torch.analysis --tier deep "
            "--write-budget` (or pass --no-budget to skip the gate)"
        )
    try:
        doc = load_budget(path)
    except ValueError as exc:
        return [], str(exc)
    return check_budget(reports, doc), None
