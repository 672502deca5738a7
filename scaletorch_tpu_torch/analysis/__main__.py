"""CLI: ``python -m scaletorch_tpu_torch.analysis [paths] [options]``.

The reference analyzer's flags, output format, exit codes and tier
grammar (``--tier`` takes one or a comma list: ``--tier deep,memory``
runs each audit entry once for both tiers):

* ``--tier ast`` (default) — the pure-AST passes (ST1xx-ST6xx + the
  ST9xx concurrency family). Never imports the code under analysis and
  touches no device.
* ``--tier concurrency`` — only the ST9xx family (thread roots,
  locksets, the telemetry kind registry).
* ``--tier ownership`` — the ST11xx resource-conservation tier
  (``ownership.py``'s CONTRACT table), pure-AST; composes with the
  others (``--tier ast,concurrency,ownership`` is one process).
* ``--tier deep`` — additionally runs the seven audit entries
  (``entry_audit.py``) on ``--device`` (the card by default; ``cpu``
  for the CPU run), the mesh entries under the ``fake`` process group,
  with the collective recorder on (ST7xx), and checks the per-entry comm
  budget (``scaletorch_tpu_torch/comm_budget.json``, ST8xx).
* ``--tier memory`` — runs the same entries and checks their measured
  memory (ST10xx, ``memory.py``) against the per-entry budget
  (``scaletorch_tpu_torch/hbm_budget.json``). Without a card, the deep
  and memory tiers on the default device exit 2 with "no CUDA device".

An unknown tier is a loud exit-2 usage error, like an unknown pass.
Exit codes: 0 clean (or all findings baselined), 1 findings or syntax
errors, 2 usage error (unknown tier/pass/entry, typo'd path, unreadable
or malformed baseline/budget file, no device). ``--write-baseline``
records the current AST findings as the allowlist (add a ``why`` to
each entry by hand); ``--write-budget`` / ``--write-hbm-budget`` record
the current comm / memory reports as their budgets.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from . import (
    CONCURRENCY_PASSES,
    FAMILIES,
    OWNERSHIP_PASSES,
    PASSES,
    analyze_paths,
    load_baseline,
    resolve_select,
    save_baseline,
    split_by_baseline,
)

DEFAULT_BASELINE = (Path(__file__).resolve().parent.parent
                    / "analysis_baseline.json")
PROG = "torchlint"


def _render_sarif(findings) -> str:
    """SARIF 2.1.0, byte-stable: sorted keys, fixed indent, and nothing
    run-dependent (no timestamps, no absolute paths) — the same tree
    always serializes to the same bytes, so the uploaded scan diffs
    clean between identical runs."""
    rules = sorted({f.code for f in findings})
    doc = {
        "$schema": "https://raw.githubusercontent.com/oasis-tcs/"
                   "sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": PROG,
                "rules": [{"id": code} for code in rules],
            }},
            "results": [{
                "ruleId": f.code,
                "level": "error" if f.severity == "error" else "warning",
                "message": {"text": f.message},
                "locations": [{"physicalLocation": {
                    "artifactLocation": {"uri": f.file},
                    "region": {"startLine": max(1, f.line)},
                }}],
            } for f in findings],
        }],
    }
    return json.dumps(doc, indent=2, sort_keys=True)


def _render_github(f) -> str:
    level = "error" if f.severity == "error" else "warning"
    # workflow-command escaping for the message payload
    msg = (f.message.replace("%", "%25").replace("\r", "%0D")
           .replace("\n", "%0A"))
    return (f"::{level} file={f.file},line={f.line},"
            f"title={PROG} {f.code}::{msg}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m scaletorch_tpu_torch.analysis",
        description="static analysis of the PyTorch port",
    )
    parser.add_argument(
        "paths", nargs="*", default=["scaletorch_tpu_torch"],
        help="files/directories to analyze (default: scaletorch_tpu_torch)",
    )
    parser.add_argument(
        "--tier", default="ast", metavar="TIER[,TIER...]",
        help="comma list of: 'ast' = pure-AST passes only (no device); "
             "'concurrency' = only the ST9xx thread-race/deadlock "
             "family; 'ownership' = the ST11xx resource-lifecycle tier "
             "(pure-AST, composes: --tier ast,concurrency,ownership); "
             "'deep' also runs the audit entries with the collective "
             "recorder and the comm-budget gate; 'memory' measures the "
             "same entries' memory against the hbm budget (e.g. --tier "
             "deep,memory runs each entry once for both)",
    )
    parser.add_argument(
        "--baseline", type=Path, default=None,
        help=f"baseline allowlist (default: {DEFAULT_BASELINE} if present)",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="report every finding, ignoring any baseline file",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="write current AST findings to the baseline file and exit 0",
    )
    parser.add_argument(
        "--select", default=None, metavar="PASS[,PASS...]",
        help="run only these passes or code families, case-insensitive "
             f"(passes: {', '.join(sorted(PASSES))}; families: "
             f"{', '.join(sorted(FAMILIES))} — e.g. --select ST9)",
    )
    parser.add_argument(
        "--extra-axes", default="", metavar="AXIS[,AXIS...]",
        help="additional mesh-axis names to treat as declared",
    )
    parser.add_argument(
        "--entries", default=None, metavar="NAME[,NAME...]",
        help="deep tier: audit only these manifest entries",
    )
    parser.add_argument(
        "--budget", type=Path, default=None,
        help="comm budget file (default: "
             "scaletorch_tpu_torch/comm_budget.json)",
    )
    parser.add_argument(
        "--write-budget", action="store_true",
        help="deep tier: write the current comm reports as the "
             "budget and skip the comparison",
    )
    parser.add_argument(
        "--no-budget", action="store_true",
        help="deep tier: skip the comm-budget comparison",
    )
    parser.add_argument(
        "--hbm-budget", type=Path, default=None,
        help="hbm budget file (default: "
             "scaletorch_tpu_torch/hbm_budget.json)",
    )
    parser.add_argument(
        "--write-hbm-budget", action="store_true",
        help="memory tier: write the current memory reports as "
             "the hbm budget and skip the comparison (a full write on "
             "the card also measures the slice rows plan_slice_split "
             "reads)",
    )
    parser.add_argument(
        "--no-hbm-budget", action="store_true",
        help="memory tier: skip the hbm-budget comparison",
    )
    parser.add_argument(
        "--report", type=Path, default=None,
        help="deep and memory tiers: write each entry's comm report, "
             "memory row, kernel launches and seconds to this JSON file",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="deep and memory tiers: the device the entries run on "
             "(default: cuda, the card; cpu for the CPU run)",
    )
    parser.add_argument(
        "--format", choices=("text", "json", "github", "sarif"),
        default="text",
        help="'github' emits GitHub Actions ::error/::warning "
             "annotations so findings render inline on PRs; 'sarif' "
             "emits a byte-stable SARIF 2.1.0 document for GitHub "
             "code scanning upload",
    )
    args = parser.parse_args(argv)

    known_tiers = ("ast", "concurrency", "ownership", "deep", "memory")
    tiers = [t.strip() for t in args.tier.split(",") if t.strip()]
    unknown = sorted(set(tiers) - set(known_tiers))
    if unknown or not tiers:
        # A typo'd tier must be a loud usage error, never a silently
        # green partial run — same contract as an unknown --select.
        print(
            f"error: unknown tier {', '.join(map(repr, unknown)) or '(empty)'}"
            f"; valid tiers: {', '.join(known_tiers)} "
            "(comma list, e.g. --tier deep,memory)",
            file=sys.stderr,
        )
        return 2

    if "deep" not in tiers and (
        args.write_budget or args.budget or args.no_budget
    ):
        print(
            "error: --write-budget/--budget/--no-budget need --tier deep",
            file=sys.stderr,
        )
        return 2
    if "memory" not in tiers and (
        args.hbm_budget or args.write_hbm_budget or args.no_hbm_budget
    ):
        print(
            "error: --hbm-budget/--write-hbm-budget/--no-hbm-budget need "
            "--tier memory",
            file=sys.stderr,
        )
        return 2
    need_run = "deep" in tiers or "memory" in tiers
    if (args.entries or args.report) and not need_run:
        print(
            "error: --entries/--report need --tier deep or --tier memory",
            file=sys.stderr,
        )
        return 2

    select = [s.strip() for s in args.select.split(",") if s.strip()] \
        if args.select else None
    # The pass pool the AST-tier part of this run draws from. `ast`
    # means every default pass; `concurrency`/`ownership` add (or, with
    # no `ast`, restrict to) their families.
    ast_pool: list = []
    if "ast" in tiers:
        ast_pool.extend(PASSES)
    if "concurrency" in tiers:
        ast_pool.extend(p for p in CONCURRENCY_PASSES if p not in ast_pool)
    if "ownership" in tiers:
        ast_pool.extend(p for p in OWNERSHIP_PASSES if p not in ast_pool)
    narrow = [t for t in ("concurrency", "ownership") if t in tiers]
    if narrow and "ast" not in tiers:
        # the tier IS a selection; an explicit --select narrows within it
        try:
            wanted = resolve_select(select) if select else list(ast_pool)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        narrowed = [p for p in wanted if p in ast_pool]
        if not narrowed:
            print(
                f"error: --select {args.select!r} selects nothing inside "
                f"--tier {','.join(narrow)} (its passes: "
                f"{', '.join(ast_pool)})",
                file=sys.stderr,
            )
            return 2
        select = narrowed
    elif "ownership" in tiers and select is None:
        # ast,...,ownership with no --select: run the default passes
        # PLUS the opt-in ownership pass in the one process
        select = ast_pool
    extra_axes = {s.strip() for s in args.extra_axes.split(",") if s.strip()}
    try:
        findings, errors = analyze_paths(
            args.paths, select=select, extra_axes=extra_axes
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or (
        DEFAULT_BASELINE if DEFAULT_BASELINE.is_file() else None
    )
    if args.write_baseline:
        path = args.baseline or DEFAULT_BASELINE
        path.parent.mkdir(parents=True, exist_ok=True)
        save_baseline(path, findings)
        print(f"wrote {len(findings)} finding(s) to {path}")
        return 0

    suppressed_count = 0
    if baseline_path is not None and not args.no_baseline:
        # An unreadable or malformed baseline must not traceback AND must
        # not silently ungate: it is a usage error, like a typo'd path.
        try:
            entries = load_baseline(baseline_path)
        except (OSError, json.JSONDecodeError, ValueError) as e:
            print(
                f"error: baseline {baseline_path} is unreadable or "
                f"malformed ({e}); fix it or rerun with --no-baseline / "
                "--write-baseline",
                file=sys.stderr,
            )
            return 2
        findings, suppressed = split_by_baseline(findings, entries)
        suppressed_count = len(suppressed)

    deep_findings = []
    entry_names = None
    if need_run:
        from .entry_audit import (
            NoDeviceError,
            audit_run,
            check_device,
            load_entries,
            run_entry,
        )

        try:
            check_device(args.device)
        except (NoDeviceError, RuntimeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        entry_names = [s.strip() for s in args.entries.split(",")
                       if s.strip()] if args.entries else None
        # One run per entry, shared by the deep and memory audits.
        entries, load_findings = load_entries(entry_names)
        deep_findings.extend(load_findings)
        runs = []
        for e in entries:
            run, fs = run_entry(e, args.device)
            deep_findings.extend(fs)
            if run is not None:
                runs.append(run)

    if "deep" in tiers:
        from . import budget as budget_mod

        reports = {}
        for run in runs:
            fs, report = audit_run(run)
            deep_findings.extend(fs)
            reports[run.entry["name"]] = report
        budget_path = args.budget or budget_mod.DEFAULT_BUDGET
        if args.write_budget:
            if entry_names and budget_path.is_file():
                # A scoped re-baseline must not truncate the other
                # entries' budgets: merge into the existing file.
                try:
                    existing = budget_mod.load_budget(budget_path)
                except ValueError as e:
                    print(f"error: {e}", file=sys.stderr)
                    return 2
                reports = {**existing["entries"], **reports}
            budget_mod.write_budget(budget_path, reports)
            # status to stderr: --format json contracts stdout to be
            # exactly the findings array
            print(f"wrote comm budget for {len(reports)} entr"
                  f"{'y' if len(reports) == 1 else 'ies'} to {budget_path}",
                  file=sys.stderr)
        elif not args.no_budget:
            budget_findings, usage_error = budget_mod.check_budget_path(
                reports, budget_path
            )
            if usage_error is not None:
                print(f"error: {usage_error}", file=sys.stderr)
                return 2
            deep_findings.extend(budget_findings)

    if "memory" in tiers:
        from . import memory as memory_mod

        mem_reports = {}
        mem_tops = {}
        for run in runs:
            fs, report, top = memory_mod.audit_run_memory(run)
            deep_findings.extend(fs)
            mem_reports[run.entry["name"]] = report
            mem_tops[run.entry["name"]] = top
        hbm_path = args.hbm_budget or memory_mod.DEFAULT_HBM_BUDGET
        if args.write_hbm_budget:
            existing = {}
            if hbm_path.is_file():
                try:
                    existing = memory_mod.load_hbm_budget(hbm_path)
                except ValueError as e:
                    if entry_names:
                        print(f"error: {e}", file=sys.stderr)
                        return 2
            if entry_names:
                # scoped re-baseline merges, like --write-budget
                mem_reports = {**existing.get("entries", {}), **mem_reports}
            slices = existing.get("slices")
            if entry_names is None and runs and runs[0].device == "cuda":
                # the slice rows plan_slice_split reads: measured on the
                # card only (a served width), carried over otherwise
                slices = memory_mod.measure_slice_rows(args.device)
            memory_mod.write_hbm_budget(hbm_path, mem_reports,
                                        slices=slices)
            print(f"wrote hbm budget for {len(mem_reports)} entr"
                  f"{'y' if len(mem_reports) == 1 else 'ies'} to "
                  f"{hbm_path}",
                  file=sys.stderr)
        elif not args.no_hbm_budget:
            hbm_findings, usage_error = memory_mod.check_hbm_budget_path(
                mem_reports, hbm_path, tops=mem_tops
            )
            if usage_error is not None:
                print(f"error: {usage_error}", file=sys.stderr)
                return 2
            deep_findings.extend(hbm_findings)

    if need_run and args.report:
        from .memory import memory_report

        per_entry = {
            run.entry["name"]: {
                "device": run.device, "seconds": round(run.seconds, 3),
                "launches": run.launches,
                "collectives": len(run.records),
                "memory": memory_report(run),
            } for run in runs}
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(per_entry, indent=1,
                                          sort_keys=True) + "\n")

    # Gate semantics: AST findings and syntax errors fail regardless of
    # severity (retrace warnings etc. are actionable at the source line).
    # Deep-tier WARNINGS do not gate: they exist for the torch-version
    # and source drift downgrades of the budgets, where a red run no
    # author can fix would be wrong; the printed warning is the signal.
    gating = (
        list(errors) + findings
        + [f for f in deep_findings if f.severity == "error"]
    )
    findings = list(errors) + findings + deep_findings
    if args.format == "json":
        print(json.dumps(
            [f.__dict__ for f in findings], indent=2
        ))
    elif args.format == "sarif":
        print(_render_sarif(findings))
    elif args.format == "github":
        for f in findings:
            print(_render_github(f))
    else:
        for f in findings:
            print(f.render())
    if args.format not in ("json", "sarif"):
        n_err = sum(1 for f in findings if f.severity == "error")
        n_warn = len(findings) - n_err
        tail = f" ({suppressed_count} baselined)" if suppressed_count else ""
        tier = f" [{args.tier}]" if args.tier != "ast" else ""
        print(
            f"{PROG}{tier}: {n_err} error(s), {n_warn} warning(s){tail}",
            file=sys.stderr,
        )
    return 1 if gating else 0


if __name__ == "__main__":
    sys.exit(main())
