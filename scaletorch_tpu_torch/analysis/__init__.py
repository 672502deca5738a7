"""The port's static analyzer: ``python -m scaletorch_tpu_torch.analysis
[paths]``.

PyTorch counterpart of ``scaletorch_tpu/analysis`` (which it never
imports: the port keeps its own copy of every framework-free module).
Eight passes over plain syntax trees (nothing under analysis is
imported):

=====  ======================================================
ST1xx  mesh-axis and spec-tree consistency (axis typos, dead keys)
ST2xx  capture safety (host syncs and host code in captured steps)
ST3xx  random-number hygiene (global-generator draws, clock seeds)
ST4xx  reads of a captured step's overwritten static outputs
ST5xx  literals handed to a captured step
ST6xx  collective symmetry across ranks (rank-divergent deadlocks)
ST9xx  host-thread concurrency (races, deadlocks, loop abuse)
       + the telemetry kind registry (ST907)
=====  ======================================================

A *captured scope* (``scopes.py``) is a function handed to
``inference/decode.StaticStep`` or to a ``torch.cuda.graph`` block,
plus what it calls: it stands where the reference's jit, shard_map and
scan scopes stood.

``--tier deep`` runs the seven audit entries (``entry_audit.py``, the
counterpart of the reference's ``jaxpr_audit.py``) with the collective
recorder on (``recorder.py``, the counterpart of ``hlo.py``: c10d ops
on a ``DeviceMesh`` stand where named-axis collectives stood) and checks
ST7xx and the per-entry comm budget (ST8xx, ``budget.py`` against
``scaletorch_tpu_torch/comm_budget.json``). ``--tier memory`` runs the
same entries and checks their memory (ST10xx, ``memory.py`` against
``scaletorch_tpu_torch/hbm_budget.json``): ``torch.cuda`` allocator
statistics on the card stand where XLA's ``memory_analysis()`` stood.
``--tier deep,memory`` runs each entry once for both. Both need a
device (``--device``, the card by default). ``--tier concurrency`` runs
only the ST9xx family; ``--tier ownership`` the ST11xx resource
lifecycle tier (``ownership.py``), pure-AST and opt-in.

``--select`` accepts pass names or code families, case-insensitively:
``--select ST9`` (or ``st901``) runs the concurrency family.

Findings print as ``file:line: CODE severity message``; a checked-in
baseline (``scaletorch_tpu_torch/analysis_baseline.json``, every entry
with a ``why``) suppresses accepted findings so the gate only fails on
NEW ones.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set

from . import (
    concurrency,
    donation,
    ownership,
    prng,
    retrace,
    sharding,
    symmetry,
    telemetry_kinds,
    trace_safety,
)
from .core import (
    Finding,
    SourceModule,
    collect_files,
    load_baseline,
    save_baseline,
    split_by_baseline,
)
from .scopes import ProjectIndex

PASSES = {
    "sharding": sharding.run,
    "trace-safety": trace_safety.run,
    "prng": prng.run,
    "donation": donation.run,
    "retrace": retrace.run,
    "symmetry": symmetry.run,
    "concurrency": concurrency.run,
    "telemetry-kinds": telemetry_kinds.run,
}

# code family -> the AST passes that emit it (--select ST9, --tier
# concurrency). ST7/ST8 are deep-tier and deliberately absent: selecting
# them here is a usage error pointing at --tier deep.
FAMILIES = {
    "ST1": ("sharding",),
    "ST2": ("trace-safety",),
    "ST3": ("prng",),
    "ST4": ("donation",),
    "ST5": ("retrace",),
    "ST6": ("symmetry",),
    "ST9": ("concurrency", "telemetry-kinds"),
}
CONCURRENCY_PASSES = FAMILIES["ST9"]

# tier-only AST passes: run when their tier (or pass name) is selected,
# never as part of the default `--tier ast` sweep
TIER_ONLY_PASSES = {
    "ownership": ownership.run,
}
OWNERSHIP_PASSES = ("ownership",)

__all__ = [
    "Finding", "SourceModule", "ProjectIndex", "PASSES", "FAMILIES",
    "CONCURRENCY_PASSES", "TIER_ONLY_PASSES", "OWNERSHIP_PASSES",
    "collect_files", "load_baseline", "save_baseline", "split_by_baseline",
    "analyze", "analyze_paths", "resolve_select",
]


def resolve_select(select: Sequence[str]) -> List[str]:
    """Selector tokens -> pass names. Tokens are matched
    case-insensitively against pass names (``concurrency``) and code
    families (``ST9``, or any code like ``ST904`` — the family prefix
    wins). Unknown tokens raise ``ValueError`` naming every valid
    choice, so a typo'd selector is a loud usage error (exit 2), never
    a silently-green empty run."""
    wanted: List[str] = []
    valid_passes = {p.lower(): p for p in PASSES}
    valid_passes.update({p.lower(): p for p in TIER_ONLY_PASSES})
    for token in select:
        t = token.strip()
        if not t:
            continue
        low = t.lower()
        if low in valid_passes:
            name = valid_passes[low]
            if name not in wanted:
                wanted.append(name)
            continue
        # ST10 / ST10xx is the memory tier, not an AST pass — point at
        # the tier before the single-digit family parse (which would
        # otherwise read "st1001" as garbage, or nothing at all).
        if low.startswith("st10") and (
            len(low) == 4 or (len(low) == 6 and low[4:].isdigit())
        ):
            raise ValueError(
                f"selector {token!r} is the memory-tier family (ST10xx "
                "memory audit); run with --tier memory instead of "
                "--select"
            )
        # ST11 / ST11xx is the ownership tier — same precedent: the tier
        # flag is the supported spelling (the family maps 1:1 to it).
        if low.startswith("st11") and (
            len(low) == 4 or (len(low) == 6 and low[4:].isdigit())
        ):
            raise ValueError(
                f"selector {token!r} is the ownership-tier family "
                "(ST11xx resource lifecycle); run with --tier ownership "
                "instead of --select"
            )
        fam = None
        # a family is exactly "STn" or a full code "STnxx" — trailing
        # garbage ("ST9q") must NOT silently match a family
        if low.startswith("st") and len(low) in (3, 5) and \
                low[2:].isdigit():
            fam = f"ST{low[2]}"
        if fam in ("ST7", "ST8"):
            raise ValueError(
                f"selector {token!r} is a deep-tier family (ST7xx entry "
                "audit, ST8xx comm budget); run with --tier deep "
                "instead of --select"
            )
        if fam in FAMILIES:
            for name in FAMILIES[fam]:
                if name not in wanted:
                    wanted.append(name)
            continue
        raise ValueError(
            f"unknown pass or family {token!r}; valid passes: "
            f"{', '.join(sorted(valid_passes.values()))}; valid families: "
            f"{', '.join(sorted(FAMILIES))}"
        )
    if not wanted:
        raise ValueError(
            f"empty selection; valid passes: "
            f"{', '.join(sorted(set(PASSES) | set(TIER_ONLY_PASSES)))}; "
            f"valid families: {', '.join(sorted(FAMILIES))}"
        )
    return wanted


def analyze(
    modules: Sequence[SourceModule],
    select: Optional[Sequence[str]] = None,
    extra_axes: Set[str] = frozenset(),
) -> List[Finding]:
    """Run the selected passes (default: all) over parsed modules."""
    index = ProjectIndex(modules)
    findings: List[Finding] = []
    wanted = set(resolve_select(select)) if select else set(PASSES)
    for name, pass_fn in {**PASSES, **TIER_ONLY_PASSES}.items():
        if name not in wanted:
            continue
        if name == "sharding":
            findings.extend(pass_fn(index, extra_axes))
        else:
            findings.extend(pass_fn(index))
    findings.sort(key=lambda f: (f.file, f.line, f.code))
    return findings


def analyze_paths(
    paths: Sequence[str],
    select: Optional[Sequence[str]] = None,
    extra_axes: Set[str] = frozenset(),
) -> tuple[List[Finding], List[Finding]]:
    """(findings, syntax_errors) for files/directories on disk."""
    modules, errors = collect_files(paths)
    return analyze(modules, select=select, extra_axes=extra_axes), errors
