"""ST10xx — the memory tier: each audit entry's memory, measured, and the
standing per-entry memory budget.

PyTorch counterpart of the reference's ``analysis/memory.py``, which read
``compiled.memory_analysis()`` (or estimated buffer liveness over the
jaxpr). The port RUNS each entry (``entry_audit.run_entry``) and takes
its memory from one of two sources:

* ``source: "cuda"`` on the card: ``torch.cuda.reset_peak_memory_stats``,
  then ``memory_allocated`` before and after one call and
  ``max_memory_allocated`` over it. Exact allocator facts.
* ``source: "dispatch"`` on the CPU: a ``TorchDispatchMode`` liveness
  estimator over storages. Every storage an op creates allocates, and
  frees when the last tensor holding it dies (tensors saved for the
  backward are held through ``saved_tensors_hooks``). It attributes the
  top live allocations at its peak to source lines. It is the
  counterpart of the reference's jaxpr-liveness fallback.

Both give argument, output (retained after the call), temp (the most
the call held above its start) and peak (arguments + temp) MB, and the
in-place savings: the bytes of the buffers the entry updates in place
that kept their storage. The estimator always runs beside the card's
numbers too, for the source attribution and the precision check. A
budget row records its source; a comparison across sources reports a
warning, never an error, as does one across torch versions.

ST1001  peak / temp / argument bytes over budget, in-place savings
        shrunk, or no budget row at all
ST1002  the in-place contract broken: the buffers updated in place keep
        less than the entry's floor (``inplace_min_mb``), or the call
        retains as many new bytes as those buffers hold (a second copy)
ST1003  precision leak: a large fp32 allocation in a bf16-contracted
        entry outside the allowlisted accumulations (softmax, loss,
        optimizer moments, scales)
ST1004  remat violation: under a configured checkpoint policy, the
        bytes saved for the backward (counted through
        ``torch.autograd.graph.saved_tensors_hooks``) stay at
        full-activation scale (over ``residual_cap_mb``)
ST1005  pool-sizing mismatch: the engine's ``kv_cache_bytes`` for the
        audited layout disagrees with the allocated cache / pool
        tensors (admission math and the allocation must agree)

The budget file also carries a ``slices`` section: the disaggregated
engine's two slice programs measured on the card at a served width
(``inference/disagg.slice_budget_entries``), which ``plan_slice_split``
sizes the slices by. A full ``--write-hbm-budget`` on the card measures
them; any other write carries the file's section over unchanged. They
size the slices and gate nothing.

Like ST7xx/ST8xx, the contract fields (``inplace_min_mb``,
``compute_dtype``, ``kv_cache``, ...) are pinned in the builders next to
the entry points: a config mutation fails the gate instead of relaxing
it.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import weakref
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .core import Finding

_PACKAGE = Path(__file__).resolve().parent.parent
DEFAULT_HBM_BUDGET = _PACKAGE / "hbm_budget.json"
_BUDGET_FILE = "scaletorch_tpu_torch/hbm_budget.json"  # finding location
# Same growth tolerance as the comm budget: allocator rounding and
# benign drift across releases.
DEFAULT_TOLERANCE_PCT = 10.0
# Absolute slack in MB: entries whose budget rounds to ~0 must not fail
# on a few KB of allocator noise.
_ABS_SLACK_MB = 0.25
_TOP_K = 8

# Function-name substrings (over the allocation's frames in the port)
# whose fp32 intermediates are legitimate in a bf16 entry: the
# accumulations the mixed-precision recipe keeps wide. Entries extend
# it with the ``fp32_allow`` contract field.
_FP32_ALLOW = (
    "softmax", "loss", "cross_entropy", "entropy", "logsumexp",
    "norm", "moment", "adam", "lamb", "adafactor", "optimizer",
    "scale", "quant", "rope", "rotary",
)
_ANALYSIS_DIR = str(Path(__file__).resolve().parent)
_REPO_DIR = str(_PACKAGE.parent)


@dataclasses.dataclass(frozen=True)
class Allocation:
    """One storage an op created, attributed to source."""

    nbytes: int
    shape: Tuple[int, ...]
    dtype: str
    site: str                       # "file:line (function)"
    frames: Tuple[str, ...] = ()    # function names of the port's frames


@dataclasses.dataclass
class MemoryRun:
    """One measured call's memory."""

    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    peak_bytes: int
    source: str                     # "cuda" | "dispatch"
    top: List[Allocation]
    allocations: List[Allocation]
    saved_bytes: int                # saved for the backward
    cache_bytes: int                # the entry's cache / pool tensors


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    if isinstance(x, dict):
        return [t for item in x.values() for t in _tensors(item)]
    return []


def _storage_bytes(tensors) -> int:
    seen: Dict[int, int] = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _site() -> Tuple[str, Tuple[str, ...]]:
    """The innermost frame in the repository outside the analyzer, and
    the function names of every such frame."""
    frame = sys._getframe(2)
    site, names = "<unknown>", []
    while frame is not None:
        path = frame.f_code.co_filename
        if path.startswith(_REPO_DIR) and \
                not path.startswith(_ANALYSIS_DIR):
            if site == "<unknown>":
                site = (f"{os.path.relpath(path, _REPO_DIR)}:"
                        f"{frame.f_lineno} ({frame.f_code.co_name})")
            names.append(frame.f_code.co_name)
        frame = frame.f_back
    return site, tuple(names)


class LivenessObserver(TorchDispatchMode):
    """The ``dispatch`` source: storages created by ops while active,
    live until the last tensor holding them dies (see the module
    docstring). ``known`` are the storages that existed before (the
    arguments): never counted."""

    def __init__(self, known: List[torch.Tensor]) -> None:
        super().__init__()
        self.known = {t.untyped_storage().data_ptr() for t in known}
        self.live: Dict[int, Allocation] = {}
        self.holders: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak = 0
        self.top: List[Allocation] = []
        self.allocations: List[Allocation] = []
        self.saved: Dict[int, int] = {}

    def _hold(self, t: torch.Tensor, new_ok: bool) -> None:
        if t.device.type == "meta":
            return
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        ptr, nbytes = st.data_ptr(), st.nbytes()
        if not nbytes or ptr in self.known:
            return
        if ptr not in self.live:
            if not new_ok:
                return
            site, frames = _site()
            alloc = Allocation(nbytes=nbytes, shape=tuple(t.shape),
                               dtype=str(t.dtype).replace("torch.", ""),
                               site=site, frames=frames)
            self.live[ptr] = alloc
            self.holders[ptr] = 0
            self.allocations.append(alloc)
            self.live_bytes += nbytes
            if self.live_bytes > self.peak:
                self.peak = self.live_bytes
                self.top = sorted(self.live.values(),
                                  key=lambda a: -a.nbytes)[:_TOP_K]
        self.holders[ptr] += 1
        weakref.finalize(t, self._release, ptr, self.live[ptr])

    def _release(self, ptr: int, alloc: Allocation) -> None:
        if self.live.get(ptr) is not alloc:
            return
        self.holders[ptr] -= 1
        if self.holders[ptr] <= 0:
            del self.live[ptr], self.holders[ptr]
            self.live_bytes -= alloc.nbytes

    def pack(self, t: torch.Tensor) -> torch.Tensor:
        """saved_tensors_hooks' pack: the graph holds the tensor itself,
        so its storage stays live while the graph keeps it."""
        st = t.untyped_storage()
        self.saved[st.data_ptr()] = st.nbytes()
        self._hold(t, new_ok=False)
        return t

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self._hold(t, new_ok=True)
        return out


def measure(prepared: dict, dev: torch.device, rec) -> MemoryRun:
    """Run ``prepared["call"]`` once under the recorder ``rec`` and the
    liveness observer, with the card's allocator statistics around it
    on a CUDA device."""
    arguments = prepared.get("arguments", [])
    cache = prepared.get("cache", ())
    obs = LivenessObserver(list(arguments))
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    with torch.autograd.graph.saved_tensors_hooks(obs.pack, lambda t: t):
        with rec, obs:
            out = prepared["call"]()
    gc.collect()  # storages held only by reference cycles die here
    if on_card:
        torch.cuda.synchronize(dev)
        after = torch.cuda.memory_allocated(dev)
        temp = torch.cuda.max_memory_allocated(dev) - before
        output = after - before
    else:
        temp, output = obs.peak, obs.live_bytes
    del out
    argument = _storage_bytes(arguments)
    return MemoryRun(
        argument_bytes=argument, output_bytes=max(0, output),
        temp_bytes=max(0, temp), peak_bytes=argument + max(0, temp),
        source="cuda" if on_card else "dispatch", top=list(obs.top),
        allocations=list(obs.allocations),
        saved_bytes=sum(obs.saved.values()),
        cache_bytes=sum(t.numel() * t.element_size() for t in cache))


# ---- contract checks (ST1002-ST1005) ----------------------------------------

def inplace_kept_bytes(run) -> int:
    """Bytes of the in-place buffers that kept their storage."""
    return sum(n for before, after, n in run.inplace.values()
               if before == after)


def check_inplace_bytes(entry: dict, run) -> List[Finding]:
    want_mb = entry.get("inplace_min_mb")
    if not entry.get("expect_inplace") or not want_mb:
        return []
    kept_mb = inplace_kept_bytes(run) / 1e6
    buffers_mb = sum(n for _, _, n in run.inplace.values()) / 1e6
    retained_mb = run.memory.output_bytes / 1e6
    if kept_mb >= want_mb and retained_mb < buffers_mb:
        return []
    return [Finding(
        file=entry["file"], line=1, code="ST1002", severity="error",
        message=(
            f"entry {entry['name']!r}: the buffers updated in place should "
            f"keep >= {want_mb:.4f} MB in their storage, but keep "
            f"{kept_mb:.4f} MB, and the call retains {retained_mb:.4f} MB "
            f"of new storage against {buffers_mb:.4f} MB of those buffers "
            "— the in-place update is ineffective (a second copy of the "
            "parameters / optimizer state / cache is held across the step)"
        ),
    )]


def check_precision(entry: dict, run) -> List[Finding]:
    contract = str(entry.get("compute_dtype") or "")
    if contract not in ("bf16", "bfloat16"):
        return []
    min_elems = int(entry.get("fp32_large_elems", 1 << 20))
    allow = _FP32_ALLOW + tuple(entry.get("fp32_allow", ()))
    by_site: Dict[str, Tuple[int, int]] = {}   # site -> (count, max bytes)
    for a in run.memory.allocations:
        if a.dtype != "float32":
            continue
        elems = 1
        for d in a.shape:
            elems *= d
        if elems < min_elems:
            continue
        frames = [f.lower() for f in a.frames if not f.startswith("<")]
        if any(x in f for f in frames for x in allow):
            continue
        n, mx = by_site.get(a.site, (0, 0))
        by_site[a.site] = (n + 1, max(mx, a.nbytes))
    return [Finding(
        file=entry["file"], line=1, code="ST1003", severity="error",
        message=(
            f"entry {entry['name']!r} is configured bf16 but allocates "
            f"{n} large fp32 buffer(s) (up to {mx / 1e6:.4f} MB, >= "
            f"{min_elems} elements) at {site} — outside the allowlisted "
            "accumulations (softmax/loss/optimizer moments/scales); an "
            "accidental fp32 residual doubles that activation's memory "
            "and bandwidth"
        ),
    ) for site, (n, mx) in sorted(by_site.items())]


def check_remat(entry: dict, run) -> List[Finding]:
    policy = entry.get("remat_policy")
    cap_mb = entry.get("residual_cap_mb")
    if not policy or cap_mb is None:
        return []
    saved_mb = run.memory.saved_bytes / 1e6
    if saved_mb <= cap_mb:
        return []
    return [Finding(
        file=entry["file"], line=1, code="ST1004", severity="error",
        message=(
            f"entry {entry['name']!r}: checkpoint policy {policy!r} is "
            f"configured but {saved_mb:.4f} MB are saved for the backward "
            f"(cap {cap_mb:.4f} MB) — the policy is not recomputing; "
            "activations are kept at full scale as if checkpointing were "
            "off"
        ),
    )]


def check_pool_sizing(entry: dict, run) -> List[Finding]:
    kc = entry.get("kv_cache")
    if not kc:
        return []
    from scaletorch_tpu_torch.inference.kv_cache import kv_cache_bytes

    expected = kv_cache_bytes(
        kc["cfg"], kc["batch"], kc["max_seq"], kc.get("dtype"),
        layout=kc.get("layout", "dense"), page_size=kc.get("page_size"),
        num_pages=kc.get("num_pages"))
    actual = run.memory.cache_bytes
    if actual == expected:
        return []
    return [Finding(
        file=entry["file"], line=1, code="ST1005", severity="error",
        message=(
            f"entry {entry['name']!r}: engine kv_cache_bytes sizes the "
            f"{kc.get('layout', 'dense')} cache at {expected} bytes but "
            f"the entry's cache/pool tensors are {actual} bytes — "
            "admission math and the allocation have drifted apart (the "
            "engine's page budget is computed from the former, the card "
            "holds the latter)"
        ),
    )]


def check_memory(entry: dict, run) -> List[Finding]:
    """The contract checks for one measured entry (the budget gate,
    ST1001, is ``check_hbm_budget``)."""
    out: List[Finding] = []
    out.extend(check_inplace_bytes(entry, run))
    out.extend(check_precision(entry, run))
    out.extend(check_remat(entry, run))
    out.extend(check_pool_sizing(entry, run))
    return out


# ---- per-entry report + audit drivers ---------------------------------------

def card_stamp() -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them."""
    from scaletorch_tpu_torch.utils.device import card_name_and_power_limit

    return card_name_and_power_limit()


def memory_report(run) -> dict:
    """The budget row of one entry: the MB ledger, its source, and on the
    card the card's name and power limit."""
    mem = run.memory
    row = {
        "argument_mb": round(mem.argument_bytes / 1e6, 4),
        "output_mb": round(mem.output_bytes / 1e6, 4),
        "temp_mb": round(mem.temp_bytes / 1e6, 4),
        "inplace_mb": round(inplace_kept_bytes(run) / 1e6, 4),
        "peak_mb": round(mem.peak_bytes / 1e6, 4),
        "source": mem.source,
    }
    if mem.source == "cuda":
        row["card"] = card_stamp()
    return row


def audit_run_memory(run) -> Tuple[List[Finding], dict, List[Allocation]]:
    """(contract findings, budget row, top-k attribution) of a measured
    entry."""
    return check_memory(run.entry, run), memory_report(run), run.memory.top


# ---- the memory budget gate (ST1001) ----------------------------------------

def measure_slice_rows(device: str) -> Dict[str, dict]:
    """The ``slices`` rows: each slice program of
    ``slice_budget_entries`` built and run once on ``device`` (a warm-up,
    then the measured call), its memory row with the shape it ran at."""
    from scaletorch_tpu_torch.inference.disagg import slice_budget_entries

    from .entry_audit import run_entry

    rows = {}
    for entry in slice_budget_entries():
        run, findings = run_entry(entry, device)
        if run is None:
            raise RuntimeError(findings[0].message)
        rows[entry["name"]] = {**memory_report(run), **entry["shape"],
                               "torch": torch.__version__}
        del run
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return rows


def write_hbm_budget(path: Path, reports: Dict[str, dict],
                     tolerance_pct: float = DEFAULT_TOLERANCE_PCT,
                     slices: Optional[Dict[str, dict]] = None) -> None:
    """Persist per-entry memory rows as the checked-in budget, and the
    ``slices`` rows when given. Each row carries the torch version that
    measured it (a scoped rewrite merges fresh rows beside older ones)."""
    rows = {name: {**report, "torch": report.get("torch", torch.__version__)}
            for name, report in reports.items()}
    doc = {
        "version": 1,
        "torch": torch.__version__,
        "tolerance_pct": tolerance_pct,
        "note": (
            "Per-entry memory budget (scaletorch_tpu_torch/analysis/"
            "memory.py): the CUDA allocator's statistics over one call on "
            "the card ('source': 'cuda', with the card's name and power "
            "limit) or the dispatch liveness estimator on the CPU "
            "('dispatch'); peak = arguments + the most the call held "
            "above its start. Regenerate after an INTENTIONAL memory "
            "change with `python -m scaletorch_tpu_torch.analysis --tier "
            "memory --write-hbm-budget` on the card. 'entries' gate the "
            "audit entries (ST1001); 'slices' are the two disaggregated "
            "slice programs at a served width, which plan_slice_split "
            "reads."
        ),
        "entries": rows,
    }
    if slices:
        doc["slices"] = slices
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n",
                    encoding="utf-8")


def load_hbm_budget(path: Path) -> dict:
    """Parse the budget file; ValueError on unreadable or malformed
    content (a usage error at the CLI)."""
    try:
        doc = json.loads(path.read_text(encoding="utf-8"))
    except OSError as exc:
        raise ValueError(f"cannot read hbm budget {path}: {exc}") from exc
    except json.JSONDecodeError as exc:
        raise ValueError(
            f"hbm budget {path} is not valid JSON: {exc}") from exc
    if not isinstance(doc, dict) or not isinstance(doc.get("entries"), dict):
        raise ValueError(
            f"hbm budget {path} is malformed: expected an object with an "
            "'entries' mapping")
    return doc


def _top_note(tops: Optional[Dict[str, List[Allocation]]],
              name: str) -> str:
    shown = list((tops or {}).get(name) or [])[:3]
    if not shown:
        return ""
    return " [largest live allocations: " + "; ".join(
        f"{t.nbytes / 1e6:.2f} MB {t.dtype}{list(t.shape)} at {t.site}"
        for t in shown) + "]"


def check_hbm_budget(reports: Dict[str, dict], budget_doc: dict, *,
                     tolerance_pct: Optional[float] = None,
                     tops: Optional[Dict[str, List[Allocation]]] = None
                     ) -> List[Finding]:
    """Fresh memory rows against the checked-in budget. Findings land on
    the budget file. A row measured under another torch, or by another
    source, reports warnings (re-baseline advice) instead of errors."""
    tol = (tolerance_pct if tolerance_pct is not None
           else float(budget_doc.get("tolerance_pct",
                                     DEFAULT_TOLERANCE_PCT)))
    entries = budget_doc["entries"]
    out: List[Finding] = []

    def grew(now: float, budgeted: float) -> bool:
        return now > budgeted * (1.0 + tol / 100.0) + _ABS_SLACK_MB

    def shrank(now: float, budgeted: float) -> bool:
        return now < budgeted * (1.0 - tol / 100.0) - _ABS_SLACK_MB

    for name, report in sorted(reports.items()):
        budget = entries.get(name)
        if budget is None:
            out.append(Finding(
                file=_BUDGET_FILE, line=1, code="ST1001", severity="error",
                message=(
                    f"audited entry {name!r} has no hbm budget — add it "
                    "with --write-hbm-budget so its peak memory is gated"
                ),
            ))
            continue
        row_torch = budget.get("torch", budget_doc.get("torch"))
        same_torch = row_torch in (None, torch.__version__)
        same_source = report.get("source") == budget.get("source")
        soft = not (same_torch and same_source)
        severity = "warning" if soft else "error"
        drift_note = "" if not soft else (
            " [budget from "
            + (f"torch {row_torch}" if not same_torch
               else f"source {budget.get('source')!r} vs now "
                    f"{report.get('source')!r}")
            + " — if the change is environment drift, re-baseline with "
            "--write-hbm-budget]")
        for field in ("peak_mb", "temp_mb", "argument_mb"):
            now_mb = float(report.get(field, 0.0))
            ref_mb = float(budget.get(field, 0.0))
            if grew(now_mb, ref_mb):
                out.append(Finding(
                    file=_BUDGET_FILE, line=1, code="ST1001",
                    severity=severity,
                    message=(
                        f"entry {name!r}: {field} over budget — "
                        f"{now_mb:.4f} MB vs budgeted {ref_mb:.4f} MB "
                        f"(tolerance {tol:g}% + {_ABS_SLACK_MB} MB)"
                        f"{_top_note(tops, name)}{drift_note}"
                    ),
                ))
        now_kept = float(report.get("inplace_mb", 0.0))
        ref_kept = float(budget.get("inplace_mb", 0.0))
        if shrank(now_kept, ref_kept):
            out.append(Finding(
                file=_BUDGET_FILE, line=1, code="ST1001", severity=severity,
                message=(
                    f"entry {name!r}: in-place savings shrank — "
                    f"{now_kept:.4f} MB kept in place vs budgeted "
                    f"{ref_kept:.4f} MB; the lost bytes become a second "
                    f"resident copy{drift_note}"
                ),
            ))
    return out


def check_hbm_budget_path(reports: Dict[str, dict], path: Path,
                          tops: Optional[Dict[str, List[Allocation]]] = None
                          ) -> Tuple[List[Finding], Optional[str]]:
    """(findings, usage_error). A missing or malformed budget file is a
    usage error string (exit 2 at the CLI), not a crash."""
    if not path.is_file():
        return [], (
            f"hbm budget {path} not found — generate it with "
            "`python -m scaletorch_tpu_torch.analysis --tier memory "
            "--write-hbm-budget` (or pass --no-hbm-budget to skip the "
            "gate)")
    try:
        doc = load_hbm_budget(path)
    except ValueError as exc:
        return [], str(exc)
    return check_hbm_budget(reports, doc, tops=tops), None
