"""The analyzer's core — findings, file collection, baseline (a copy of
the reference's ``analysis/core.py``).

The analyzer is a plain-AST tool: it never imports the code under
analysis (so it runs without initialising a device and cannot be
confused by import-time side effects). Each pass receives the parsed
module plus the cross-module context built by ``scopes.ProjectIndex``
(declared mesh axes, captured-scope map, param-key universe) and yields
``Finding`` records.

Findings print as ``file:line: CODE severity message`` and are matched
against a checked-in baseline
(``scaletorch_tpu_torch/analysis_baseline.json``) on
``(file, code, message)`` — deliberately not on line numbers, so
unrelated edits above a baselined finding don't resurrect it.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic. ``file`` is repo-relative with forward slashes."""

    file: str
    line: int
    code: str
    severity: str
    message: str

    def render(self) -> str:
        return f"{self.file}:{self.line}: {self.code} {self.severity} {self.message}"

    def baseline_key(self) -> tuple:
        return (self.file, self.code, self.message)


@dataclasses.dataclass
class SourceModule:
    """A parsed file plus the metadata passes need."""

    path: Path          # absolute
    rel: str            # repo-relative, forward slashes (finding file field)
    module: str         # dotted module name guess, e.g. scaletorch_tpu_torch.models.llama
    source: str
    tree: ast.Module


def _module_name(path: Path, root: Path) -> str:
    try:
        rel = path.resolve().relative_to(root.resolve())
    except ValueError:
        rel = Path(path.name)
    parts = list(rel.with_suffix("").parts)
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def collect_files(
    paths: Sequence[str], root: Optional[Path] = None
) -> tuple[List[SourceModule], List[Finding]]:
    """Expand files/directories into parsed ``SourceModule``s.

    Returns ``(modules, errors)`` — unparseable files become a JL000
    syntax-error finding rather than crashing the run.
    """
    root = (root or Path.cwd()).resolve()
    files: List[Path] = []
    for p in paths:
        pp = Path(p)
        if pp.is_dir():
            files.extend(sorted(pp.rglob("*.py")))
        elif pp.is_file() and pp.suffix == ".py":
            files.append(pp)
        else:
            # A typo'd path must NOT turn the gate silently green.
            raise ValueError(
                f"path is not a directory or .py file: {p}"
            )
    modules: List[SourceModule] = []
    errors: List[Finding] = []
    seen = set()
    for f in files:
        af = f.resolve()
        if af in seen or "__pycache__" in af.parts:
            continue
        seen.add(af)
        try:
            rel = str(af.relative_to(root)).replace(os.sep, "/")
        except ValueError:
            rel = str(f).replace(os.sep, "/")
        source = af.read_text(encoding="utf-8")
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError as e:
            errors.append(Finding(
                file=rel, line=e.lineno or 1, code="JL000", severity="error",
                message=f"syntax error: {e.msg}",
            ))
            continue
        modules.append(SourceModule(
            path=af, rel=rel, module=_module_name(af, root), source=source,
            tree=tree,
        ))
    return modules, errors


# ---- baseline ---------------------------------------------------------------

def load_baseline(path: Path) -> List[dict]:
    """Baseline entries; raises OSError/JSONDecodeError/ValueError on an
    unreadable or malformed file — the CLI maps those to a usage error
    (exit 2) so a mangled baseline can neither traceback nor silently
    turn the gate green."""
    data = json.loads(path.read_text(encoding="utf-8"))
    if isinstance(data, dict):
        entries = data.get("findings", [])
    else:
        entries = data
    if not isinstance(entries, list) or not all(
        isinstance(e, dict) for e in entries
    ):
        raise ValueError(
            "baseline must be a list of {file, code, message} objects "
            "(or {\"findings\": [...]})"
        )
    return list(entries)


def save_baseline(path: Path, findings: Iterable[Finding]) -> None:
    entries = sorted(
        (
            {"file": f.file, "code": f.code, "message": f.message}
            for f in findings
        ),
        key=lambda e: (e["file"], e["code"], e["message"]),
    )
    path.write_text(
        json.dumps({"version": 1, "findings": entries}, indent=2) + "\n",
        encoding="utf-8",
    )


def split_by_baseline(
    findings: Sequence[Finding], baseline_entries: Sequence[dict]
) -> tuple[List[Finding], List[Finding]]:
    """(new, suppressed). Each baseline entry absorbs at most as many
    findings as it appears times — a second identical regression still
    fails the gate."""
    budget: dict[tuple, int] = {}
    for e in baseline_entries:
        key = (e.get("file"), e.get("code"), e.get("message"))
        budget[key] = budget.get(key, 0) + 1
    new: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        key = f.baseline_key()
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            suppressed.append(f)
        else:
            new.append(f)
    return new, suppressed
