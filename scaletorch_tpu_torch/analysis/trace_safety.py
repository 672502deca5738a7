"""ST2xx — capture safety inside captured scopes.

Everything here is a "works eagerly, breaks or silently degrades under
CUDA-graph capture" hazard. A captured step (``StaticStep``, a
``torch.cuda.graph`` block) records its kernels once and replays them:
host code runs once, at capture, and a host synchronisation is
forbidden while capturing. The pass walks every captured scope (see
``scopes``) with a taint tracker seeded from the scope's tensor
parameters:

ST201  Python ``if``/``while``/``assert`` on a device tensor — a host
       sync that capture forbids, and one branch baked into the graph
       at best; use ``torch.where`` / masks
ST202  ``float()``/``int()``/``bool()``/``.item()``/``.tolist()``/
       ``.numpy()``/``.cpu()`` on a device tensor — a device-to-host
       sync, which capture forbids
ST203  ``np.*`` call on a device tensor — host numpy, a sync and a
       value frozen at capture
ST204  ``print`` in a captured scope — runs once, at capture, not per
       replay
ST205  wall-clock reads (``time.time``/``perf_counter``/
       ``datetime.now``) in a captured scope — the value is baked into
       the graph at capture

Branching on static facts (``.shape``/``.dtype``/``len()``/``is None``)
is idiomatic and never flagged: that is the taint tracker's job.
"""

from __future__ import annotations

import ast
from typing import List, Set

from .core import Finding, SourceModule
from .scopes import ModuleScopes, ProjectIndex, TaintTracker, dotted_name, tail_name

_CAST_CALLS = {"float", "int", "bool", "complex"}
_SYNC_METHODS = {"item", "tolist", "numpy", "cpu"}
_CLOCK_CALLS = {
    "time.time", "time.perf_counter", "time.monotonic", "time.process_time",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
}


def _numpy_aliases(sm: SourceModule) -> Set[str]:
    aliases: Set[str] = set()
    for node in ast.walk(sm.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "numpy":
                    aliases.add(alias.asname or "numpy")
    return aliases


def run(index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for ms in index.scopes.values():
        findings.extend(_check_module(ms))
    return findings


def _check_module(ms: ModuleScopes) -> List[Finding]:
    out: List[Finding] = []
    np_aliases = _numpy_aliases(ms.sm)
    for fn, info in ms.traced_functions():
        if isinstance(fn, ast.Lambda):
            continue  # no statements to branch on; calls are caught in parents
        tracker = TaintTracker(fn, info)
        _walk_body(ms, fn.body, tracker, np_aliases, out)
    return out


def _walk_body(
    ms: ModuleScopes,
    body: List[ast.stmt],
    tracker: TaintTracker,
    np_aliases: Set[str],
    out: List[Finding],
) -> None:
    for stmt in body:
        # nested defs are captured scopes of their own (fresh params)
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        _check_calls(ms, stmt, tracker, np_aliases, out)
        if isinstance(stmt, ast.If):
            if tracker.is_tainted(stmt.test):
                out.append(_finding(
                    ms, stmt, "ST201", "error",
                    "Python `if` on a device tensor inside a captured scope — "
                    "a host sync at capture; use torch.where / a mask",
                ))
            _walk_body(ms, stmt.body, tracker, np_aliases, out)
            _walk_body(ms, stmt.orelse, tracker, np_aliases, out)
        elif isinstance(stmt, ast.While):
            if tracker.is_tainted(stmt.test):
                out.append(_finding(
                    ms, stmt, "ST201", "error",
                    "Python `while` on a device tensor inside a captured scope "
                    "— a host sync at capture; bound the loop statically",
                ))
            _walk_body(ms, stmt.body, tracker, np_aliases, out)
            _walk_body(ms, stmt.orelse, tracker, np_aliases, out)
        elif isinstance(stmt, ast.Assert):
            if tracker.is_tainted(stmt.test):
                out.append(_finding(
                    ms, stmt, "ST201", "error",
                    "`assert` on a device tensor inside a captured scope — "
                    "a host sync at capture; check outside the step",
                ))
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            tracker.observe(stmt)
            _walk_body(ms, stmt.body, tracker, np_aliases, out)
            _walk_body(ms, stmt.orelse, tracker, np_aliases, out)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            tracker.observe(stmt)
            _walk_body(ms, stmt.body, tracker, np_aliases, out)
        elif isinstance(stmt, ast.Try):
            _walk_body(ms, stmt.body, tracker, np_aliases, out)
            for handler in stmt.handlers:
                _walk_body(ms, handler.body, tracker, np_aliases, out)
            _walk_body(ms, stmt.orelse, tracker, np_aliases, out)
            _walk_body(ms, stmt.finalbody, tracker, np_aliases, out)
        else:
            tracker.observe(stmt)


def _check_calls(
    ms: ModuleScopes,
    stmt: ast.stmt,
    tracker: TaintTracker,
    np_aliases: Set[str],
    out: List[Finding],
) -> None:
    # look at expressions belonging to this statement only, not nested
    # compound bodies (those are walked with their own taint state)
    headers: List[ast.AST] = []
    if isinstance(stmt, (ast.If, ast.While)):
        headers = [stmt.test]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        headers = [stmt.iter]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        headers = [item.context_expr for item in stmt.items]
    elif isinstance(stmt, ast.Try):
        headers = []
    else:
        headers = [stmt]
    for header in headers:
        for node in ast.walk(header):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func) or ""
            t = tail_name(node.func)
            args_tainted = any(tracker.is_tainted(a) for a in node.args) or any(
                tracker.is_tainted(kw.value) for kw in node.keywords
            )
            if isinstance(node.func, ast.Name) and t in _CAST_CALLS and args_tainted:
                out.append(_finding(
                    ms, node, "ST202", "error",
                    f"`{t}()` on a device tensor forces a device-to-host sync "
                    "inside a captured scope (capture forbids it)",
                ))
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _SYNC_METHODS
                and tracker.is_tainted(node.func.value)
            ):
                out.append(_finding(
                    ms, node, "ST202", "error",
                    f"`.{node.func.attr}()` on a device tensor forces a "
                    "device-to-host sync inside a captured scope (capture "
                    "forbids it)",
                ))
            elif (
                np_aliases
                and "." in d
                and d.split(".", 1)[0] in np_aliases
                and args_tainted
            ):
                out.append(_finding(
                    ms, node, "ST203", "error",
                    f"`{d}()` on a device tensor runs host numpy inside a "
                    "captured scope — use torch",
                ))
            elif isinstance(node.func, ast.Name) and t == "print":
                out.append(_finding(
                    ms, node, "ST204", "warning",
                    "`print` inside a captured scope runs once, at capture, "
                    "not per replay",
                ))
            elif d in _CLOCK_CALLS:
                out.append(_finding(
                    ms, node, "ST205", "warning",
                    f"`{d}()` inside a captured scope is baked into the graph "
                    "at capture",
                ))


def _finding(
    ms: ModuleScopes, node: ast.AST, code: str, severity: str, message: str
) -> Finding:
    return Finding(
        file=ms.sm.rel, line=getattr(node, "lineno", 1), code=code,
        severity=severity, message=message,
    )
