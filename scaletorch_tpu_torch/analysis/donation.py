"""ST4xx — reads of a captured step's overwritten outputs.

A captured step (``inference/decode.StaticStep``) returns the CUDA
graph's static output tensors, and the next call of the same step
overwrites them in place: the port's update-in-place stands where the
reference's buffer donation stood. A name still bound to the first
call's outputs then silently reads the second call's values (on the
CPU the step allocates fresh outputs each call, so the bug ships: it
only shows on the card). The engine copies what it keeps (the host copy
of the tokens) before the next step.

ST401  a name bound to a captured step's output is read after a later
       call of the same step, with no rebinding in between (a copy,
       ``out = step(...).clone()``, binds no output and never flags)

The resolver follows the factory idiom (``step = make_step(...)``, a
factory returning ``StaticStep(...)``) across modules, and steps held
on ``self`` (``self._decode = StaticStep(...)``).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding
from .scopes import (
    FuncNode,
    ModuleScopes,
    ProjectIndex,
    collect_captured_steps,
    dotted_name,
)


def run(index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for ms in index.scopes.values():
        findings.extend(_check_module(index, ms))
    return findings


def _enclosing_body(ms: ModuleScopes, node: ast.AST) -> Optional[FuncNode]:
    cur = ms.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = ms.parents.get(cur)
    return None


def _enclosing_stmt(ms: ModuleScopes, node: ast.AST) -> ast.AST:
    cur: ast.AST = node
    while cur in ms.parents and not isinstance(cur, ast.stmt):
        cur = ms.parents[cur]
    return cur


def _target_names(target: ast.AST) -> List[str]:
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for el in target.elts:
            out.extend(_target_names(el))
        return out
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    d = dotted_name(target)
    return [d] if d else []


def _assigned_names(stmt: ast.AST) -> Set[str]:
    """Dotted names (re)bound by a statement, attribute targets
    included."""
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    names: Set[str] = set()
    for t in targets:
        names.update(_target_names(t))
    return names


def _step_calls(ms: ModuleScopes, steps: Dict[str, object]
                ) -> Dict[FuncNode, List[Tuple[ast.Call, str]]]:
    """Calls of captured steps, grouped by the function that makes them."""
    by_scope: Dict[FuncNode, List[Tuple[ast.Call, str]]] = {}
    for call in ast.walk(ms.sm.tree):
        if not isinstance(call, ast.Call):
            continue
        cname = dotted_name(call.func)
        if cname is None or cname not in steps:
            continue
        scope = _enclosing_body(ms, call)
        if scope is not None:
            by_scope.setdefault(scope, []).append((call, cname))
    return by_scope


def _check_module(index: ProjectIndex, ms: ModuleScopes) -> List[Finding]:
    steps = collect_captured_steps(index, ms)
    if not steps:
        return []
    out: List[Finding] = []
    for scope, calls in _step_calls(ms, steps).items():
        calls.sort(key=lambda c: (c[0].lineno, c[0].col_offset))
        for i, (call, cname) in enumerate(calls):
            stmt = _enclosing_stmt(ms, call)
            if not isinstance(stmt, ast.Assign) or stmt.value is not call:
                continue  # the outputs are not bound (or were copied)
            bound: Set[str] = set()
            for t in stmt.targets:
                bound.update(_target_names(t))
            later = next((c for c, n in calls[i + 1:] if n == cname), None)
            if later is None:
                continue
            later_stmt = _enclosing_stmt(ms, later)
            rebound_by_later = _assigned_names(later_stmt)
            for name in sorted(bound - rebound_by_later):
                finding = _read_after_overwrite(
                    ms, scope, stmt, later, name, cname)
                if finding is not None:
                    out.append(finding)
    return out


def _read_after_overwrite(ms: ModuleScopes, scope: FuncNode,
                          bind_stmt: ast.AST, later: ast.Call, name: str,
                          cname: str) -> Optional[Finding]:
    """Line-ordered scan of the function: a rebinding of ``name`` between
    the binding call and the later call clears it; after the later call,
    the first event decides (a read is the bug, a rebinding that does
    not read it ends the hazard)."""
    bind_end = getattr(bind_stmt, "end_lineno", bind_stmt.lineno)
    later_end = getattr(later, "end_lineno", later.lineno)
    events: List[tuple] = []  # (line, kind, node): 0 assign, 1 load
    for node in ast.walk(scope):
        line = getattr(node, "lineno", None)
        if line is None or line <= bind_end:
            continue
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                             ast.For, ast.AsyncFor)):
            if name in _assigned_names(node):
                events.append((line, 0, node))
        if (
            isinstance(node, (ast.Name, ast.Attribute))
            and isinstance(getattr(node, "ctx", None), ast.Load)
            and dotted_name(node) == name
        ):
            events.append((line, 1, node))
    events.sort(key=lambda e: (e[0], e[1]))
    for line, kind, node in events:
        if line <= later_end:
            if kind == 0:
                return None  # rebound before the step runs again
            continue
        if kind == 0:
            value = getattr(node, "value", None) or getattr(node, "iter", None)
            if isinstance(node, ast.AugAssign) or (
                    value is not None and any(
                        isinstance(n, (ast.Name, ast.Attribute))
                        and dotted_name(n) == name for n in ast.walk(value))):
                return _finding(ms, line, name, cname)
            return None
        return _finding(ms, line, name, cname)
    return None


def _finding(ms: ModuleScopes, line: int, name: str, cname: str) -> Finding:
    return Finding(
        file=ms.sm.rel, line=line, code="ST401", severity="error",
        message=(
            f"'{name}' holds the static outputs of captured step "
            f"`{cname}` and is read after a later call of it, which "
            "overwrote them in place (the CPU hands out fresh outputs, "
            "the card's graph does not); copy the outputs before the "
            "next call"
        ),
    )
