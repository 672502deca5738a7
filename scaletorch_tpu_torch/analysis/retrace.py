"""ST5xx — literals handed to a captured step.

A captured step (``inference/decode.StaticStep``) fixes the shape and
dtype of each input when it is captured, and a call copies host arrays
into those static buffers. Call-site literals break that one-capture
contract:

ST501  a dict/list literal passed to a captured step — its structure
       and length are rebuilt per call, and a changed length no longer
       fits the captured buffer (it fails at replay, or forces a second
       capture)
ST502  a bare Python scalar literal — it carries Python's dtype
       (int64/float64/bool), not the captured input's; pass an array
       of the input's dtype

Both are warnings: each individual site may work; the cost appears when
a second call site disagrees.
"""

from __future__ import annotations

import ast
from typing import List

from .core import Finding
from .scopes import (
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


def _check_module(index: ProjectIndex, ms: ModuleScopes) -> List[Finding]:
    steps = collect_captured_steps(index, ms)
    if not steps:
        return []
    out: List[Finding] = []
    for call in ast.walk(ms.sm.tree):
        if not isinstance(call, ast.Call):
            continue
        cname = dotted_name(call.func)
        info = steps.get(cname) if cname else None
        if info is None:
            continue
        static_idx = info.static_argnums
        static_names = info.static_argnames
        for i, arg in enumerate(call.args):
            if static_idx is None or i in static_idx:
                continue  # static (or unknown argnums: stay quiet)
            out.extend(_check_arg(ms, cname, arg, f"positional arg {i}"))
        for kw in call.keywords:
            if kw.arg is None:
                continue
            if static_names is None or kw.arg in static_names:
                continue
            out.extend(_check_arg(ms, cname, kw.value, f"keyword {kw.arg}="))
    return out


def _check_arg(
    ms: ModuleScopes, cname: str, arg: ast.AST, where: str
) -> List[Finding]:
    if isinstance(arg, (ast.Dict, ast.List)):
        kind = "dict" if isinstance(arg, ast.Dict) else "list"
        return [Finding(
            file=ms.sm.rel, line=arg.lineno, code="ST501", severity="warning",
            message=(
                f"{kind} literal passed to captured step `{cname}` ({where}) "
                "— the capture fixed its inputs' shapes, a changed "
                "length no longer fits the static buffer; pass an array"
            ),
        )]
    if isinstance(arg, ast.Constant) and type(arg.value) in (int, float, bool):
        return [Finding(
            file=ms.sm.rel, line=arg.lineno, code="ST502", severity="warning",
            message=(
                f"Python scalar literal {arg.value!r} passed to captured "
                f"step `{cname}` ({where}) — it carries Python's dtype, "
                "not the captured input's; pass an array of that dtype"
            ),
        )]
    return []
