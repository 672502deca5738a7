"""ST907 — telemetry JSONL ``kind`` strings must be registered.

Every consumer of the schema-versioned JSONL stream (slo_check, fleet
log aggregation, the offline histogram merger) dispatches on the
``kind`` field, and ``telemetry/export.py`` documents ``KNOWN_KINDS``
as the kinds consumers can rely on. A new emitter added without
registering its kind — the ``gateway_metrics``-style drift this pass
exists for — ships records no consumer knows to parse, and nothing
crashes: the data is just silently unconsumed.

The pass finds every string-literal kind handed to the telemetry
exporter (``<...>exporter.emit("kind", ...)`` and the
``telemetry.export("kind", ...)`` facade) and checks it against the
``KNOWN_KINDS`` tuple, read from ``telemetry/export.py`` in the
analyzed set or — when linting a subset that excludes it — from the
installed package source (the same fallback the sharding pass uses for
``MESH_AXES``). Variable kinds (the facade's pass-through) and call
sites outside the package (tests emitting free-form kinds) are not the
target and never flag.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Set

from .core import Finding
from .scopes import ProjectIndex, dotted_name

_REGISTRY_NAME = "KNOWN_KINDS"


def _kinds_from_tree(tree: ast.Module) -> Optional[Set[str]]:
    for node in ast.walk(tree):
        targets: List[ast.AST] = []
        value: Optional[ast.AST] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign):
            targets, value = [node.target], node.value
        if value is None or not any(
            isinstance(t, ast.Name) and t.id == _REGISTRY_NAME
            for t in targets
        ):
            continue
        if isinstance(value, (ast.Tuple, ast.List, ast.Set)):
            out: Set[str] = set()
            for el in value.elts:
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    out.add(el.value)
                else:
                    return None  # dynamic registry: don't guess
            return out
    return None


def _load_registry(index: ProjectIndex) -> Optional[Set[str]]:
    for sm in index.modules:
        if sm.module.endswith("telemetry.export") or \
                sm.rel.endswith("telemetry/export.py"):
            return _kinds_from_tree(sm.tree)
    # linting a subset: fall back to the installed package source
    export_py = Path(__file__).resolve().parent.parent / "telemetry" \
        / "export.py"
    if export_py.is_file():
        try:
            return _kinds_from_tree(ast.parse(export_py.read_text(
                encoding="utf-8")))
        except (OSError, SyntaxError):
            return None
    return None


def _is_exporter_recv(d: str) -> bool:
    tail = d.rsplit(".", 1)[-1]
    return tail in ("exporter", "_exporter") or tail.endswith("_exporter")


def run(index: ProjectIndex) -> List[Finding]:
    registry = _load_registry(index)
    if registry is None:
        return []  # no registry visible: nothing to check against
    findings: List[Finding] = []
    for ms in index.scopes.values():
        for node in ast.walk(ms.sm.tree):
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Attribute):
                continue
            recv = dotted_name(node.func.value) or ""
            if node.func.attr == "emit" and _is_exporter_recv(recv):
                pass
            elif node.func.attr == "export" and \
                    recv.rsplit(".", 1)[-1] in ("telemetry", "_telemetry"):
                pass
            else:
                continue
            if not node.args:
                continue
            kind = node.args[0]
            if not (isinstance(kind, ast.Constant)
                    and isinstance(kind.value, str)):
                continue  # variable kind: the facade pass-through
            if kind.value not in registry:
                findings.append(Finding(
                    file=ms.sm.rel, line=node.lineno, code="ST907",
                    severity="error",
                    message=(
                        f"JSONL kind '{kind.value}' is not registered in "
                        "telemetry/export.py KNOWN_KINDS — consumers "
                        "dispatch on the kind field and silently drop "
                        "unknown ones; add it to the registry (additive, "
                        "schema version stays)"
                    ),
                ))
    findings.sort(key=lambda f: (f.file, f.line))
    return findings
