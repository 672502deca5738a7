"""ST1xx — mesh-axis and spec-tree consistency.

A ``torch.distributed`` ``DeviceMesh`` raises on an unknown dim name,
but the port resolves most axis names through its own helpers
(``parallel/mesh.py``'s ``MeshManager``, the ``*_axis=`` arguments of
the layers), where an axis that does not exist reads as "not split"
(``group_size`` 1, no collective): a ``tp_axis="tpp"`` typo silently
turns a tensor-parallel layer into a replicated one. This pass makes
the mesh's axis vocabulary (``MESH_AXES`` in ``parallel/mesh.py``) the
single source of truth and flags:

ST101  an axis string outside ``MESH_AXES`` in ``mesh["..."]``,
       ``get_group("...")``/``axis_group("...")``/``group_size("...")``,
       an ``*_axis=`` keyword/default/assignment, an ``axis_name=`` or
       ``mesh_dim_names=`` keyword, a ``PartitionSpec``-style call, or
       a value of a ``*_param_specs`` spec tree
ST102  a key of a ``*_param_specs``/``*_cache_specs`` spec tree that no
       parameter tree in the analyzed set defines (a spec for a key the
       model never creates shards nothing: the partner typo of ST101)
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Set

from .core import Finding, SourceModule
from .scopes import ProjectIndex, find_mesh_axes, tail_name

_SPEC_CALLS = {"PartitionSpec", "P"}
# calls whose string arguments name mesh axes
_AXIS_CALLS = {"get_group", "axis_group", "group_size", "get_local_rank",
               "size_of"}
# Default vocabulary when the analyzed set doesn't include parallel/mesh.py
# and the package source isn't on disk next to this file.
_FALLBACK_AXES = {"dp", "pp", "cp", "ep", "tp"}


def _axes_from_package() -> Optional[Set[str]]:
    mesh_py = Path(__file__).resolve().parent.parent / "parallel" / "mesh.py"
    if not mesh_py.is_file():
        return None
    try:
        tree = ast.parse(mesh_py.read_text(encoding="utf-8"))
    except SyntaxError:
        return None
    return find_mesh_axes(tree)


def declared_axes(index: ProjectIndex, extra: Set[str] = frozenset()) -> Set[str]:
    axes = set(index.declared_axes) or _axes_from_package() or set(_FALLBACK_AXES)
    return axes | set(extra)


def _str_constants(node: ast.AST) -> List[ast.Constant]:
    """String literals in an axis-bearing expression. Nested calls are
    pruned: in ``tuple(a for a in axes if a in getattr(t, "vma", ()))``
    the "vma" belongs to getattr, not to the axis vocabulary."""
    out: List[ast.Constant] = []
    stack: List[ast.AST] = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.append(n)
            continue
        if isinstance(n, ast.Call):
            continue
        stack.extend(ast.iter_child_nodes(n))
    return out


def _value_literals(node: ast.AST) -> List[ast.Constant]:
    """String literals that ARE a spec-tree value: the value itself, or
    an element of a tuple/list value or of either arm of a conditional
    (nested dicts are trees of their own, subscripts and calls hold
    keys and arguments, not axes)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [c for el in node.elts for c in _value_literals(el)]
    if isinstance(node, ast.IfExp):
        return _value_literals(node.body) + _value_literals(node.orelse)
    return []


def _is_axis_name(name: str) -> bool:
    return (
        name in ("axis", "axes", "axis_name")
        or name.endswith("_axis")
        or name.endswith("_axes")
    )


def _is_spec_fn(name: str) -> bool:
    return name.endswith("_param_specs") or name.endswith("_cache_specs")


def run(index: ProjectIndex, extra_axes: Set[str] = frozenset()) -> List[Finding]:
    axes = declared_axes(index, extra_axes)
    findings: List[Finding] = []
    for sm in index.modules:
        findings.extend(_check_module(sm, axes, index.param_keys))
    return findings


def _check_module(
    sm: SourceModule, axes: Set[str], param_keys: Set[str]
) -> List[Finding]:
    out: List[Finding] = []

    def bad_axis(const: ast.Constant, where: str) -> None:
        # The declared-axes list deliberately stays OUT of the message:
        # baseline entries match on (file, code, message), and embedding
        # the vocabulary would invalidate every baselined ST101 whenever
        # a mesh axis is added (see parallel/mesh.py MESH_AXES).
        out.append(Finding(
            file=sm.rel, line=const.lineno, code="ST101", severity="error",
            message=(
                f"axis '{const.value}' in {where} is not a declared mesh "
                f"axis — an unknown axis reads as not split (no group, no "
                f"collective)"
            ),
        ))

    for node in ast.walk(sm.tree):
        # PartitionSpec("tp", ...) / P(None, ("dp", "ep"), ...) literals
        if isinstance(node, ast.Call) and tail_name(node.func) in _SPEC_CALLS:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                for const in _str_constants(arg):
                    if const.value not in axes:
                        bad_axis(const, "PartitionSpec")
        # mesh.get_group("tp") / axis_group("cp") / group_size("tp")
        if isinstance(node, ast.Call) and \
                tail_name(node.func) in _AXIS_CALLS:
            for arg in node.args[:1]:
                for const in _str_constants(arg):
                    if const.value not in axes:
                        bad_axis(const, f"{tail_name(node.func)}()")
        # mesh["tp"] / self.mesh["dp", "cp"] on a DeviceMesh
        if isinstance(node, ast.Subscript) and \
                (tail_name(node.value) or "").lower().endswith("mesh"):
            for const in _str_constants(node.slice):
                if const.value not in axes:
                    bad_axis(const, "a mesh subscript")
        # f(..., tp_axis="tp", axis="cp", shard_axes=("tp", "pp")) keywords
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg and _is_axis_name(kw.arg):
                    for const in _str_constants(kw.value):
                        if const.value not in axes:
                            bad_axis(const, f"keyword {kw.arg}=")
        # def f(..., tp_axis: str = "tp", axes=("tp", "pp")) defaults
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            pos = a.posonlyargs + a.args
            for arg, default in zip(pos[len(pos) - len(a.defaults):], a.defaults):
                if _is_axis_name(arg.arg):
                    for const in _str_constants(default):
                        if const.value not in axes:
                            bad_axis(const, f"default of {arg.arg}")
            for arg, default in zip(a.kwonlyargs, a.kw_defaults):
                if default is not None and _is_axis_name(arg.arg):
                    for const in _str_constants(default):
                        if const.value not in axes:
                            bad_axis(const, f"default of {arg.arg}")
        # seq_axis = "cp" / all_axes = ("dp",) + ... / "pp" if pp else None
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if any(_is_axis_name(t) for t in targets):
                for const in _str_constants(node.value):
                    if const.value not in axes:
                        bad_axis(const, f"assignment to {', '.join(targets)}")

    # ST102: spec-tree keys must reference keys some param tree defines
    for fn_node in ast.walk(sm.tree):
        if not isinstance(fn_node, ast.FunctionDef) or not _is_spec_fn(fn_node.name):
            continue
        spec_keys: List[ast.Constant] = []
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Dict):
                spec_keys.extend(
                    k for k in node.keys
                    if isinstance(k, ast.Constant) and isinstance(k.value, str)
                )
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        sl = t.slice
                        if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                            spec_keys.append(sl)
        # a string among the tree's values names a mesh axis
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Dict):
                for v in node.values:
                    for const in _value_literals(v):
                        if const.value not in axes:
                            bad_axis(const, f"spec tree {fn_node.name}")
        unknown = [k for k in spec_keys if k.value not in param_keys]
        # If NO key resolves, the param-defining module is simply outside
        # the analyzed set (subset run) — stay quiet rather than flag the
        # whole tree. A genuine typo shows up as a minority of unknowns.
        if unknown and len(unknown) < len(spec_keys):
            for k in unknown:
                out.append(_st102(sm, k, fn_node.name))
    return out


def _st102(sm: SourceModule, const: ast.Constant, fn: str) -> Finding:
    return Finding(
        file=sm.rel, line=const.lineno, code="ST102", severity="error",
        message=(
            f"spec key '{const.value}' in {fn} does not match any param-tree "
            f"key in the analyzed modules — the spec silently shards nothing"
        ),
    )
