"""Captured-scope resolver and taint engine of the analyzer.

Two questions every pass keeps asking are answered here, once:

1. **Which code is captured?** On the card the port runs its serving
   steps as CUDA graphs: a step function is handed to
   ``inference/decode.StaticStep`` (which captures it with
   ``torch.cuda.graph``), a block runs under ``with torch.cuda.graph(g)``,
   or a callable is handed to ``torch.cuda.make_graphed_callables``. The
   capture records the kernels the function launches once and replays
   them: host code in the function runs once, at capture, and never
   again. A function body is a **captured scope** when it is handed to
   one of those, when a ``torch.cuda.graph`` block calls it, when it is
   lexically nested inside a captured scope (inner helpers run with
   their parent), or when a captured scope of the same module calls it
   by name (its parameters are tensors only where the caller passes
   one). ``ProjectIndex`` resolves the factory idiom the port uses::

       def make_step(...):
           def step(tokens, positions):
               ...
           return StaticStep(step, inputs, device)

   ``step`` is a captured scope, ``make_step`` a *capture factory*, and
   names bound from its call sites are captured steps (imports followed
   module to module, best effort).

2. **Which values are device tensors?** ``TaintTracker`` runs a
   linear, order-sensitive walk over a captured function body: the
   parameters start tainted (minus those the caller passes host values
   for), assignment propagates taint, reassignment from untainted
   expressions clears it. Static facts about a tensor (``.shape``,
   ``.ndim``, ``.dtype``, ``.device``, ``len()``, ``isinstance()``,
   ``is None``) are sanitizers: branching on them is fixed at capture
   and must not flag.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

from .core import SourceModule

FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]

# Callables whose function-valued first argument is captured.
_CAPTURE_WRAPPERS = {"StaticStep", "make_graphed_callables"}
# Context managers whose block is captured (``torch.cuda.graph(g)``).
_GRAPH_CONTEXTS = {"graph"}

_SANITIZER_ATTRS = {
    "shape", "ndim", "dtype", "size", "itemsize", "device", "is_cuda",
    "nbytes", "layout", "requires_grad", "is_floating_point", "dim",
    "numel", "element_size",
}
_SANITIZER_CALLS = {"len", "isinstance", "type", "hasattr", "getattr", "id"}


def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.cuda.graph' for Attribute/Name chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def tail_name(node: ast.AST) -> Optional[str]:
    """Last component of a dotted name ('graph' for torch.cuda.graph)."""
    d = dotted_name(node)
    return d.rsplit(".", 1)[-1] if d else None


def _const_str_set(node: Optional[ast.AST]) -> Optional[Set[str]]:
    if node is None:
        return set()
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List)):
        out: Set[str] = set()
        for el in node.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                out.add(el.value)
            else:
                return None
        return out
    return None


@dataclasses.dataclass
class CaptureInfo:
    """How one function runs under a capture. ``kind`` is "capture" (a
    function handed to StaticStep / make_graphed_callables), "graph" (a
    function a ``torch.cuda.graph`` block calls) or "called" (a function
    a captured scope calls). ``static_argnums`` / ``static_argnames``
    hold the parameters a caller passes host values for (None: not
    known statically)."""

    kind: str
    node: Optional[FuncNode] = None
    static_argnums: Optional[Set[int]] = dataclasses.field(default_factory=set)
    static_argnames: Optional[Set[str]] = dataclasses.field(default_factory=set)


def _is_capture_wrapper(call_func: ast.AST) -> bool:
    return tail_name(call_func) in _CAPTURE_WRAPPERS


def _is_graph_context(expr: ast.AST) -> bool:
    """``torch.cuda.graph(g, ...)`` (or ``graph`` imported from it)."""
    if not isinstance(expr, ast.Call):
        return False
    d = dotted_name(expr.func) or ""
    return tail_name(expr.func) in _GRAPH_CONTEXTS and (
        d == "graph" or d.endswith("cuda.graph"))


def _capture_target(call: ast.Call) -> Optional[ast.AST]:
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg in ("fn", "callables"):
            return kw.value
    return None


class ModuleScopes:
    """Per-module scope facts: captured functions, captured-step names,
    capture factories."""

    def __init__(self, sm: SourceModule) -> None:
        self.sm = sm
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(sm.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        # every named function, by (possibly shadowed) bare name
        self.functions: Dict[str, List[ast.FunctionDef]] = {}
        for node in ast.walk(sm.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.setdefault(node.name, []).append(node)
        # directly captured function nodes -> CaptureInfo
        self.traced: Dict[FuncNode, CaptureInfo] = {}
        # module-level names bound to captured steps (s = StaticStep(f, ...))
        self.step_names: Dict[str, CaptureInfo] = {}
        # top-level functions that RETURN a captured step
        self.factories: Dict[str, CaptureInfo] = {}
        # import map: local name -> (module, original name)
        self.imports: Dict[str, Tuple[str, str]] = {}
        self._collect_imports()
        self._collect_captured()
        self._collect_factories()
        self._propagate_calls()

    # -- imports --------------------------------------------------------------
    def _collect_imports(self) -> None:
        pkg_parts = self.sm.module.split(".")
        for node in ast.walk(self.sm.tree):
            if isinstance(node, ast.ImportFrom):
                if node.level:  # relative import
                    base = pkg_parts[: len(pkg_parts) - node.level]
                    mod = ".".join(base + ([node.module] if node.module else []))
                else:
                    mod = node.module or ""
                for alias in node.names:
                    self.imports[alias.asname or alias.name] = (mod, alias.name)

    # -- captured scopes ------------------------------------------------------
    def _resolve_local_fn(self, name_node: ast.AST, at: ast.AST
                          ) -> Optional[ast.FunctionDef]:
        """Resolve a Name argument to the function it most plausibly
        references (same bare name; prefer a sibling in the same scope)."""
        if not isinstance(name_node, ast.Name):
            return None
        cands = self.functions.get(name_node.id)
        if not cands:
            return None
        if len(cands) == 1:
            return cands[0]
        enclosing = self._enclosing_function(at)
        for c in cands:
            if self._enclosing_function(c) is enclosing:
                return c
        return cands[-1]

    def _enclosing_function(self, node: ast.AST) -> Optional[FuncNode]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = self.parents.get(cur)
        return None

    def _mark(self, fn: Optional[FuncNode], info: CaptureInfo) -> bool:
        if fn is None:
            return False
        prev = self.traced.get(fn)
        if prev is None:
            info.node = fn
            self.traced[fn] = info
            return True
        if prev.kind == "called" and info.kind == "called":
            # a second call site: a parameter stays host-only when every
            # caller passes a host value for it
            nums = (None if prev.static_argnums is None
                    or info.static_argnums is None
                    else prev.static_argnums & info.static_argnums)
            names = (None if prev.static_argnames is None
                     or info.static_argnames is None
                     else prev.static_argnames & info.static_argnames)
            if nums != prev.static_argnums or names != prev.static_argnames:
                prev.static_argnums, prev.static_argnames = nums, names
                return True
        elif prev.kind == "called":
            info.node = fn
            self.traced[fn] = info
            return True
        return False

    def _mark_target(self, target: Optional[ast.AST], at: ast.AST,
                     kind: str) -> Optional[CaptureInfo]:
        if target is None:
            return None
        info = CaptureInfo(kind=kind)
        if isinstance(target, ast.Lambda):
            self._mark(target, info)
            return info
        fn = self._resolve_local_fn(target, at)
        if fn is not None:
            self._mark(fn, info)
        return info

    def _collect_captured(self) -> None:
        for node in ast.walk(self.sm.tree):
            if isinstance(node, ast.Call) and _is_capture_wrapper(node.func):
                info = self._mark_target(_capture_target(node), node,
                                         "capture")
                parent = self.parents.get(node)
                if info is not None and isinstance(parent, ast.Assign):
                    for t in parent.targets:
                        if isinstance(t, ast.Name):
                            self.step_names[t.id] = info
            elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    _is_graph_context(item.context_expr)
                    for item in node.items):
                # a block's call passes tensors except where it passes
                # a literal (a host value fixed at capture)
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if not isinstance(sub, ast.Call):
                            continue
                        fn = self._resolve_local_fn(sub.func, sub)
                        if fn is not None:
                            self._mark(fn, CaptureInfo(
                                kind="graph",
                                static_argnums={
                                    i for i, a in enumerate(sub.args)
                                    if isinstance(a, ast.Constant)},
                                static_argnames={
                                    kw.arg for kw in sub.keywords
                                    if isinstance(kw.value, ast.Constant)}))

    def _propagate_calls(self) -> None:
        """Functions a captured scope calls by name run under the same
        capture; a parameter is a tensor only where some caller passes
        a tainted value for it."""
        changed = True
        rounds = 0
        while changed and rounds < 50:
            changed = False
            rounds += 1
            for fn, info in list(self.traced_functions()):
                tracker = TaintTracker(fn, info)
                body = fn.body if isinstance(fn.body, list) else [fn.body]
                for stmt in _linear(body):
                    for sub in _own_nodes(stmt):
                        if not isinstance(sub, ast.Call) or \
                                not isinstance(sub.func, ast.Name):
                            continue
                        callee = self._resolve_local_fn(sub.func, sub)
                        if callee is None or callee is fn or \
                                self._is_lexically_inside(callee, fn):
                            continue
                        static_nums = {
                            i for i, a in enumerate(sub.args)
                            if not isinstance(a, ast.Starred)
                            and not tracker.is_tainted(a)}
                        n_pos = len(callee.args.posonlyargs
                                    + callee.args.args)
                        static_nums |= set(range(len(sub.args), n_pos))
                        static_names = {
                            kw.arg for kw in sub.keywords
                            if kw.arg and not tracker.is_tainted(kw.value)}
                        passed = {kw.arg for kw in sub.keywords if kw.arg}
                        static_names |= {
                            a.arg for a in (callee.args.args
                                            + callee.args.kwonlyargs)
                            if a.arg not in passed}
                        if any(isinstance(a, ast.Starred)
                               for a in sub.args) or any(
                                   kw.arg is None for kw in sub.keywords):
                            static_nums, static_names = set(), set()
                        if self._mark(callee, CaptureInfo(
                                kind="called", static_argnums=static_nums,
                                static_argnames=static_names)):
                            changed = True
                    tracker.observe(stmt)

    def _is_lexically_inside(self, node: ast.AST, outer: ast.AST) -> bool:
        cur = self.parents.get(node)
        while cur is not None:
            if cur is outer:
                return True
            cur = self.parents.get(cur)
        return False

    # -- factories ------------------------------------------------------------
    def _returned_capture_info(self, fn: ast.FunctionDef
                               ) -> Optional[CaptureInfo]:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Return) or node.value is None:
                continue
            v = node.value
            if isinstance(v, ast.Call) and _is_capture_wrapper(v.func):
                return CaptureInfo(kind="capture")
            # `return step` where step = StaticStep(...) earlier in the body
            if isinstance(v, ast.Name):
                for inner in ast.walk(fn):
                    if (
                        isinstance(inner, ast.Assign)
                        and isinstance(inner.value, ast.Call)
                        and _is_capture_wrapper(inner.value.func)
                        and any(isinstance(t, ast.Name) and t.id == v.id
                                for t in inner.targets)
                    ):
                        return CaptureInfo(kind="capture")
        return None

    def _collect_factories(self) -> None:
        for node in self.sm.tree.body:
            if isinstance(node, ast.FunctionDef):
                info = self._returned_capture_info(node)
                if info is not None:
                    self.factories[node.name] = info

    # -- queries --------------------------------------------------------------
    def is_traced(self, fn: FuncNode) -> Optional[CaptureInfo]:
        """CaptureInfo if ``fn`` or any lexical ancestor is a captured scope."""
        cur: Optional[ast.AST] = fn
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                info = self.traced.get(cur)
                if info is not None:
                    # nested helpers inherit the capture, every parameter
                    # a tensor
                    if cur is fn:
                        return info
                    return CaptureInfo(kind=info.kind, node=fn)
            cur = self.parents.get(cur)
        return None

    def traced_functions(self) -> List[Tuple[FuncNode, CaptureInfo]]:
        """Every function body that runs under a capture, nested helpers
        included."""
        out: List[Tuple[FuncNode, CaptureInfo]] = []
        for node in ast.walk(self.sm.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                info = self.is_traced(node)
                if info is not None:
                    out.append((node, info))
        return out


def _linear(body: List[ast.stmt]):
    """Statements of a body in program order, compound bodies flattened
    after their header."""
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield stmt
        for field in ("body", "orelse", "finalbody"):
            inner = getattr(stmt, field, None)
            if isinstance(inner, list) and inner and \
                    isinstance(inner[0], ast.stmt):
                yield from _linear(inner)
        for handler in getattr(stmt, "handlers", []) or []:
            yield from _linear(handler.body)


def _own_nodes(stmt: ast.AST):
    """The nodes of one statement's own expressions: nested statement
    bodies, defs and lambdas excluded."""
    if isinstance(stmt, ast.Expr) or not hasattr(stmt, "body"):
        roots = [stmt]
    elif isinstance(stmt, (ast.If, ast.While)):
        roots = [stmt.test]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        roots = [stmt.iter]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        roots = [item.context_expr for item in stmt.items]
    else:
        roots = []
    stack = list(roots)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class ProjectIndex:
    """Cross-module facts shared by all passes."""

    def __init__(self, modules: Sequence[SourceModule]) -> None:
        self.modules = list(modules)
        self.scopes: Dict[str, ModuleScopes] = {
            sm.rel: ModuleScopes(sm) for sm in modules
        }
        self.by_module: Dict[str, ModuleScopes] = {
            ms.sm.module: ms for ms in self.scopes.values()
        }
        self.declared_axes: Set[str] = self._find_declared_axes()
        self.param_keys: Set[str] = self._collect_param_keys()

    # -- mesh axes ------------------------------------------------------------
    def _find_declared_axes(self) -> Set[str]:
        """Axis names from ``MESH_AXES = (...)`` in the analyzed set; the
        sharding pass falls back to the package source when analyzing a
        subset that excludes parallel/mesh.py."""
        for sm in self.modules:
            axes = find_mesh_axes(sm.tree)
            if axes:
                return axes
        return set()

    # -- param-key universe ---------------------------------------------------
    def _collect_param_keys(self) -> Set[str]:
        """All string dict keys, subscripts and attribute names used
        OUTSIDE ``*_specs`` functions: the universe a spec tree's keys
        must reference. A module's parameters are attributes
        (``self.q_proj = nn.Linear(...)``), so their names count too."""
        keys: Set[str] = set()
        for ms in self.scopes.values():
            spec_fns = [
                fns[-1] for name, fns in ms.functions.items()
                if name.endswith("_specs")
            ]
            spec_nodes: Set[ast.AST] = set()
            for fn in spec_fns:
                spec_nodes.update(ast.walk(fn))
            for node in ast.walk(ms.sm.tree):
                if node in spec_nodes:
                    continue
                if isinstance(node, ast.Dict):
                    for k in node.keys:
                        if isinstance(k, ast.Constant) and isinstance(k.value, str):
                            keys.add(k.value)
                elif isinstance(node, ast.Subscript):
                    sl = node.slice
                    if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                        keys.add(sl.value)
                elif isinstance(node, ast.Attribute) and isinstance(
                        node.ctx, ast.Store):
                    keys.add(node.attr)
                elif isinstance(node, ast.Call) and \
                        tail_name(node.func) == "dict":
                    keys.update(kw.arg for kw in node.keywords if kw.arg)
        return keys

    # -- captured-step resolution ---------------------------------------------
    def resolve_factory(self, ms: ModuleScopes, call_func: ast.AST
                        ) -> Optional[CaptureInfo]:
        """CaptureInfo when ``call_func`` names a capture factory (local or
        imported), else None."""
        name = dotted_name(call_func)
        if name is None:
            return None
        bare = name.rsplit(".", 1)[-1]
        if name in ms.factories or bare in ms.factories:
            return ms.factories.get(name) or ms.factories[bare]
        imp = ms.imports.get(name) or ms.imports.get(bare)
        if imp is not None:
            target = self.by_module.get(imp[0])
            if target is not None and imp[1] in target.factories:
                return target.factories[imp[1]]
        return None


def find_mesh_axes(tree: ast.Module) -> Optional[Set[str]]:
    """``MESH_AXES`` value from a module, plain or annotated assignment."""
    for node in ast.walk(tree):
        value: Optional[ast.AST] = None
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "MESH_AXES" for t in node.targets
        ):
            value = node.value
        elif (
            isinstance(node, ast.AnnAssign)
            and isinstance(node.target, ast.Name)
            and node.target.id == "MESH_AXES"
        ):
            value = node.value
        if value is not None:
            axes = _const_str_set(value)
            if axes:
                return axes
    return None


def collect_captured_steps(
    index: ProjectIndex, ms: ModuleScopes
) -> Dict[str, CaptureInfo]:
    """Names in ``ms`` bound to captured steps, keyed by the dotted name
    call sites use (``step``, ``self._decode`` ...): direct wrapping
    (``s = StaticStep(f, ...)``) and the factory idiom (``s =
    make_step(...)`` where the factory, local or imported, returns a
    StaticStep)."""
    out: Dict[str, CaptureInfo] = dict(ms.step_names)
    for node in ast.walk(ms.sm.tree):
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
            continue
        call = node.value
        info: Optional[CaptureInfo] = None
        if _is_capture_wrapper(call.func):
            info = CaptureInfo(kind="capture")
        else:
            info = index.resolve_factory(ms, call.func)
        if info is None:
            continue
        for t in node.targets:
            name = dotted_name(t)
            if name:
                out[name] = info
    return out


# ---- taint ------------------------------------------------------------------

class TaintTracker:
    """Order-sensitive device-tensor taint for one captured function."""

    def __init__(self, fn: FuncNode, info: CaptureInfo) -> None:
        self.fn = fn
        self.tainted: Set[str] = set()
        args = fn.args
        names: List[str] = [a.arg for a in args.posonlyargs + args.args]
        static_idx = info.static_argnums if info.static_argnums is not None else set()
        static_names = info.static_argnames if info.static_argnames is not None else set()
        for i, n in enumerate(names):
            if i in static_idx or n in static_names:
                continue
            self.tainted.add(n)
        for a in args.kwonlyargs:
            if a.arg not in static_names:
                self.tainted.add(a.arg)
        if args.vararg:
            self.tainted.add(args.vararg.arg)
        if args.kwarg:
            self.tainted.add(args.kwarg.arg)
        # `self` in methods is configuration, not a tensor
        self.tainted.discard("self")
        # names bound to lambdas that map tensors to static facts
        self.sanitizer_names: Set[str] = set()

    # -- expression tainting --------------------------------------------------
    def is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _SANITIZER_ATTRS:
                return False
            return self.is_tainted(node.value)
        if isinstance(node, ast.Call):
            fname = tail_name(node.func)
            if fname in _SANITIZER_CALLS or fname in self.sanitizer_names \
                    or fname in _SANITIZER_ATTRS:
                return False
            return (
                any(self.is_tainted(a) for a in node.args)
                or any(self.is_tainted(kw.value) for kw in node.keywords)
                or (isinstance(node.func, ast.Attribute)
                    and self.is_tainted(node.func.value))
            )
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            return self._comprehension_tainted(node)
        if isinstance(node, ast.Compare):
            # `x is None` / `x is not None` is a static structure test
            if (
                all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops)
                and all(isinstance(c, ast.Constant) and c.value is None
                        for c in node.comparators)
            ):
                return False
            return self.is_tainted(node.left) or any(
                self.is_tainted(c) for c in node.comparators
            )
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return False
        return any(
            self.is_tainted(child) for child in ast.iter_child_nodes(node)
        )

    def _comprehension_tainted(self, node: ast.AST) -> bool:
        """A comprehension's taint is its ELEMENT expression's taint with
        the targets tainted from their iterables."""
        saved = set(self.tainted)
        try:
            for gen in node.generators:
                self._observe_loop(gen.target, gen.iter)
            for gen in node.generators:
                if any(self.is_tainted(cond) for cond in gen.ifs):
                    return True
            if isinstance(node, ast.DictComp):
                return self.is_tainted(node.key) or self.is_tainted(node.value)
            return self.is_tainted(node.elt)
        finally:
            self.tainted = saved

    # -- statement effects ----------------------------------------------------
    def _assign_target_names(self, target: ast.AST) -> List[str]:
        if isinstance(target, ast.Name):
            return [target.id]
        if isinstance(target, (ast.Tuple, ast.List)):
            out: List[str] = []
            for el in target.elts:
                out.extend(self._assign_target_names(el))
            return out
        if isinstance(target, ast.Starred):
            return self._assign_target_names(target.value)
        return []

    def observe(self, stmt: ast.stmt) -> None:
        """Update taint for one statement (no recursion into compound
        bodies: callers walk those explicitly)."""
        if isinstance(stmt, ast.Assign):
            if isinstance(stmt.value, ast.Lambda):
                self._observe_lambda_alias(stmt)
                return
            t = self.is_tainted(stmt.value)
            for target in stmt.targets:
                for name in self._assign_target_names(target):
                    (self.tainted.add if t else self.tainted.discard)(name)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            if isinstance(stmt.target, ast.Name):
                t = self.is_tainted(stmt.value)
                (self.tainted.add if t else self.tainted.discard)(stmt.target.id)
        elif isinstance(stmt, ast.AugAssign):
            if isinstance(stmt.target, ast.Name) and self.is_tainted(stmt.value):
                self.tainted.add(stmt.target.id)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._observe_loop(stmt.target, stmt.iter)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                if item.optional_vars is not None and self.is_tainted(item.context_expr):
                    for name in self._assign_target_names(item.optional_vars):
                        self.tainted.add(name)

    def _observe_lambda_alias(self, stmt: ast.Assign) -> None:
        """``f = lambda x: <expr>``: if <expr> is untainted even with the
        lambda's params tainted, ``f(...)`` maps tensors to static facts
        and becomes a sanitizer for this scope."""
        lam = stmt.value
        assert isinstance(lam, ast.Lambda)
        saved = set(self.tainted)
        try:
            for a in lam.args.posonlyargs + lam.args.args + lam.args.kwonlyargs:
                self.tainted.add(a.arg)
            body_tainted = self.is_tainted(lam.body)
        finally:
            self.tainted = saved
        for target in stmt.targets:
            for name in self._assign_target_names(target):
                self.tainted.discard(name)
                if not body_tainted:
                    self.sanitizer_names.add(name)
                else:
                    self.sanitizer_names.discard(name)

    def _observe_loop(self, target: ast.AST, iter_expr: ast.AST) -> None:
        """Taint loop targets from the iterable, element-wise through
        ``zip``/``enumerate``."""
        if (
            isinstance(iter_expr, ast.Call)
            and isinstance(iter_expr.func, ast.Name)
            and isinstance(target, ast.Tuple)
        ):
            fname = iter_expr.func.id
            if fname == "zip" and len(iter_expr.args) == len(target.elts):
                for src, tgt in zip(iter_expr.args, target.elts):
                    self._observe_loop(tgt, src)
                return
            if fname == "enumerate" and len(target.elts) == 2 and iter_expr.args:
                for name in self._assign_target_names(target.elts[0]):
                    self.tainted.discard(name)
                self._observe_loop(target.elts[1], iter_expr.args[0])
                return
        t = self.is_tainted(iter_expr)
        for name in self._assign_target_names(target):
            (self.tainted.add if t else self.tainted.discard)(name)
