"""Thread-root & lockset resolver for the concurrency tier (ST9xx).

The concurrency pass keeps asking the same three questions the capture
passes ask ``scopes.py``:

1. **Which code runs on which thread?** ``ThreadModel`` discovers the
   *thread roots* of the analyzed set — ``threading.Thread(target=...)``
   targets (methods, local defs, lambdas), handlers registered via
   ``signal.signal``/``loop.add_signal_handler``, every ``async def``
   (one shared asyncio-loop root — coroutine bodies execute on the
   event loop no matter which thread constructs them), and the *caller*
   root of a thread-owning class (its public methods are, by
   construction, invoked from some other thread than the one it spawns).
   Closures are attributed to where they are *executed*, not where they
   are defined: a closure handed to ``self._inbox.put`` runs wherever
   ``self._inbox.get()`` results are invoked (the worker-inbox
   trampoline this codebase's gateway uses), a callable handed to
   ``call_soon_threadsafe``/``run_coroutine_threadsafe`` runs on the
   loop, a method assigned to a callback attribute (``engine.on_tokens =
   self._hook``) runs wherever ``self.on_tokens(...)`` is called.

2. **Which calls reach which functions?** A deliberately *typed-only*
   call graph: ``self.m()`` resolves to the enclosing class's method,
   ``x.m()`` resolves only when ``x``'s class is statically known (a
   ``self.a = C(...)`` / ``C.from_*(...)`` assignment, an annotation
   naming a package class, or a local bound from one of those).
   Name-only "any method called m" matching is deliberately NOT done:
   over-approximate reachability turns into false races, and the
   concurrency tier holds the same zero-false-positive bar as the rest
   of the analyzer. Under-approximation (a missed edge) only costs recall.

3. **Which locks are held where?** Lock objects are attributes/globals
   assigned ``threading.Lock()``/``RLock()``/``Semaphore()``; held-sets
   are propagated from each root through the call graph (``with lock:``
   scopes and the locks held at a call site flow into the callee), so a
   mutation's *effective* lockset reflects the whole path from its
   root, not just its lexical ``with`` nesting.

Known limitations (documented in docs/static_analysis.md): attribute
identity is per-class (``self._x`` in class C), so aliased cross-object
state is invisible; unresolvable dynamic calls drop edges (never add
them); exclusion protocols that serialize by state machine rather than
by lock (one side locked, the other provably-not-concurrent) are
respected by flagging only when *two or more* roots mutate with no lock
at all.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .scopes import ModuleScopes, ProjectIndex, dotted_name, tail_name

# ---------------------------------------------------------------------------
# vocabulary
# ---------------------------------------------------------------------------

# threading.X() constructors -> lock kind ("lock" is non-reentrant).
_LOCK_CTORS = {
    "Lock": "lock", "RLock": "rlock", "Semaphore": "lock",
    "BoundedSemaphore": "lock",
}
# external object kinds the typer tracks (receiver methods on these are
# never resolved to package functions; some drive pass rules directly)
_EXTERNAL_CTORS = {
    ("threading", "Event"): "tevent",
    ("threading", "Thread"): "thread",
    ("threading", "Condition"): "rlock",   # backed by an RLock
    ("queue", "Queue"): "queue",
    ("queue", "SimpleQueue"): "queue",
    ("queue", "LifoQueue"): "queue",
    ("queue", "PriorityQueue"): "queue",
    ("asyncio", "Event"): "aevent",
    ("asyncio", "Queue"): "aqueue",
    ("asyncio", "Lock"): "alock",
    ("asyncio", "Condition"): "alock",
    ("asyncio", "get_event_loop"): "aloop",
    ("asyncio", "get_running_loop"): "aloop",
    ("asyncio", "new_event_loop"): "aloop",
    ("asyncio", "ensure_future"): "atask",
    ("asyncio", "create_task"): "atask",
    ("asyncio", "run_coroutine_threadsafe"): "cfuture",
}
# callables whose function-valued argument executes on the event loop
_LOOP_SINKS = {
    "call_soon_threadsafe", "run_coroutine_threadsafe", "call_soon",
    "call_later", "call_at", "ensure_future", "create_task",
    "run_until_complete",
}
# mutating container methods: self.x.append(...) is a mutation of self.x
MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "update", "pop", "popleft", "popitem", "remove", "discard", "clear",
    "setdefault", "sort", "reverse",
}

LOOP_ROOT = ("loop", "asyncio event loop")
MAIN_ROOT = ("main", "main path")

FuncNode = ast.AST  # FunctionDef | AsyncFunctionDef | Lambda


def _qualname(ms: ModuleScopes, node: FuncNode) -> str:
    parts: List[str] = []
    cur: Optional[ast.AST] = node
    while cur is not None and not isinstance(cur, ast.Module):
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            parts.append(cur.name)
        elif isinstance(cur, ast.Lambda):
            parts.append(f"<lambda:{cur.lineno}>")
        elif isinstance(cur, ast.ClassDef):
            parts.append(cur.name)
        cur = ms.parents.get(cur)
    return ".".join(reversed(parts)) or "<module>"


@dataclasses.dataclass
class FuncInfo:
    node: FuncNode
    ms: ModuleScopes
    name: str
    qualname: str
    class_name: Optional[str]
    is_async: bool


LockId = Tuple[str, str]     # (class-or-module scope, attr/name)
AttrKey = Tuple[str, str]    # (class name, dotted attr under self)
RootId = Tuple[str, str]     # (kind, description) — kind in
                             # {"thread", "signal", "loop", "caller"}


@dataclasses.dataclass
class Access:
    key: AttrKey
    line: int
    mutation: bool
    desc: str                     # rendered source-ish description
    locks: FrozenSet[LockId]      # lexically-held locks at the site


@dataclasses.dataclass
class Acquire:
    lock: LockId
    kind: str                     # "lock" | "rlock" | "alock"
    line: int
    style: str                    # "with" | "bare" | "guarded"
    locks_before: FrozenSet[LockId]
    safe_release: bool            # bare acquire paired with try/finally


@dataclasses.dataclass
class LoopTouch:
    desc: str
    line: int


@dataclasses.dataclass
class BlockingCall:
    desc: str
    line: int


@dataclasses.dataclass
class FuncFacts:
    """Intra-procedural facts for one function body (own statements;
    nested defs/lambdas get their own facts and are linked by edges)."""

    accesses: List[Access] = dataclasses.field(default_factory=list)
    acquires: List[Acquire] = dataclasses.field(default_factory=list)
    # (callee FuncInfo, lexically-held locks at the call site)
    calls: List[Tuple["FuncInfo", FrozenSet[LockId]]] = \
        dataclasses.field(default_factory=list)
    loop_touches: List[LoopTouch] = dataclasses.field(default_factory=list)
    blocking: List[BlockingCall] = dataclasses.field(default_factory=list)


class ThreadModel:
    """Roots, typed call graph, per-root effective locksets."""

    def __init__(self, index: ProjectIndex) -> None:
        self.index = index
        self.funcs: Dict[FuncNode, FuncInfo] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        self.class_ms: Dict[str, ModuleScopes] = {}
        self.methods: Dict[Tuple[str, str], FuncNode] = {}
        # (class, attr) -> package class name | "ext:<kind>"
        self.attr_types: Dict[Tuple[str, str], str] = {}
        # (module, global name) -> lock kind, for module-level locks
        self.global_locks: Dict[LockId, str] = {}
        self.lock_kinds: Dict[LockId, str] = {}
        # callback registries
        self.cb_by_class_attr: Dict[Tuple[str, str], Set[FuncNode]] = {}
        self.cb_by_attr: Dict[str, Set[FuncNode]] = {}
        self._pending_bindings: List[tuple] = []
        # closures enqueued into (class, queue-attr)
        self.queue_payloads: Dict[Tuple[str, str], Set[FuncNode]] = {}
        # roots
        self.roots: Dict[RootId, Set[FuncNode]] = {}
        self.signal_roots: Set[RootId] = set()
        self.thread_owning_classes: Set[str] = set()
        # results of propagation
        self.facts: Dict[FuncNode, FuncFacts] = {}
        self.func_roots: Dict[FuncNode, Set[RootId]] = {}
        # attr -> root -> list of (Access, effective lockset)
        self.attr_map: Dict[
            AttrKey, Dict[RootId, List[Tuple[Access, FrozenSet[LockId]]]]
        ] = {}
        # lock -> root -> list of (line, file, FuncInfo)
        self.lock_holders: Dict[
            LockId, Dict[RootId, List[Tuple[Acquire, "FuncInfo"]]]
        ] = {}
        # lock-order edges: (A, B) -> (Acquire, FuncInfo) witness
        self.order_edges: Dict[
            Tuple[LockId, LockId], Tuple[Acquire, "FuncInfo"]
        ] = {}
        self.loop_touch_hits: List[Tuple[LoopTouch, FuncInfo, RootId]] = []

        self._collect_defs()
        self._collect_types_and_registries()
        self._collect_roots()
        self._build_facts()
        self._propagate()

    # -- phase 1: definitions ------------------------------------------------
    def _collect_defs(self) -> None:
        for ms in self.index.scopes.values():
            for node in ast.walk(ms.sm.tree):
                if isinstance(node, ast.ClassDef):
                    self.classes[node.name] = node
                    self.class_ms[node.name] = ms
                    for child in node.body:
                        if isinstance(child, (ast.FunctionDef,
                                              ast.AsyncFunctionDef)):
                            self.methods[(node.name, child.name)] = child
            for node in ast.walk(ms.sm.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    cls = self._enclosing_class(ms, node)
                    name = node.name if not isinstance(node, ast.Lambda) \
                        else f"<lambda:{node.lineno}>"
                    self.funcs[node] = FuncInfo(
                        node=node, ms=ms, name=name,
                        qualname=f"{ms.sm.module}:{_qualname(ms, node)}",
                        class_name=cls,
                        is_async=isinstance(node, ast.AsyncFunctionDef),
                    )

    def _enclosing_class(self, ms: ModuleScopes,
                         node: ast.AST) -> Optional[str]:
        cur = ms.parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur.name
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a method's nested closure still belongs to the class
                cur = ms.parents.get(cur)
                continue
            cur = ms.parents.get(cur)
        return None

    # -- phase 2: types, locks, callback registries --------------------------
    def _ctor_kind(self, call: ast.Call) -> Optional[str]:
        """'ClassName' | 'ext:<kind>' for a constructor-ish call."""
        d = dotted_name(call.func)
        if d is None:
            return None
        parts = d.split(".")
        tailp = parts[-1]
        base = parts[-2] if len(parts) >= 2 else None
        if tailp in _LOCK_CTORS and (base in (None, "threading")):
            return f"ext:{_LOCK_CTORS[tailp]}"
        for (mod, name), kind in _EXTERNAL_CTORS.items():
            if tailp == name and (base in (None, mod)):
                return f"ext:{kind}"
        # package class: C(...) or C.from_x(...) / C.default(...)
        if tailp in self.classes:
            return tailp
        if base in self.classes:
            return base
        return None

    def _ann_type(self, ann: Optional[ast.AST]) -> Optional[str]:
        """Package class (or external kind) named inside an annotation."""
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        for node in ast.walk(ann):
            d = dotted_name(node)
            if d is None:
                continue
            parts = d.split(".")
            if parts[-1] in self.classes:
                return parts[-1]
            if len(parts) >= 2:
                kind = _EXTERNAL_CTORS.get((parts[-2], parts[-1]))
                if kind:
                    return f"ext:{kind}"
        return None

    def _func_ref(self, ms: ModuleScopes, node: ast.AST,
                  cls: Optional[str]) -> Optional[FuncNode]:
        """Resolve a function *reference* (not a call): ``self._m``,
        a bare local name, an imported name, or an inline lambda."""
        if isinstance(node, ast.Lambda):
            return node
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self" \
                and cls is not None:
            return self.methods.get((cls, node.attr))
        if isinstance(node, ast.Name):
            cands = ms.functions.get(node.id)
            if cands:
                return cands[-1]
            imp = ms.imports.get(node.id)
            if imp is not None:
                target = self.index.by_module.get(imp[0])
                if target is not None:
                    cands = target.functions.get(imp[1])
                    if cands:
                        return cands[-1]
        return None

    def _collect_types_and_registries(self) -> None:
        for ms in self.index.scopes.values():
            mod = ms.sm.module
            for node in ast.walk(ms.sm.tree):
                value: Optional[ast.AST] = None
                targets: List[ast.AST] = []
                if isinstance(node, ast.Assign):
                    value, targets = node.value, node.targets
                elif isinstance(node, ast.AnnAssign):
                    targets = [node.target]
                    value = node.value
                    # annotation-driven attr/param typing
                    t = self._ann_type(node.annotation)
                    if t is not None:
                        self._type_target(ms, node.target, t)
                if value is None:
                    continue
                vtype = self._ctor_kind(value) \
                    if isinstance(value, ast.Call) else None
                for target in targets:
                    if vtype is not None:
                        self._type_target(ms, target, vtype)
                        if vtype.startswith("ext:") and \
                                vtype[4:] in ("lock", "rlock"):
                            self._register_lock(ms, mod, target, vtype[4:])
                    # callback registry: X.attr = <func ref>
                    if isinstance(target, ast.Attribute):
                        cls = self._enclosing_class(ms, node)
                        ref = self._func_ref(ms, value, cls)
                        if ref is not None:
                            self.cb_by_attr.setdefault(
                                target.attr, set()).add(ref)
            # param-annotation typing + self.attr = param bindings
            self._collect_param_bindings(ms)
        # call-site registries run AFTER every module's types are known:
        # the typed-receiver guard in _bind_callsite_args and the
        # queue-attr check both read attr_types across modules
        self._index_call_sites()
        for cls, mname, fn, params, param_attr in self._pending_bindings:
            self._bind_callsite_args(cls, mname, fn, params, param_attr)
        for ms in self.index.scopes.values():
            # X.attr.append(ref) and queue.put(ref) registries
            self._collect_call_registries(ms)

    def _type_target(self, ms: ModuleScopes, target: ast.AST,
                     vtype: str) -> None:
        if isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self":
            cls = self._enclosing_class(ms, target)
            if cls is not None:
                self.attr_types.setdefault((cls, target.attr), vtype)

    def _register_lock(self, ms: ModuleScopes, mod: str, target: ast.AST,
                       kind: str) -> None:
        if isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self":
            cls = self._enclosing_class(ms, target)
            if cls is not None:
                self.lock_kinds[(cls, target.attr)] = kind
        elif isinstance(target, ast.Name):
            cls = self._enclosing_class(ms, target)
            if cls is None:
                self.global_locks[(mod, target.id)] = kind
                self.lock_kinds[(mod, target.id)] = kind

    def _collect_param_bindings(self, ms: ModuleScopes) -> None:
        """Two jobs per method: params annotated with package classes
        become local types, and ``self.attr = param`` makes *call-site
        arguments* for that param feed the (class, attr) callback
        registry — the ``snapshotter.install(self._live_snapshot)`` /
        ``HangWatchdog(crash_report=...)`` wiring."""
        for (cls, mname), fn in list(self.methods.items()):
            if self.class_ms.get(cls) is not ms:
                continue
            assert isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            params = [a.arg for a in fn.args.args]
            all_params = fn.args.args + fn.args.kwonlyargs
            all_names = {a.arg for a in all_params}
            param_attr: Dict[str, str] = {}
            for stmt in ast.walk(fn):
                if isinstance(stmt, ast.Assign) and \
                        isinstance(stmt.value, ast.Name) and \
                        stmt.value.id in all_names:
                    for t in stmt.targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self":
                            param_attr[stmt.value.id] = t.attr
                            # param annotation types the attr too
                            for a in all_params:
                                if a.arg == stmt.value.id:
                                    at = self._ann_type(a.annotation)
                                    if at is not None:
                                        self.attr_types.setdefault(
                                            (cls, t.attr), at)
            if not param_attr:
                continue
            self._pending_bindings.append(
                (cls, mname, fn, params, param_attr))

    def _index_call_sites(self) -> None:
        """One walk over every tree, bucketing calls by attribute name
        and by constructor tail. ``_bind_callsite_args`` used to rescan
        every module per pending binding — the dominant cost of the
        whole analyzer on this repo; the buckets make each binding a
        dictionary lookup over only the calls that can match."""
        self._calls_by_attr: Dict[str, List[tuple]] = {}
        self._calls_by_ctor: Dict[str, List[tuple]] = {}
        for ms2 in self.index.scopes.values():
            for call in ast.walk(ms2.sm.tree):
                if not isinstance(call, ast.Call):
                    continue
                if isinstance(call.func, ast.Attribute):
                    self._calls_by_attr.setdefault(
                        call.func.attr, []).append((ms2, call))
                d = dotted_name(call.func)
                if d is not None:
                    self._calls_by_ctor.setdefault(
                        d.split(".")[-1], []).append((ms2, call))

    def _bind_callsite_args(self, cls: str, mname: str, fn: ast.AST,
                            params: List[str],
                            param_attr: Dict[str, str]) -> None:
        """Find calls of ``cls.mname`` (typed ``recv.m(...)`` or the
        constructor ``C(...)``) and record function-valued args."""
        if mname == "__init__":
            sites = self._calls_by_ctor.get(cls, ())
        else:
            sites = self._calls_by_attr.get(mname, ())
        for ms2, call in sites:
            caller_cls = None
            if mname != "__init__":
                # attribute call of this method name. When the
                # receiver's class is statically known it must BE
                # `cls` — binding a callback into a same-named
                # method of a different class fabricates roots and
                # false races. Unknown receivers stay bound (the
                # over-approximation recall needs), bounded by the
                # param-name match.
                caller_cls = self._enclosing_class(ms2, call)
                rtype = self._recv_type(call.func.value, caller_cls, {})
                if rtype is not None and rtype != cls:
                    continue
            if caller_cls is None:
                caller_cls = self._enclosing_class(ms2, call)
            offset = 1  # skip self
            for i, arg in enumerate(call.args):
                idx = i + offset
                if idx < len(params) and params[idx] in param_attr:
                    ref = self._func_ref(ms2, arg, caller_cls)
                    if ref is not None:
                        self.cb_by_class_attr.setdefault(
                            (cls, param_attr[params[idx]]), set()
                        ).add(ref)
            for kw in call.keywords:
                if kw.arg in param_attr:
                    ref = self._func_ref(ms2, kw.value, caller_cls)
                    if ref is not None:
                        self.cb_by_class_attr.setdefault(
                            (cls, param_attr[kw.arg]), set()
                        ).add(ref)

    def _collect_call_registries(self, ms: ModuleScopes) -> None:
        for call in ast.walk(ms.sm.tree):
            if not isinstance(call, ast.Call) or \
                    not isinstance(call.func, ast.Attribute):
                continue
            attr = call.func.attr
            cls = self._enclosing_class(ms, call)
            if attr in ("append", "add") and call.args and \
                    isinstance(call.func.value, ast.Attribute):
                ref = self._func_ref(ms, call.args[0], cls)
                if ref is not None:
                    self.cb_by_attr.setdefault(
                        call.func.value.attr, set()).add(ref)
            if attr in ("put", "put_nowait") and call.args:
                recv = call.func.value
                if isinstance(recv, ast.Attribute) and \
                        isinstance(recv.value, ast.Name) and \
                        recv.value.id == "self" and cls is not None and \
                        self.attr_types.get((cls, recv.attr)) == "ext:queue":
                    ref = self._func_ref(ms, call.args[0], cls)
                    if ref is not None:
                        self.queue_payloads.setdefault(
                            (cls, recv.attr), set()).add(ref)

    # -- phase 3: roots ------------------------------------------------------
    def _collect_roots(self) -> None:
        for ms in self.index.scopes.values():
            for call in ast.walk(ms.sm.tree):
                if not isinstance(call, ast.Call):
                    continue
                d = dotted_name(call.func) or ""
                t = tail_name(call.func)
                cls = self._enclosing_class(ms, call)
                if t == "Thread" and (d in ("Thread", "threading.Thread")):
                    target = None
                    for kw in call.keywords:
                        if kw.arg == "target":
                            target = self._func_ref(ms, kw.value, cls)
                    if target is not None and target in self.funcs:
                        fi = self.funcs[target]
                        rid = ("thread", fi.qualname)
                        self.roots.setdefault(rid, set()).add(target)
                        if cls is not None:
                            self.thread_owning_classes.add(cls)
                        elif fi.class_name is not None:
                            self.thread_owning_classes.add(fi.class_name)
                elif (d in ("signal.signal",)
                      or t == "add_signal_handler") and len(call.args) >= 2:
                    handler = self._func_ref(ms, call.args[1], cls)
                    if handler is not None and handler in self.funcs:
                        fi = self.funcs[handler]
                        rid = ("signal", fi.qualname)
                        self.roots.setdefault(rid, set()).add(handler)
                        self.signal_roots.add(rid)
                elif t in _LOOP_SINKS:
                    for arg in call.args[:1]:
                        ref = self._func_ref(ms, arg, cls)
                        if ref is not None and ref in self.funcs:
                            self.roots.setdefault(LOOP_ROOT, set()).add(ref)
        # every async def executes on the loop
        for node, fi in self.funcs.items():
            if fi.is_async:
                self.roots.setdefault(LOOP_ROOT, set()).add(node)
        # caller root: public sync methods of thread-owning classes
        for cls in self.thread_owning_classes:
            rid = ("caller", cls)
            cnode = self.classes.get(cls)
            if cnode is None:
                continue
            for child in cnode.body:
                if isinstance(child, ast.FunctionDef) and \
                        not child.name.startswith("_"):
                    self.roots.setdefault(rid, set()).add(child)

    # -- phase 4: intra-procedural facts -------------------------------------
    def _lock_id(self, ms: ModuleScopes, expr: ast.AST,
                 cls: Optional[str]) -> Optional[Tuple[LockId, str]]:
        """(lock id, kind) when ``expr`` names a known lock object."""
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                and cls is not None:
            lid = (cls, expr.attr)
            kind = self.lock_kinds.get(lid)
            return (lid, kind) if kind else None
        if isinstance(expr, ast.Name):
            lid = (ms.sm.module, expr.id)
            kind = self.global_locks.get(lid)
            return (lid, kind) if kind else None
        return None

    def _chain_key(self, expr: ast.AST, cls: Optional[str],
                   local_types: Dict[str, str]) -> Optional[AttrKey]:
        """Attr key for a ``self.a[.b]`` / ``typedlocal.b`` chain."""
        if not isinstance(expr, ast.Attribute):
            return None
        base = expr.value
        if isinstance(base, ast.Name):
            if base.id == "self" and cls is not None:
                return (cls, expr.attr)
            btype = local_types.get(base.id)
            if btype and not btype.startswith("ext:"):
                return (btype, expr.attr)
            return None
        if isinstance(base, ast.Attribute) and \
                isinstance(base.value, ast.Name):
            if base.value.id == "self" and cls is not None:
                btype = self.attr_types.get((cls, base.attr))
                if btype and not btype.startswith("ext:"):
                    return (btype, expr.attr)
                return (cls, f"{base.attr}.{expr.attr}")
        return None

    def _recv_type(self, expr: ast.AST, cls: Optional[str],
                   local_types: Dict[str, str]) -> Optional[str]:
        """Static type of a receiver expression, when known."""
        if isinstance(expr, ast.Name):
            if expr.id == "self":
                return cls
            return local_types.get(expr.id)
        if isinstance(expr, ast.Attribute):
            btype = self._recv_type(expr.value, cls, local_types)
            if btype and not btype.startswith("ext:"):
                return self.attr_types.get((btype, expr.attr))
        if isinstance(expr, ast.Call):
            return self._ctor_kind(expr)
        return None

    def _build_facts(self) -> None:
        for node, fi in self.funcs.items():
            self.facts[node] = self._analyze_func(fi)

    def _analyze_func(self, fi: FuncInfo) -> FuncFacts:
        facts = FuncFacts()
        node = fi.node
        if isinstance(node, ast.Lambda):
            body: List[ast.stmt] = []
            self._scan_expr(fi, node.body, frozenset(), {}, facts)
            return facts
        body = node.body  # type: ignore[union-attr]
        local_types: Dict[str, str] = {}
        # params annotated with package classes become typed locals
        for a in (node.args.args + node.args.kwonlyargs):
            t = self._ann_type(a.annotation)
            if t is not None:
                local_types[a.arg] = t
        # callable candidates for locals bound from queues / registries
        local_callables: Dict[str, Set[FuncNode]] = {}
        self._scan_block(fi, body, frozenset(), local_types,
                         local_callables, facts)
        return facts

    def _scan_block(self, fi: FuncInfo, body: Sequence[ast.stmt],
                    locks: FrozenSet[LockId], local_types: Dict[str, str],
                    local_callables: Dict[str, Set[FuncNode]],
                    facts: FuncFacts) -> None:
        for i, stmt in enumerate(body):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested defs analyzed separately
            if isinstance(stmt, ast.Assign):
                self._observe_assign(fi, stmt, locks, local_types,
                                     local_callables, facts)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                t = self._ann_type(stmt.annotation)
                if t is not None and isinstance(stmt.target, ast.Name):
                    local_types[stmt.target.id] = t
                self._scan_expr(fi, stmt.value, locks, local_types, facts,
                                local_callables)
            elif isinstance(stmt, ast.AugAssign):
                # `self.x += 1` mutates self.x; `self.x[k] += 1` is a
                # read-modify-write of the container self.x
                target = stmt.target
                if isinstance(target, ast.Subscript):
                    target = target.value
                key = self._chain_key(target, fi.class_name, local_types)
                if key is not None:
                    facts.accesses.append(Access(
                        key=key, line=stmt.lineno, mutation=True,
                        desc=self._render(stmt.target), locks=locks))
                self._scan_expr(fi, stmt.value, locks, local_types, facts,
                                local_callables)
            elif isinstance(stmt, ast.Delete):
                for t in stmt.targets:
                    if isinstance(t, ast.Subscript):
                        key = self._chain_key(t.value, fi.class_name,
                                              local_types)
                        if key is not None:
                            facts.accesses.append(Access(
                                key=key, line=stmt.lineno, mutation=True,
                                desc=self._render(t.value), locks=locks))
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = set(locks)
                for item in stmt.items:
                    lk = self._lock_id(fi.ms, item.context_expr,
                                       fi.class_name)
                    if lk is not None:
                        lid, kind = lk
                        acq = Acquire(
                            lock=lid, kind=kind,
                            line=item.context_expr.lineno, style="with",
                            locks_before=frozenset(inner),
                            safe_release=True)
                        facts.acquires.append(acq)
                        inner.add(lid)
                        if fi.is_async:
                            # a threading lock (never asyncio.Lock —
                            # those aren't in lock_kinds) blocks the
                            # whole loop while contended
                            facts.blocking.append(BlockingCall(
                                desc=f"with {self._render(item.context_expr)}"
                                     f": (threading lock)",
                                line=item.context_expr.lineno))
                    else:
                        self._scan_expr(fi, item.context_expr, locks,
                                        local_types, facts, local_callables)
                self._scan_block(fi, stmt.body, frozenset(inner),
                                 local_types, local_callables, facts)
            elif isinstance(stmt, ast.If):
                self._scan_expr(fi, stmt.test, locks, local_types, facts,
                                local_callables)
                self._scan_block(fi, stmt.body, locks, local_types,
                                 local_callables, facts)
                self._scan_block(fi, stmt.orelse, locks, local_types,
                                 local_callables, facts)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._observe_for(fi, stmt, locks, local_types,
                                  local_callables, facts)
                self._scan_block(fi, stmt.body, locks, local_types,
                                 local_callables, facts)
                self._scan_block(fi, stmt.orelse, locks, local_types,
                                 local_callables, facts)
            elif isinstance(stmt, ast.While):
                self._scan_expr(fi, stmt.test, locks, local_types, facts,
                                local_callables)
                self._scan_block(fi, stmt.body, locks, local_types,
                                 local_callables, facts)
                self._scan_block(fi, stmt.orelse, locks, local_types,
                                 local_callables, facts)
            elif isinstance(stmt, ast.Try):
                self._scan_block(fi, stmt.body, locks, local_types,
                                 local_callables, facts)
                for handler in stmt.handlers:
                    self._scan_block(fi, handler.body, locks, local_types,
                                     local_callables, facts)
                self._scan_block(fi, stmt.orelse, locks, local_types,
                                 local_callables, facts)
                self._scan_block(fi, stmt.finalbody, locks, local_types,
                                 local_callables, facts)
            elif isinstance(stmt, ast.Expr):
                acquired = self._observe_expr_stmt(
                    fi, stmt, i, body, locks, local_types,
                    local_callables, facts)
                if acquired is not None:
                    # a bare acquire() holds the lock for the rest of
                    # this block (released in the paired finally or
                    # leaked — either way the critical section below IS
                    # protected, and ST901 must not call it unlocked)
                    locks = locks | {acquired}
            elif isinstance(stmt, ast.Return) and stmt.value is not None:
                self._scan_expr(fi, stmt.value, locks, local_types, facts,
                                local_callables)
            elif isinstance(stmt, (ast.Assert, ast.Raise)):
                for child in ast.iter_child_nodes(stmt):
                    self._scan_expr(fi, child, locks, local_types, facts,
                                    local_callables)

    def _observe_assign(self, fi: FuncInfo, stmt: ast.Assign,
                        locks: FrozenSet[LockId],
                        local_types: Dict[str, str],
                        local_callables: Dict[str, Set[FuncNode]],
                        facts: FuncFacts) -> None:
        # subscript store: self.x[k] = v  -> mutation of self.x
        for t in stmt.targets:
            if isinstance(t, ast.Subscript):
                key = self._chain_key(t.value, fi.class_name, local_types)
                if key is not None:
                    facts.accesses.append(Access(
                        key=key, line=stmt.lineno, mutation=True,
                        desc=self._render(t.value), locks=locks))
            elif isinstance(t, ast.Attribute):
                # read-modify-write: self.x = self.x + 1
                key = self._chain_key(t, fi.class_name, local_types)
                if key is not None and self._reads_key(
                        stmt.value, key, fi.class_name, local_types):
                    facts.accesses.append(Access(
                        key=key, line=stmt.lineno, mutation=True,
                        desc=self._render(t), locks=locks))
        # local typing
        if isinstance(stmt.value, ast.Call):
            # x = C(...) / x = threading.Event() here; x = self.engine
            # (attr-type copy) below
            vtype = self._ctor_kind(stmt.value)
            if vtype is not None:
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        local_types[t.id] = vtype
            # fn = self.<queue>.get() -> queued-closure candidates
            if isinstance(stmt.value.func, ast.Attribute) and \
                    stmt.value.func.attr in ("get", "get_nowait"):
                recv = stmt.value.func.value
                if isinstance(recv, ast.Attribute) and \
                        isinstance(recv.value, ast.Name) and \
                        recv.value.id == "self" and fi.class_name:
                    qkey = (fi.class_name, recv.attr)
                    if qkey in self.queue_payloads:
                        for t in stmt.targets:
                            if isinstance(t, ast.Name):
                                local_callables[t.id] = \
                                    self.queue_payloads[qkey]
        elif isinstance(stmt.value, (ast.Name, ast.Attribute)):
            vtype = self._recv_type(stmt.value, fi.class_name, local_types)
            if vtype is not None:
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        local_types[t.id] = vtype
        self._scan_expr(fi, stmt.value, locks, local_types, facts,
                        local_callables)

    def _observe_for(self, fi: FuncInfo, stmt, locks, local_types,
                     local_callables, facts) -> None:
        # for cb in self.<registry-attr>: cb() -> callback candidates
        it = stmt.iter
        if isinstance(it, ast.Attribute) and it.attr in self.cb_by_attr and \
                isinstance(stmt.target, ast.Name):
            local_callables[stmt.target.id] = self.cb_by_attr[it.attr]
        self._scan_expr(fi, it, locks, local_types, facts, local_callables)

    def _observe_expr_stmt(self, fi: FuncInfo, stmt: ast.Expr, i: int,
                           body: Sequence[ast.stmt],
                           locks: FrozenSet[LockId],
                           local_types: Dict[str, str],
                           local_callables: Dict[str, Set[FuncNode]],
                           facts: FuncFacts) -> Optional[LockId]:
        """Returns the lock id when the statement is a bare
        ``lock.acquire()`` — the caller extends the held set for the
        rest of the block."""
        call = stmt.value
        if isinstance(call, ast.Call) and \
                isinstance(call.func, ast.Attribute) and \
                call.func.attr == "acquire":
            lk = self._lock_id(fi.ms, call.func.value, fi.class_name)
            if lk is not None:
                lid, kind = lk
                safe = self._release_in_following_finally(
                    body, i, call.func.value)
                facts.acquires.append(Acquire(
                    lock=lid, kind=kind, line=stmt.lineno, style="bare",
                    locks_before=locks, safe_release=safe))
                if fi.is_async:
                    facts.blocking.append(BlockingCall(
                        desc=f"{self._render(call.func.value)}.acquire() "
                             f"(threading lock)", line=stmt.lineno))
                return lid
        self._scan_expr(fi, call, locks, local_types, facts, local_callables)
        return None

    def _release_in_following_finally(self, body: Sequence[ast.stmt],
                                      i: int, recv: ast.AST) -> bool:
        """``x.acquire()`` directly followed by ``try: ... finally:
        x.release()`` is the safe bare-acquire idiom."""
        want = self._render(recv)
        if i + 1 < len(body) and isinstance(body[i + 1], ast.Try):
            for s in body[i + 1].finalbody:  # type: ignore[union-attr]
                for node in ast.walk(s):
                    if isinstance(node, ast.Call) and \
                            isinstance(node.func, ast.Attribute) and \
                            node.func.attr == "release" and \
                            self._render(node.func.value) == want:
                        return True
        return False

    def _reads_key(self, expr: ast.AST, key: AttrKey,
                   cls: Optional[str], local_types: Dict[str, str]) -> bool:
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute) and \
                    self._chain_key(node, cls, local_types) == key:
                return True
        return False

    def _render(self, node: ast.AST) -> str:
        try:
            return ast.unparse(node)
        except Exception:  # pragma: no cover
            return "<expr>"

    # -- expression scan: calls, mutator methods, loop touches ---------------
    def _scan_expr(self, fi: FuncInfo, expr: ast.AST,
                   locks: FrozenSet[LockId], local_types: Dict[str, str],
                   facts: FuncFacts,
                   local_callables: Optional[Dict[str, Set[FuncNode]]] = None,
                   ) -> None:
        local_callables = local_callables or {}
        for node in self._walk_own(expr):
            if not isinstance(node, ast.Call):
                continue
            self._observe_call(fi, node, locks, local_types,
                               local_callables, facts)

    def _walk_own(self, root: ast.AST):
        """Walk an expression without descending into nested lambdas
        (their bodies are separate functions)."""
        stack = [root]
        while stack:
            node = stack.pop()
            if node is not root and isinstance(
                    node, (ast.Lambda, ast.FunctionDef,
                           ast.AsyncFunctionDef)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _observe_call(self, fi: FuncInfo, call: ast.Call,
                      locks: FrozenSet[LockId],
                      local_types: Dict[str, str],
                      local_callables: Dict[str, Set[FuncNode]],
                      facts: FuncFacts) -> None:
        func = call.func
        # direct call of a local/imported function or closure candidate
        if isinstance(func, ast.Name):
            if func.id in local_callables:
                for cand in local_callables[func.id]:
                    if cand in self.funcs:
                        facts.calls.append((self.funcs[cand], locks))
                return
            ref = self._func_ref(fi.ms, func, fi.class_name)
            if ref is not None and ref in self.funcs:
                facts.calls.append((self.funcs[ref], locks))
            return
        if not isinstance(func, ast.Attribute):
            return
        attr = func.attr
        recv = func.value
        # mutator method on a tracked attr chain: self.x.append(...)
        if attr in MUTATORS:
            key = self._chain_key(recv, fi.class_name, local_types)
            if key is not None:
                facts.accesses.append(Access(
                    key=key, line=call.lineno, mutation=True,
                    desc=f"{self._render(recv)}.{attr}(...)", locks=locks))
        rtype = self._recv_type(recv, fi.class_name, local_types)
        # asyncio loop-state touches (judged per-root later)
        if rtype in ("ext:aevent", "ext:aqueue", "ext:atask", "ext:aloop"):
            flagged = {
                "ext:aevent": {"set", "clear"},
                "ext:aqueue": {"put_nowait", "get_nowait"},
                "ext:atask": {"cancel"},
                "ext:aloop": {"call_soon", "call_later", "call_at",
                              "create_task", "stop"},
            }[rtype]
            if attr in flagged:
                facts.loop_touches.append(LoopTouch(
                    desc=f"{self._render(recv)}.{attr}(...)",
                    line=call.lineno))
        # blocking calls inside coroutine bodies (ST903)
        if fi.is_async:
            self._observe_blocking(fi, call, rtype, facts)
        # typed method resolution
        if rtype is not None and not rtype.startswith("ext:"):
            method = self.methods.get((rtype, attr))
            if method is not None:
                facts.calls.append((self.funcs[method], locks))
                return
            # stored-callback attr on a typed receiver
            for cand in self.cb_by_class_attr.get((rtype, attr), ()):
                if cand in self.funcs:
                    facts.calls.append((self.funcs[cand], locks))
            if (rtype, attr) in self.cb_by_class_attr:
                return
        # callback registry by bare attr name (engine.on_tokens(...))
        if rtype is None and attr in self.cb_by_attr:
            for cand in self.cb_by_attr[attr]:
                if cand in self.funcs:
                    facts.calls.append((self.funcs[cand], locks))

    _BLOCKING_DOTTED = {
        "time.sleep", "os.system", "os.wait", "os.waitpid",
        "subprocess.run", "subprocess.call", "subprocess.check_call",
        "subprocess.check_output", "subprocess.Popen",
        "urllib.request.urlopen", "requests.get", "requests.post",
        "socket.create_connection",
    }

    def _observe_blocking(self, fi: FuncInfo, call: ast.Call,
                          rtype: Optional[str], facts: FuncFacts) -> None:
        d = dotted_name(call.func) or ""
        attr = call.func.attr if isinstance(call.func, ast.Attribute) else d
        if d in self._BLOCKING_DOTTED:
            facts.blocking.append(BlockingCall(desc=f"{d}(...)",
                                               line=call.lineno))
            return
        if rtype == "ext:queue" and attr in ("get", "put", "join"):
            facts.blocking.append(BlockingCall(
                desc=f"{self._render(call.func.value)}.{attr}(...) "
                     f"(blocking queue op)", line=call.lineno))
        elif rtype == "ext:tevent" and attr == "wait":
            facts.blocking.append(BlockingCall(
                desc=f"{self._render(call.func.value)}.wait(...) "
                     f"(threading.Event)", line=call.lineno))
        elif rtype == "ext:thread" and attr == "join":
            facts.blocking.append(BlockingCall(
                desc=f"{self._render(call.func.value)}.join(...)",
                line=call.lineno))
        elif rtype in ("ext:lock", "ext:rlock") and attr == "acquire":
            facts.blocking.append(BlockingCall(
                desc=f"{self._render(call.func.value)}.acquire() "
                     f"(threading lock)", line=call.lineno))
        elif rtype == "ext:cfuture" and attr == "result":
            facts.blocking.append(BlockingCall(
                desc=f"{self._render(call.func.value)}.result(...)",
                line=call.lineno))

    # -- phase 5: propagation -------------------------------------------------
    def _propagate(self) -> None:
        seen: Set[Tuple[FuncNode, RootId, FrozenSet[LockId]]] = set()
        work: List[Tuple[FuncNode, RootId, FrozenSet[LockId]]] = []
        for rid, seeds in self.roots.items():
            for fn in seeds:
                work.append((fn, rid, frozenset()))
        self._run_worklist(work, seen)
        # implicit main path: every function no explicit root reaches is
        # callable from the interpreter's main thread. Seeded AFTER the
        # explicit phase so signal-handler-only code (reachable solely
        # from its registration) is NOT blanket-attributed to main —
        # that distinction is exactly what ST904 measures.
        work = [
            (fn, MAIN_ROOT, frozenset()) for fn in self.facts
            if fn not in self.func_roots and not self.funcs[fn].is_async
        ]
        self._run_worklist(work, seen)

    def _run_worklist(
        self,
        work: List[Tuple[FuncNode, RootId, FrozenSet[LockId]]],
        seen: Set[Tuple[FuncNode, RootId, FrozenSet[LockId]]],
    ) -> None:
        while work:
            fn, rid, entry = work.pop()
            state = (fn, rid, entry)
            if state in seen or fn not in self.facts:
                continue
            seen.add(state)
            self.func_roots.setdefault(fn, set()).add(rid)
            fi = self.funcs[fn]
            facts = self.facts[fn]
            for acc in facts.accesses:
                eff = entry | acc.locks
                self.attr_map.setdefault(acc.key, {}).setdefault(
                    rid, []).append((acc, eff))
            for acq in facts.acquires:
                held = entry | acq.locks_before
                self.lock_holders.setdefault(acq.lock, {}).setdefault(
                    rid, []).append((acq, fi))
                for h in held:
                    if h != acq.lock:
                        self.order_edges.setdefault((h, acq.lock), (acq, fi))
            for touch in facts.loop_touches:
                self.loop_touch_hits.append((touch, fi, rid))
            for callee_fi, call_locks in facts.calls:
                if callee_fi.is_async and rid != LOOP_ROOT:
                    continue  # coroutine body executes on the loop
                work.append((callee_fi.node, rid, entry | call_locks))

    # -- queries --------------------------------------------------------------
    def describe_root(self, rid: RootId) -> str:
        kind, what = rid
        if kind == "thread":
            return f"thread root `{what}`"
        if kind == "signal":
            return f"signal handler `{what}`"
        if kind == "loop":
            return "the asyncio event loop"
        if kind == "main":
            return "the main path"
        return f"cross-thread callers of `{what}` (thread-owning class)"

    def lock_name(self, lid: LockId) -> str:
        return f"{lid[0]}.{lid[1]}"
