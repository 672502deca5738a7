"""Ownership tier (ST11xx): static resource-conservation and
lifecycle analysis for the serving host path.

The serving invariants — every page exactly one live owner, every
request exactly one terminal outcome, every span a balanced begin/end —
are enforced at runtime by ``check_conservation`` and the fault-drill
suites. This tier makes them *static*: a declarative ``CONTRACT`` table
of acquire/release/transfer APIs checked along every path (branches,
exception edges into in-function handlers, early returns) by the
shared walker in ``cfg.py``, on top of ``threads.py``'s typed-only
resolution so precision beats recall.

======  =====================================================
ST1101  acquired resource leaks on some path (not released,
        stored, returned, or transferred to a sink)
ST1102  double-release along one path
ST1103  terminal-outcome write outside the designated funnel
ST1104  unbalanced request spans (begin without end/instant)
ST1105  rollback-path asymmetry (source released before the
        destination in a transfer handler)
======  =====================================================

Known limits (docs/static_analysis.md): raise/uncaught-exception exits
are exempt, acquires not bound to a plain local are untracked, owning
containers are discovered globally by attribute name, and span balance
is judged across the whole analyzed set.
"""

from __future__ import annotations

import ast
import itertools
from typing import Dict, List, Optional, Set, Tuple

from .cfg import FunctionWalk, call_tail
from .core import Finding
from .scopes import ProjectIndex, dotted_name
from .threads import ThreadModel

# ---------------------------------------------------------------------------
# the contract table (docs/static_analysis.md renders this verbatim)
# ---------------------------------------------------------------------------

CONTRACT = {
    # refcounted page pools: alloc/allocate acquire (may return None —
    # the all-or-nothing contract), retain acquires one ref per page
    # argument, release discharges one ref.
    "allocators": {
        "classes": ("PageAllocator",),
        "acquire": ("alloc", "allocate"),
        "acquire_ref": ("retain",),
        "release": ("release",),
    },
    # OS handles: acquire by exact dotted callee (``os.open``/``urlopen``
    # etc. deliberately absent), discharged by ``with`` or ``.close()``.
    "handles": {
        "acquire": {
            "open": "file",
            "io.open": "file",
            "socket.socket": "socket",
            "socket.create_connection": "socket",
        },
        "release": ("close",),
    },
    # threads stored on self must be joined by *some* method of the
    # owning class (the drain path); locals are path-checked unless the
    # constructor says daemon=True (declared fire-and-forget).
    "threads": {"acquire": "start", "release": "join"},
    # terminal-outcome funnels: every call of the key must be lexically
    # inside the named function (exactly-one-terminal, ST1103).
    "funnels": {
        "record_outcome": "_finalize",
        "record_response": "_record_outcome",
    },
    # terminal stores: ``self.<attr>[...] = ...`` only inside the funnel
    "outcome_stores": {"_results": "_finalize"},
    # request spans: async_event(ph, name, ...) with ph in b/e/n; every
    # "b" name needs an "e" or "n" somewhere in the analyzed set
    "spans": {"event": "async_event"},
}

_KIND_NOUN = {
    "pages": "page ownership",
    "file": "a file handle",
    "socket": "a socket",
    "thread": "a running thread",
}
_KIND_VERB = {
    "pages": "releases",
    "file": "closes",
    "socket": "closes",
    "thread": "joins",
}


def _root_name(expr: ast.AST) -> Optional[str]:
    """Leftmost Name of a chain: ``h.pages[i]`` -> ``h``."""
    while isinstance(expr, (ast.Attribute, ast.Subscript)):
        expr = expr.value
    return expr.id if isinstance(expr, ast.Name) else None


def _is_daemon_ctor(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return True
    return False


def _has_return_none(fn: ast.AST) -> bool:
    """An own-body ``return``/``return None`` (nested defs excluded)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Return) and (
            node.value is None
            or (isinstance(node.value, ast.Constant)
                and node.value.value is None)
        ):
            return True
        stack.extend(ast.iter_child_nodes(node))
    return False


class _OwnershipModel:
    """MRO-aware view over ``ThreadModel``'s typed world, plus the
    per-function walks and the cross-function registries the five
    checks read."""

    def __init__(self, model: ThreadModel) -> None:
        self.model = model
        self._mro_cache: Dict[str, List[str]] = {}
        self._lt_cache: Dict[ast.AST, Dict[str, str]] = {}
        self._walks: List[Tuple[object, FunctionWalk]] = []
        self._own_attrs: Set[str] = set()
        self._oids = itertools.count(1)

    # -- typing ------------------------------------------------------------
    def mro(self, cls: str) -> List[str]:
        got = self._mro_cache.get(cls)
        if got is not None:
            return got
        out: List[str] = []
        seen: Set[str] = set()
        stack = [cls]
        while stack:
            c = stack.pop(0)
            if c in seen or c not in self.model.classes:
                continue
            seen.add(c)
            out.append(c)
            for b in self.model.classes[c].bases:
                d = dotted_name(b)
                if d is not None:
                    stack.append(d.split(".")[-1])
        self._mro_cache[cls] = out
        return out

    def attr_type(self, cls: Optional[str], attr: str) -> Optional[str]:
        if cls is None:
            return None
        for c in self.mro(cls):
            t = self.model.attr_types.get((c, attr))
            if t is not None:
                return t
        return None

    def resolve_method(self, cls: str, name: str) -> Optional[ast.AST]:
        for c in self.mro(cls):
            fn = self.model.methods.get((c, name))
            if fn is not None:
                return fn
        return None

    def _recv_type(self, expr: ast.AST, cls: Optional[str],
                   local_types: Dict[str, str]) -> Optional[str]:
        if isinstance(expr, ast.Name):
            if expr.id == "self":
                return cls
            return local_types.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = self._recv_type(expr.value, cls, local_types)
            if base is not None and not base.startswith("ext:"):
                return self.attr_type(base, expr.attr)
            return None
        if isinstance(expr, ast.Call):
            return self.model._ctor_kind(expr)
        return None

    def local_types(self, fn: ast.AST) -> Dict[str, str]:
        got = self._lt_cache.get(fn)
        if got is not None:
            return got
        fi = self.model.funcs.get(fn)
        cls = fi.class_name if fi is not None else None
        out: Dict[str, str] = {}
        args = fn.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            t = self.model._ann_type(a.annotation)
            if t is not None:
                out.setdefault(a.arg, t)
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                v = node.value
                name = node.targets[0].id
                if isinstance(v, ast.Call):
                    k = self.model._ctor_kind(v)
                    if k == "ext:thread" and _is_daemon_ctor(v):
                        continue  # declared fire-and-forget
                    if k is not None:
                        out.setdefault(name, k)
                elif isinstance(v, ast.Attribute) and \
                        isinstance(v.value, ast.Name) and \
                        v.value.id == "self":
                    t = self.attr_type(cls, v.attr)
                    if t is not None:
                        out.setdefault(name, t)
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                t = self.model._ann_type(node.annotation)
                if t is not None:
                    out.setdefault(node.target.id, t)
        self._lt_cache[fn] = out
        return out

    # -- the call classifier (CONTRACT -> cfg.Classifier) -------------------
    def classifier(self, fi, owned: Dict[ast.AST, bool]):
        cls = fi.class_name
        lts = self.local_types(fi.node)
        alloc = CONTRACT["allocators"]
        handles = CONTRACT["handles"]

        def classify(call: ast.Call) -> Optional[tuple]:
            d = dotted_name(call.func)
            hk = handles["acquire"].get(d) if d is not None else None
            if hk is not None:
                return ("acquire", hk, False)
            if not isinstance(call.func, ast.Attribute):
                return None
            tail = call.func.attr
            rtype = self._recv_type(call.func.value, cls, lts)
            if rtype in alloc["classes"]:
                if tail in alloc["acquire"]:
                    return ("acquire", "pages", True)
                if tail in alloc["acquire_ref"]:
                    return ("acquire_arg", "pages")
                if tail in alloc["release"]:
                    op = call.args[0] if call.args else None
                    return ("release", "pages", op)
            if rtype == "ext:thread":
                if tail == CONTRACT["threads"]["acquire"]:
                    return ("acquire_recv", "thread")
                if tail == CONTRACT["threads"]["release"]:
                    return ("release_recv", ("thread",))
            if tail in handles["release"]:
                return ("release_recv", ("file", "socket"))
            # a call of a method whose return value carries page
            # ownership (round-1 discovery) is itself an acquire
            if rtype is not None and not rtype.startswith("ext:"):
                m = self.resolve_method(rtype, tail)
                if m is not None and m in owned:
                    return ("acquire", "pages", owned[m])
            return None

        return classify

    # -- walks + ST1101/ST1102 ---------------------------------------------
    def check_lifecycles(self) -> List[Finding]:
        todo = [fi for fi in self.model.funcs.values()
                if not isinstance(fi.node, ast.Lambda)]
        # round 1..n: fixpoint the owned-returning method set, so
        # `reserved = self._reserve_pages(req)` is an acquire in round 2
        owned: Dict[ast.AST, bool] = {}
        for _ in range(4):
            changed = False
            for fi in todo:
                if fi.node in owned:
                    continue
                w = FunctionWalk(fi.node, self.classifier(fi, owned)).run()
                if w.returns_owned:
                    owned[fi.node] = _has_return_none(fi.node)
                    changed = True
            if not changed:
                break
        out: List[Finding] = []
        for fi in todo:
            w = FunctionWalk(fi.node, self.classifier(fi, owned),
                             oid_counter=self._oids).run()
            self._walks.append((fi, w))
            for s in w.own_stores:
                self._own_attrs.add(s.attr)
            # the acquire side of an owned-returning method is, by
            # construction, discharged by its return — its own leaks on
            # *non*-return paths still count, so keep them
            for leak in w.leaks:
                ob = leak.obligation
                exit_desc = ("return" if leak.exit_kind == "return"
                             else "end of the function")
                out.append(Finding(
                    file=fi.ms.sm.rel, line=ob.line, code="ST1101",
                    severity="error",
                    message=(
                        f"`{ob.desc}` acquires {_KIND_NOUN[ob.kind]} here, "
                        f"but a path reaching the {exit_desc} at line "
                        f"{leak.exit_line} neither {_KIND_VERB[ob.kind]} it "
                        "nor stores/returns/transfers it — leaked "
                        "ownership; discharge it on every path "
                        "(try/finally) or hand it to a sink"
                    )))
            for dr in w.double_releases:
                ob = dr.obligation
                out.append(Finding(
                    file=fi.ms.sm.rel, line=dr.line, code="ST1102",
                    severity="error",
                    message=(
                        f"`{dr.desc}(...)` releases again what this path "
                        f"already released (acquired via `{ob.desc}` at "
                        f"line {ob.line}) — a double release corrupts the "
                        "refcount/free-list; release exactly once per path"
                    )))
        return out

    # -- owning containers (the retire-path empty-store rule) ---------------
    def check_containers(self) -> List[Finding]:
        out: List[Finding] = []
        for fi, w in self._walks:
            for store in w.empty_stores:
                if store.attr not in self._own_attrs:
                    continue
                if any(rl.attr == store.attr and rl.line < store.line
                       for rl in w.release_loops):
                    continue
                out.append(Finding(
                    file=fi.ms.sm.rel, line=store.line, code="ST1101",
                    severity="error",
                    message=(
                        f"`self.{store.attr}[...]` is emptied here, but "
                        f"`{store.attr}` owns pages (pages are stored "
                        "into it elsewhere) and no release loop over "
                        f"`self.{store.attr}` precedes the clear in this "
                        "function — the dropped pages leak from the "
                        "pool; release each page before emptying the slot"
                    )))
        return out

    # -- stored threads: started somewhere, joined nowhere -------------------
    def check_threads(self) -> List[Finding]:
        starts: Dict[Tuple[str, str], Tuple[object, int]] = {}
        joins: Set[Tuple[str, str]] = set()
        for fi in self.model.funcs.values():
            cls = fi.class_name
            if cls is None or isinstance(fi.node, ast.Lambda):
                continue
            for call in ast.walk(fi.node):
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)):
                    continue
                recv = call.func.value
                if not (isinstance(recv, ast.Attribute)
                        and isinstance(recv.value, ast.Name)
                        and recv.value.id == "self"):
                    continue
                if self.attr_type(cls, recv.attr) != "ext:thread":
                    continue
                owner = next((c for c in self.mro(cls)
                              if (c, recv.attr) in self.model.attr_types),
                             cls)
                key = (owner, recv.attr)
                if call.func.attr == CONTRACT["threads"]["acquire"]:
                    starts.setdefault(key, (fi, call.lineno))
                elif call.func.attr == CONTRACT["threads"]["release"]:
                    joins.add(key)
        out: List[Finding] = []
        for key in sorted(starts):
            if key in joins:
                continue
            cls, attr = key
            fi, line = starts[key]
            out.append(Finding(
                file=fi.ms.sm.rel, line=line, code="ST1101",
                severity="error",
                message=(
                    f"thread `self.{attr}` (class `{cls}`) is started "
                    "here but no method of the class ever joins it — the "
                    "stop/drain path cannot bound shutdown; join it "
                    "(with a timeout) after signalling stop"
                )))
        return out

    # -- terminal-outcome funnels (ST1103) -----------------------------------
    def _enclosing_func(self, ms, node: ast.AST) -> Optional[ast.AST]:
        cur = ms.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = ms.parents.get(cur)
        return None

    def check_funnels(self) -> List[Finding]:
        out: List[Finding] = []
        funnels = CONTRACT["funnels"]
        stores = CONTRACT["outcome_stores"]
        for ms in self.model.index.scopes.values():
            for node in ast.walk(ms.sm.tree):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr in funnels:
                    want = funnels[node.func.attr]
                    encl = self._enclosing_func(ms, node)
                    fname = encl.name if encl is not None else None
                    if fname != want:
                        out.append(Finding(
                            file=ms.sm.rel, line=node.lineno,
                            code="ST1103", severity="error",
                            message=(
                                f"terminal outcome recorded via "
                                f"`{node.func.attr}(...)` outside its "
                                f"designated funnel `{want}` (here: "
                                f"`{fname or '<module>'}`) — exactly-one-"
                                "terminal is only auditable when every "
                                f"terminal write routes through `{want}`"
                            )))
                elif isinstance(node, ast.Assign):
                    for t in node.targets:
                        if not (isinstance(t, ast.Subscript)
                                and isinstance(t.value, ast.Attribute)
                                and isinstance(t.value.value, ast.Name)
                                and t.value.value.id == "self"
                                and t.value.attr in stores):
                            continue
                        want = stores[t.value.attr]
                        encl = self._enclosing_func(ms, node)
                        fname = encl.name if encl is not None else None
                        if fname != want:
                            out.append(Finding(
                                file=ms.sm.rel, line=node.lineno,
                                code="ST1103", severity="error",
                                message=(
                                    f"terminal result stored into "
                                    f"`self.{t.value.attr}[...]` outside "
                                    f"its designated funnel `{want}` "
                                    f"(here: `{fname or '<module>'}`) — "
                                    "route terminal stores through "
                                    f"`{want}` so each request ends "
                                    "exactly once"
                                )))
        return out

    # -- request spans (ST1104) ----------------------------------------------
    def _span_wrappers(self) -> Dict[str, tuple]:
        """Functions forwarding (ph, name) into ``async_event`` — maps
        wrapper name -> ((kind, val), (kind, val)) where kind is
        ``const`` or ``param`` (position excluding self)."""
        event = CONTRACT["spans"]["event"]
        wrappers: Dict[str, object] = {}
        for fi in self.model.funcs.values():
            node = fi.node
            if isinstance(node, ast.Lambda):
                continue
            params = [a.arg for a in node.args.posonlyargs + node.args.args]
            if params and params[0] == "self":
                params = params[1:]
            for call in ast.walk(node):
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and call.func.attr == event
                        and len(call.args) >= 2):
                    continue
                spec = []
                for argexpr in call.args[:2]:
                    if isinstance(argexpr, ast.Constant) and \
                            isinstance(argexpr.value, str):
                        spec.append(("const", argexpr.value))
                    elif isinstance(argexpr, ast.Name) and \
                            argexpr.id in params:
                        spec.append(("param", params.index(argexpr.id)))
                    else:
                        spec = None
                        break
                if spec is None:
                    continue
                prev = wrappers.get(node.name)
                if prev is not None and prev != tuple(spec):
                    wrappers[node.name] = "ambiguous"
                else:
                    wrappers[node.name] = tuple(spec)
        return {k: v for k, v in wrappers.items() if v != "ambiguous"}

    @staticmethod
    def _const_names(expr: ast.AST) -> List[str]:
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return [expr.value]
        if isinstance(expr, ast.IfExp):
            return (_OwnershipModel._const_names(expr.body)
                    + _OwnershipModel._const_names(expr.orelse))
        return []

    def check_spans(self) -> List[Finding]:
        event = CONTRACT["spans"]["event"]
        wrappers = self._span_wrappers()
        begins: Dict[str, Tuple[str, int]] = {}
        end_sites: Dict[str, Tuple[str, int]] = {}
        closers: Set[str] = set()
        instants: Set[str] = set()

        def record(ph, names, rel, line) -> None:
            for nm in names:
                if ph == "b":
                    begins.setdefault(nm, (rel, line))
                elif ph == "e":
                    closers.add(nm)
                    end_sites.setdefault(nm, (rel, line))
                elif ph == "n":
                    instants.add(nm)

        for ms in self.model.index.scopes.values():
            for call in ast.walk(ms.sm.tree):
                if not isinstance(call, ast.Call):
                    continue
                tail = call_tail(call)
                if tail == event and len(call.args) >= 2:
                    if isinstance(call.args[0], ast.Constant):
                        record(call.args[0].value,
                               self._const_names(call.args[1]),
                               ms.sm.rel, call.lineno)
                elif tail in wrappers:
                    ph_spec, name_spec = wrappers[tail]
                    ph = None
                    if ph_spec[0] == "const":
                        ph = ph_spec[1]
                    elif ph_spec[1] < len(call.args) and \
                            isinstance(call.args[ph_spec[1]], ast.Constant):
                        ph = call.args[ph_spec[1]].value
                    if ph is None:
                        continue
                    if name_spec[0] == "const":
                        names = [name_spec[1]]
                    elif name_spec[1] < len(call.args):
                        names = self._const_names(call.args[name_spec[1]])
                    else:
                        names = []
                    record(ph, names, ms.sm.rel, call.lineno)
        out: List[Finding] = []
        for name in sorted(begins):
            if name in closers or name in instants:
                continue
            rel, line = begins[name]
            out.append(Finding(
                file=rel, line=line, code="ST1104", severity="error",
                message=(
                    f"request span `{name}` is begun here (ph=\"b\") but "
                    "nothing in the analyzed set ever ends it (ph=\"e\") "
                    "or marks it instant (ph=\"n\") — the async track "
                    "renders an unterminated span; emit the closing "
                    "event on every terminal path"
                )))
        for name in sorted(end_sites):
            if name in begins:
                continue
            rel, line = end_sites[name]
            out.append(Finding(
                file=rel, line=line, code="ST1104", severity="error",
                message=(
                    f"request span `{name}` is ended here (ph=\"e\") but "
                    "nothing in the analyzed set ever begins it "
                    "(ph=\"b\") — an end without a begin is dropped by "
                    "the trace viewer; begin the span where the phase "
                    "starts"
                )))
        return out

    # -- rollback-path ordering (ST1105) -------------------------------------
    def _handler_release_events(self, handler, cls, lts, params):
        """Ordered (line, receiver, provenance, desc) for allocator
        releases in one except-handler body. Provenance is ``param``
        (operand rooted at a function parameter), ``local`` or ``self``."""
        alloc = CONTRACT["allocators"]
        events = []
        skip: Set[int] = set()

        def recv_of(call):
            if not (isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr in alloc["release"]):
                return None
            rtype = self._recv_type(call.func.value, cls, lts)
            if rtype in alloc["classes"]:
                return ast.unparse(call.func.value)
            return None

        def provenance(root: Optional[str]) -> str:
            if root == "self":
                return "self"
            if root in params:
                return "param"
            return "local"

        for stmt in handler.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.For) and \
                        isinstance(sub.target, ast.Name):
                    body_calls = [s.value for s in sub.body
                                  if isinstance(s, ast.Expr)
                                  and isinstance(s.value, ast.Call)]
                    if len(body_calls) == len(sub.body) and body_calls \
                            and all(recv_of(c) is not None
                                    and c.args
                                    and isinstance(c.args[0], ast.Name)
                                    and c.args[0].id == sub.target.id
                                    for c in body_calls):
                        events.append((
                            sub.lineno, recv_of(body_calls[0]),
                            provenance(_root_name(sub.iter)),
                            ast.unparse(sub.iter),
                        ))
                        skip.update(id(c) for c in body_calls)
                elif isinstance(sub, ast.Call) and id(sub) not in skip:
                    recv = recv_of(sub)
                    if recv is not None and sub.args:
                        events.append((
                            sub.lineno, recv,
                            provenance(_root_name(sub.args[0])),
                            ast.unparse(sub.args[0]),
                        ))
        events.sort(key=lambda e: e[0])
        return events

    def check_rollback(self) -> List[Finding]:
        out: List[Finding] = []
        for ms in self.model.index.scopes.values():
            for node in ast.walk(ms.sm.tree):
                if not isinstance(node, ast.Try):
                    continue
                encl = self._enclosing_func(ms, node)
                if encl is None:
                    continue
                fi = self.model.funcs.get(encl)
                cls = fi.class_name if fi is not None else None
                lts = self.local_types(encl)
                params = {a.arg for a in encl.args.args
                          + encl.args.kwonlyargs} - {"self"}
                for handler in node.handlers:
                    events = self._handler_release_events(
                        handler, cls, lts, params)
                    if len({e[1] for e in events}) < 2:
                        continue
                    for i, (line, recv, prov, desc) in enumerate(events):
                        if prov != "param":
                            continue
                        later = next(
                            (e for e in events[i + 1:]
                             if e[2] == "local" and e[1] != recv), None)
                        if later is None:
                            continue
                        out.append(Finding(
                            file=ms.sm.rel, line=line, code="ST1105",
                            severity="error",
                            message=(
                                "rollback handler releases the transfer "
                                f"source first (`{recv}.release` over "
                                f"`{desc}`, which came in as a parameter) "
                                "before the destination "
                                f"(`{later[1]}.release` over `{later[3]}` "
                                f"at line {later[0]}) — release the "
                                "destination's newly acquired pages "
                                "first, then the source, so a fault "
                                "between the two cannot orphan pages "
                                "that still have a live owner"
                            )))
                        break
        return out


def run(index: ProjectIndex) -> List[Finding]:
    model = ThreadModel(index)
    om = _OwnershipModel(model)
    findings = om.check_lifecycles()
    findings += om.check_containers()
    findings += om.check_threads()
    findings += om.check_funnels()
    findings += om.check_spans()
    findings += om.check_rollback()
    findings.sort(key=lambda f: (f.file, f.line, f.code))
    return findings
