"""Shared path-sensitive obligation walker for the ownership tier.

An intraprocedural abstract interpreter over one function body. The
*contract* (analysis/ownership.py) classifies calls into acquires and
releases; this module owns the control-flow reasoning: branch forking
with state merge at joins, exception edges into in-function handlers,
``finally`` execution on early returns, loop bodies with break/continue
collection, and ``None``-refinement for maybe-None acquires (the
``PageAllocator.alloc`` all-or-nothing contract).

The abstract state maps local variable names to *obligation* sets and
each obligation to a set of statuses reachable at the current program
point:

  ``live``      acquired, not yet discharged — a leak if it reaches a
                normal exit (return / fall-off-end).
  ``released``  a release ran on this path — a second release is a
                double-release (ST1102).
  ``done``      ownership escaped: stored to an attribute/container,
                returned, yielded, passed to a sink call, or aliased.
  ``none``      refined to None (``if x is None:``) — nothing was
                acquired on this path.

Precision beats recall, deliberately (docs/static_analysis.md "known
limits"): uncaught-exception propagation and explicit ``raise`` exits
are not leak-checked (only edges into *in-function* handlers are
modeled), reads never discharge or flag, aliasing (``y = x[0]``)
discharges rather than transfers, and acquires whose result is not
bound to a plain local name are untracked.
"""

from __future__ import annotations

import ast
import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .scopes import dotted_name

# classify_call(call) results --------------------------------------------------
# ("acquire", kind, maybe_none)       obligation on the assignment target
# ("acquire_arg", kind)               obligation on the (Name) first arg
#                                     (single `recv.retain(x)`)
# ("acquire_recv", kind)              obligation on the (Name) receiver
#                                     (`t.start()` on a typed Thread)
# ("release", kind, operand_expr)     discharges the operand's obligations
# ("release_recv", kinds)             `.close()` / `.join()` on the receiver
Classifier = Callable[[ast.Call], Optional[tuple]]


@dataclasses.dataclass
class Obligation:
    oid: int
    kind: str          # "pages" | "file" | "socket" | "thread"
    line: int
    desc: str          # rendered acquire site, e.g. "self.allocator.alloc(n)"
    maybe_none: bool


@dataclasses.dataclass
class Leak:
    obligation: Obligation
    exit_line: int
    exit_kind: str     # "return" | "end"


@dataclasses.dataclass
class DoubleRelease:
    obligation: Obligation
    line: int
    desc: str


@dataclasses.dataclass
class OwnStore:
    """``self.X[i] = v`` where ``v`` carries a pages obligation — marks
    ``X`` as an owning container (the ST1101 empty-store rule)."""

    attr: str
    line: int


@dataclasses.dataclass
class ReleaseLoop:
    """``for p in <iterable>: recv.release(p)`` over a non-local
    iterable (``self.X[i]``) — the discharge side of the owning-
    container rule."""

    attr: Optional[str]   # X when the iterable is self.X[...] / self.X
    line: int


class _State:
    """Bindings (var -> oid set) + statuses (oid -> status set)."""

    __slots__ = ("bind", "status")

    def __init__(self) -> None:
        self.bind: Dict[str, Set[int]] = {}
        self.status: Dict[int, Set[str]] = {}

    def copy(self) -> "_State":
        st = _State()
        st.bind = {k: set(v) for k, v in self.bind.items()}
        st.status = {k: set(v) for k, v in self.status.items()}
        return st

    @staticmethod
    def merge(states: Sequence["_State"]) -> "_State":
        out = _State()
        for st in states:
            for var, oids in st.bind.items():
                out.bind.setdefault(var, set()).update(oids)
            for oid, ss in st.status.items():
                out.status.setdefault(oid, set()).update(ss)
        return out


class FunctionWalk:
    """Walk one function body under a call classifier; collect leaks,
    double releases, owning-container stores and release loops."""

    def __init__(self, fn: ast.AST, classify_call: Classifier,
                 oid_counter: Optional[itertools.count] = None) -> None:
        self.fn = fn
        self.classify = classify_call
        self._oids = oid_counter or itertools.count(1)
        self.obligations: Dict[int, Obligation] = {}
        self.leaks: List[Leak] = []
        self.double_releases: List[DoubleRelease] = []
        self.own_stores: List[OwnStore] = []
        self.empty_stores: List[OwnStore] = []
        self.release_loops: List[ReleaseLoop] = []
        self.returns_owned = False       # a return expr used a pages oid
        self.params = {
            a.arg for a in (fn.args.posonlyargs + fn.args.args
                            + fn.args.kwonlyargs)
        }
        if fn.args.vararg:
            self.params.add(fn.args.vararg.arg)
        if fn.args.kwarg:
            self.params.add(fn.args.kwarg.arg)
        # loop frames: (breaks, continues) state collectors
        self._frames: List[Tuple[List[_State], List[_State]]] = []
        # pending finally bodies (innermost last) for early returns
        self._finals: List[List[ast.stmt]] = []
        self._in_final = False

    def run(self) -> "FunctionWalk":
        st = self._exec_block(self.fn.body, _State())
        if st is not None:
            self._check_exit(st, getattr(self.fn, "end_lineno", None)
                             or self.fn.lineno, "end")
        return self

    # -- statements --------------------------------------------------------
    def _exec_block(self, stmts: Sequence[ast.stmt],
                    st: Optional[_State]) -> Optional[_State]:
        for stmt in stmts:
            if st is None:
                break
            st = self._exec_stmt(stmt, st)
        return st

    def _exec_stmt(self, stmt: ast.stmt, st: _State) -> Optional[_State]:
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._escape_uses(stmt.value, st, returning=True)
            self._run_pending_finals(st)
            self._check_exit(st, stmt.lineno, "return")
            return None
        if isinstance(stmt, ast.Raise):
            # error exits are exempt by design (the raising path already
            # failed; flagging it would drown real leaks in noise)
            return None
        if isinstance(stmt, ast.Break):
            if self._frames:
                self._frames[-1][0].append(st)
            return None
        if isinstance(stmt, ast.Continue):
            if self._frames:
                self._frames[-1][1].append(st)
            return None
        if isinstance(stmt, ast.If):
            return self._exec_if(stmt, st)
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            return self._exec_for(stmt, st)
        if isinstance(stmt, ast.While):
            return self._exec_loop_body(stmt, st)
        if isinstance(stmt, ast.Try):
            return self._exec_try(stmt, st)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            # `with open(p) as f:` — the context manager releases; the
            # acquire inside a withitem never becomes an obligation
            for item in stmt.items:
                self._scan_expr(item.context_expr, st, in_with=True)
            return self._exec_block(stmt.body, st)
        if isinstance(stmt, ast.Assign):
            return self._exec_assign(stmt, st)
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                fake = ast.Assign(targets=[stmt.target], value=stmt.value)
                ast.copy_location(fake, stmt)
                return self._exec_assign(fake, st)
            return st
        if isinstance(stmt, ast.AugAssign):
            self._escape_uses(stmt.value, st)
            return st
        if isinstance(stmt, ast.Expr):
            self._scan_expr(stmt.value, st)
            return st
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return st  # nested defs get their own walk
        if isinstance(stmt, (ast.Assert, ast.Delete, ast.Pass, ast.Global,
                             ast.Nonlocal, ast.Import, ast.ImportFrom)):
            return st
        # anything else: conservatively scan for calls and escapes
        for call in ast.walk(stmt):
            if isinstance(call, ast.Call):
                self._scan_expr(call, st)
                break
        return st

    def _exec_if(self, stmt: ast.If, st: _State) -> Optional[_State]:
        self._scan_test(stmt.test, st)
        then_st, else_st = st.copy(), st
        self._refine(stmt.test, then_st, truthy=True)
        self._refine(stmt.test, else_st, truthy=False)
        a = self._exec_block(stmt.body, then_st)
        b = self._exec_block(stmt.orelse, else_st)
        outs = [s for s in (a, b) if s is not None]
        return _State.merge(outs) if outs else None

    def _exec_for(self, stmt, st: _State) -> Optional[_State]:
        rel = self._release_loop_parts(stmt, st)
        if rel is not None:
            iterable, kind, desc = rel
            if isinstance(iterable, ast.Name) and iterable.id in st.bind:
                self._apply_release(iterable.id, kind, st, stmt.lineno, desc)
            else:
                self.release_loops.append(ReleaseLoop(
                    attr=self._self_attr_of(iterable), line=stmt.lineno))
            return st
        ret = self._retain_loop_var(stmt)
        if ret is not None:
            var, line, desc = ret
            self._acquire(st, var, "pages", False, line, desc)
            return st
        # plain loop: iteration is a read, not an escape
        return self._exec_loop_body(stmt, st)

    def _exec_loop_body(self, stmt, st: _State) -> Optional[_State]:
        if isinstance(stmt, ast.While):
            self._scan_test(stmt.test, st)
        self._frames.append(([], []))
        body_out = self._exec_block(stmt.body, st.copy())
        breaks, continues = self._frames.pop()
        outs = [st] + [s for s in [body_out] + continues if s is not None]
        after = _State.merge(outs)
        if stmt.orelse:
            after = self._exec_block(stmt.orelse, after)
        outs2 = [s for s in [after] + breaks if s is not None]
        return _State.merge(outs2) if outs2 else None

    def _exec_try(self, stmt: ast.Try, st: _State) -> Optional[_State]:
        body_entry = st.copy()
        snapshots: List[_State] = [body_entry]
        if stmt.finalbody:
            self._finals.append(stmt.finalbody)
        cur: Optional[_State] = st
        for s in stmt.body:
            if cur is None:
                break
            snapshots.append(cur.copy())
            cur = self._exec_stmt(s, cur)
        if cur is not None and stmt.orelse:
            cur = self._exec_block(stmt.orelse, cur)
        outs = [cur] if cur is not None else []
        for handler in stmt.handlers:
            h_out = self._exec_block(handler.body, _State.merge(snapshots))
            if h_out is not None:
                outs.append(h_out)
        if stmt.finalbody:
            self._finals.pop()
        merged = _State.merge(outs) if outs else None
        if stmt.finalbody:
            if merged is None:
                # all paths returned/raised; the return paths already ran
                # the finally via _run_pending_finals
                return None
            return self._exec_block(stmt.finalbody, merged)
        return merged

    def _run_pending_finals(self, st: _State) -> None:
        """A return inside try/finally runs the pending finalbodies
        before the leak check (the ``finally: release`` idiom)."""
        if self._in_final or not self._finals:
            return
        self._in_final = True
        try:
            for fb in reversed(self._finals):
                out = self._exec_block(fb, st)
                if out is None:
                    break
        finally:
            self._in_final = False

    def _exec_assign(self, stmt: ast.Assign, st: _State) -> _State:
        value = stmt.value
        targets = stmt.targets
        acq = self._classify(value)
        if acq is not None and acq[0] == "acquire":
            _, kind, maybe_none = acq
            desc = ast.unparse(value.func)
            if len(targets) == 1 and isinstance(targets[0], ast.Name):
                self._acquire(st, targets[0].id, kind, maybe_none,
                              stmt.lineno, desc)
            # stored straight to an attribute/subscript: escaped at birth
            for arg in value.args + [kw.value for kw in value.keywords]:
                self._escape_uses(arg, st)
            return st
        if isinstance(value, ast.Name) and st.bind.get(value.id):
            # alias / tuple-unpack TRANSFERS the obligations (the
            # ``shared, pages = reserved`` shape) instead of discharging
            # them: releases and escapes through any alias still apply
            oids = set(st.bind[value.id])
            for target in targets:
                self._bind_alias(target, value, oids, st)
            return st
        self._scan_expr(value, st)
        self._escape_uses(value, st)
        for target in targets:
            self._assign_target(target, value, st)
        return st

    def _bind_alias(self, target: ast.AST, value: ast.Name, oids: Set[int],
                    st: _State) -> None:
        if isinstance(target, ast.Name):
            st.bind[target.id] = set(oids)
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind_alias(elt, value, oids, st)
            return
        # stored to an attribute / container slot: ownership escapes
        self._assign_target(target, value, st)
        self._escape_uses(value, st)

    def _assign_target(self, target: ast.AST, value: ast.AST,
                       st: _State) -> None:
        if isinstance(target, ast.Name):
            # rebinding: the old obligations lose their reference (a
            # still-live one will flag at exit), the name starts fresh
            st.bind[target.id] = set()
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._assign_target(elt, value, st)
            return
        if isinstance(target, ast.Subscript):
            attr = self._self_attr_of(target.value)
            if attr is not None:
                if isinstance(value, ast.Name) and any(
                    "pages" == self.obligations[oid].kind
                    for oid in st.bind.get(value.id, ())
                    if oid in self.obligations
                ):
                    self.own_stores.append(OwnStore(attr=attr,
                                                    line=target.lineno))
                elif _is_empty_literal(value):
                    self.empty_stores.append(OwnStore(attr=attr,
                                                      line=target.lineno))

    # -- expressions -------------------------------------------------------
    def _scan_expr(self, expr: ast.AST, st: _State,
                   in_with: bool = False) -> None:
        """Apply acquire/release/escape semantics to one expression
        statement (or with-item / condition sub-expression)."""
        if not isinstance(expr, ast.Call):
            for call in (n for n in ast.walk(expr)
                         if isinstance(n, ast.Call)):
                self._scan_expr(call, st, in_with=in_with)
            return
        cls = self._classify(expr)
        if cls is not None:
            tag = cls[0]
            if tag == "acquire":
                # unbound acquire (incl. with-items): untracked by design
                for arg in expr.args + [kw.value for kw in expr.keywords]:
                    self._escape_uses(arg, st)
                return
            if tag == "acquire_arg":
                _, kind = cls
                if expr.args and isinstance(expr.args[0], ast.Name):
                    self._acquire(st, expr.args[0].id, kind, False,
                                  expr.lineno, ast.unparse(expr.func))
                return
            if tag == "acquire_recv":
                _, kind = cls
                recv = expr.func.value
                if isinstance(recv, ast.Name):
                    self._acquire(st, recv.id, kind, False, expr.lineno,
                                  ast.unparse(expr))
                return
            if tag == "release":
                _, kind, operand = cls
                if isinstance(operand, ast.Name) and operand.id in st.bind:
                    self._apply_release(operand.id, kind, st, expr.lineno,
                                        ast.unparse(expr.func))
                return
            if tag == "release_recv":
                _, kinds = cls
                recv = expr.func.value
                if isinstance(recv, ast.Name) and recv.id in st.bind:
                    for kind in kinds:
                        self._apply_release(recv.id, kind, st, expr.lineno,
                                            ast.unparse(expr.func))
                return
        # unclassified call: arguments escape (sinks — radix.insert,
        # list.append, channel.transfer, user callables); a method
        # *receiver* is only read
        for arg in expr.args + [kw.value for kw in expr.keywords]:
            self._escape_uses(arg, st)
            self._scan_expr(arg, st)
        if isinstance(expr.func, ast.Attribute):
            self._scan_expr(expr.func.value, st)

    def _scan_test(self, test: ast.AST, st: _State) -> None:
        """Conditions: reads don't escape, but nested calls still count
        (acquires/releases inside a test are rare but legal)."""
        for call in (n for n in ast.walk(test) if isinstance(n, ast.Call)):
            self._scan_expr(call, st)
            break

    def _escape_uses(self, expr: ast.AST, st: _State,
                     returning: bool = False) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Name) and node.id in st.bind:
                for oid in st.bind[node.id]:
                    ss = st.status.get(oid)
                    if ss is None or ss == {"none"}:
                        continue
                    if returning and oid in self.obligations and \
                            self.obligations[oid].kind == "pages":
                        self.returns_owned = True
                    st.status[oid] = {"done"}

    # -- contract application ----------------------------------------------
    def _classify(self, expr: ast.AST) -> Optional[tuple]:
        if isinstance(expr, ast.Call):
            return self.classify(expr)
        return None

    def _acquire(self, st: _State, var: str, kind: str, maybe_none: bool,
                 line: int, desc: str) -> None:
        oid = next(self._oids)
        self.obligations[oid] = Obligation(
            oid=oid, kind=kind, line=line, desc=desc, maybe_none=maybe_none)
        st.bind.setdefault(var, set()).add(oid)
        st.status[oid] = {"live"}

    def _apply_release(self, var: str, kind: str, st: _State, line: int,
                       desc: str) -> None:
        for oid in st.bind.get(var, ()):
            ob = self.obligations.get(oid)
            if ob is None or ob.kind != kind:
                continue
            ss = st.status.get(oid, set())
            if ss == {"none"}:
                continue
            if "released" in ss:
                self.double_releases.append(
                    DoubleRelease(obligation=ob, line=line, desc=desc))
            if "done" in ss and "live" not in ss and "released" not in ss:
                continue  # escaped ownership: release belongs to the sink
            st.status[oid] = {"released"}

    # -- refinement ---------------------------------------------------------
    def _refine(self, test: ast.AST, st: _State, truthy: bool) -> None:
        """``if x is None:`` / ``if x is not None:`` (optionally behind
        ``not`` or as the first operand of an ``and``) narrows x."""
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            self._refine(test.operand, st, not truthy)
            return
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            if truthy and test.values:
                self._refine(test.values[0], st, True)
            return
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.comparators[0], ast.Constant)
                and test.comparators[0].value is None
                and isinstance(test.left, ast.Name)):
            return
        is_none = isinstance(test.ops[0], ast.Is)
        if not is_none and not isinstance(test.ops[0], ast.IsNot):
            return
        var = test.left.id
        none_branch = (is_none == truthy)
        for oid in st.bind.get(var, ()):
            ss = st.status.get(oid)
            if ss is None:
                continue
            if none_branch:
                st.status[oid] = {"none"}
            else:
                ss.discard("none")
                if not ss:
                    st.status[oid] = {"done"}  # unreachable combination

    # -- exits ---------------------------------------------------------------
    def _check_exit(self, st: _State, line: int, kind: str) -> None:
        seen: Set[int] = set()
        for oid, ss in sorted(st.status.items()):
            if oid in seen or "live" not in ss:
                continue
            seen.add(oid)
            ob = self.obligations.get(oid)
            if ob is not None:
                self.leaks.append(Leak(obligation=ob, exit_line=line,
                                       exit_kind=kind))

    # -- loop-shape recognition ----------------------------------------------
    def _release_loop_parts(self, stmt, st: _State):
        """``for p in X: recv.release(p)`` (one or more release calls on
        the loop target, nothing else) -> (iterable, kind)."""
        if not isinstance(stmt.target, ast.Name) or stmt.orelse:
            return None
        kind = None
        desc = ""
        for body_stmt in stmt.body:
            if not (isinstance(body_stmt, ast.Expr)
                    and isinstance(body_stmt.value, ast.Call)):
                return None
            cls = self._classify(body_stmt.value)
            if cls is None or cls[0] != "release":
                return None
            operand = cls[2]
            if not (isinstance(operand, ast.Name)
                    and operand.id == stmt.target.id):
                return None
            kind = cls[1]
            desc = ast.unparse(body_stmt.value.func)
        return (stmt.iter, kind, desc) if kind is not None else None

    def _retain_loop_var(self, stmt):
        """``for p in X: recv.retain(p)`` -> (X, line, desc): the loop
        acquires one reference per element of X."""
        if not (isinstance(stmt.target, ast.Name)
                and isinstance(stmt.iter, ast.Name) and not stmt.orelse):
            return None
        descs = []
        for body_stmt in stmt.body:
            if not (isinstance(body_stmt, ast.Expr)
                    and isinstance(body_stmt.value, ast.Call)):
                return None
            cls = self._classify(body_stmt.value)
            if cls is None or cls[0] != "acquire_arg":
                return None
            call = body_stmt.value
            if not (call.args and isinstance(call.args[0], ast.Name)
                    and call.args[0].id == stmt.target.id):
                return None
            descs.append(ast.unparse(call.func))
        if not descs:
            return None
        return stmt.iter.id, stmt.lineno, descs[0]

    # -- helpers --------------------------------------------------------------
    @staticmethod
    def _self_attr_of(expr: ast.AST) -> Optional[str]:
        """``self.X`` / ``self.X[...]`` -> ``X``."""
        if isinstance(expr, ast.Subscript):
            expr = expr.value
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self":
            return expr.attr
        return None


def _is_empty_literal(value: ast.AST) -> bool:
    if isinstance(value, (ast.List, ast.Tuple, ast.Set)):
        return not value.elts
    if isinstance(value, ast.Dict):
        return not value.keys
    return False


def call_tail(call: ast.Call) -> Optional[str]:
    """Last dotted component of the callee, e.g. ``release`` for
    ``self.allocator.release``."""
    d = dotted_name(call.func)
    if d is None:
        return None
    return d.split(".")[-1]
