"""ST9xx — host-thread race & deadlock hazards (the concurrency tier).

The serving stack is genuinely concurrent: an asyncio gateway loop, one
``EngineWorker`` thread per replica, watchdog/exporter threads, and
SIGUSR1/SIGTERM handlers all share state. Every concurrency bug so far
(the SpanTracer plain-``Lock`` deadlock under a SIGUSR1 handler, the
disconnect-vs-channel race, the dead-worker reap race) was caught by
human review, not by the analyzer. This pass is the static dual of those
reviews, in the spirit of lightweight lockset race detection, built on
``threads.ThreadModel`` (thread roots, typed call graph, effective
locksets):

ST901  shared mutable attribute (dict/list/set mutation, augmented
       assignment, non-atomic read-modify-write) mutated from two or
       more thread roots with *no lock at all* on at least two of
       them; error. Plain attribute rebinding (``self.flag = True``)
       is atomic enough under the GIL and never flags — the watchdog
       beat-write idiom. A discipline where every mutation from one
       root is locked is trusted (state-machine exclusion, e.g. the
       gateway's reap-lock) — the detector targets *unlocked*
       write-write races.
ST902  asyncio loop state (``asyncio.Event``/``Queue``/``Task``/loop
       methods) touched from a non-loop root without going through
       ``call_soon_threadsafe``/``run_coroutine_threadsafe``; error.
       The sanctioned trampoline itself never flags.
ST903  known-blocking call (``time.sleep``, sync ``queue`` ops,
       ``subprocess``, ``Thread.join``, ``threading.Event.wait``,
       threading-lock ``acquire``, ``Future.result``) directly inside
       a coroutine body — it stalls every request sharing the loop;
       warning (wrap in ``run_in_executor``).
ST904  a signal-handler-reachable function acquires a NON-reentrant
       ``threading.Lock`` that the main path also acquires — the
       handler interrupting the holder mid-critical-section deadlocks
       the process (the PR 8 SpanTracer bug, caught before review);
       error. ``RLock`` never flags.
ST905  bare ``lock.acquire()`` not immediately followed by
       ``try/finally: lock.release()`` (and not a ``with``) — the lock
       leaks on any exception in between; error.
ST906  lock-order cycle: some path acquires A then B while another
       acquires B then A (AB–BA deadlock), computed over the
       root-propagated acquisition graph; error.

Like every AST pass this is pure-AST — nothing under analysis is
imported — and it holds the zero-false-positive bar: the real
``gateway.py``/``spans.py``/``export.py``/``resilience_distributed.py``
patterns (trampolined ``call_soon_threadsafe`` puts, the reap-lock
discipline, the RLock'd tracer, watchdog beat writes) lint clean, and
injection tests reverting the historical review fixes must flag.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Set, Tuple

from .core import Finding
from .scopes import ProjectIndex
from .threads import LOOP_ROOT, LockId, RootId, ThreadModel

# roots the ST901 rule treats as concurrent mutation contexts
_CONCRETE_KINDS = ("thread", "signal", "loop", "caller")


def run(index: ProjectIndex) -> List[Finding]:
    model = ThreadModel(index)
    findings: List[Finding] = []
    findings.extend(_check_st901(model))
    findings.extend(_check_st902(model))
    findings.extend(_check_st903(model))
    findings.extend(_check_st904(model))
    findings.extend(_check_st905(model))
    findings.extend(_check_st906(model))
    return findings


# ---------------------------------------------------------------------------
# ST901 — unlocked cross-root mutation
# ---------------------------------------------------------------------------

def _check_st901(model: ThreadModel) -> List[Finding]:
    out: List[Finding] = []
    for key, per_root in sorted(model.attr_map.items()):
        # mutation records per concrete root
        mut_roots: Dict[RootId, List] = {}
        for rid, recs in per_root.items():
            if rid[0] not in _CONCRETE_KINDS:
                continue
            muts = [(acc, eff) for acc, eff in recs if acc.mutation]
            if muts:
                mut_roots[rid] = muts
        if len(mut_roots) < 2:
            continue
        # a root is "unlocked" when at least one of its mutations holds
        # no lock at all on some path
        unlocked = {
            rid: [(acc, eff) for acc, eff in muts if not eff]
            for rid, muts in mut_roots.items()
        }
        unlocked = {rid: m for rid, m in unlocked.items() if m}
        if len(unlocked) < 2:
            continue
        # anchor the finding at the first unlocked mutation site
        rids = sorted(unlocked)
        acc0, _ = min(
            (pair for rid in rids for pair in unlocked[rid]),
            key=lambda p: p[0].line,
        )
        cls, attr = key
        file = _file_of_class(model, cls) or "<unknown>"
        others = ", ".join(model.describe_root(r) for r in rids)
        out.append(Finding(
            file=file, line=acc0.line, code="ST901", severity="error",
            message=(
                f"shared attribute `{cls}.{attr}` is mutated "
                f"(`{acc0.desc}`) from {len(rids)} thread roots with no "
                f"lock held on any of them ({others}) — concurrent "
                "unlocked writes race; hold one lock at every mutation "
                "site, or confine the attribute to a single thread and "
                "trampoline updates to it"
            ),
        ))
    return out


def _file_of_class(model: ThreadModel, cls: str) -> str:
    ms = model.class_ms.get(cls)
    return ms.sm.rel if ms is not None else ""


# ---------------------------------------------------------------------------
# ST902 — loop state touched off-loop
# ---------------------------------------------------------------------------

def _check_st902(model: ThreadModel) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for touch, fi, rid in sorted(
            model.loop_touch_hits,
            key=lambda t: (t[1].ms.sm.rel, t[0].line)):
        if rid == LOOP_ROOT or rid[0] not in ("thread", "signal", "caller"):
            continue
        anchor = (fi.ms.sm.rel, touch.line)
        if anchor in seen:
            continue
        seen.add(anchor)
        out.append(Finding(
            file=fi.ms.sm.rel, line=touch.line, code="ST902",
            severity="error",
            message=(
                f"asyncio loop state touched via `{touch.desc}` from "
                f"{model.describe_root(rid)} — asyncio objects are not "
                "thread-safe off their loop; trampoline with "
                "`loop.call_soon_threadsafe(...)` or "
                "`asyncio.run_coroutine_threadsafe(...)`"
            ),
        ))
    return out


# ---------------------------------------------------------------------------
# ST903 — blocking call on the event loop
# ---------------------------------------------------------------------------

def _check_st903(model: ThreadModel) -> List[Finding]:
    out: List[Finding] = []
    for fn, facts in model.facts.items():
        fi = model.funcs[fn]
        if not fi.is_async:
            continue
        for blk in facts.blocking:
            out.append(Finding(
                file=fi.ms.sm.rel, line=blk.line, code="ST903",
                severity="warning",
                message=(
                    f"blocking call `{blk.desc}` inside coroutine "
                    f"`{fi.name}` — it stalls the event loop and every "
                    "request sharing it; await an async equivalent or "
                    "wrap it in `loop.run_in_executor(...)`"
                ),
            ))
    out.sort(key=lambda f: (f.file, f.line))
    return out


# ---------------------------------------------------------------------------
# ST904 — non-reentrant lock shared between a signal handler and main path
# ---------------------------------------------------------------------------

def _check_st904(model: ThreadModel) -> List[Finding]:
    out: List[Finding] = []
    for lid, per_root in sorted(model.lock_holders.items()):
        kind = model.lock_kinds.get(lid)
        if kind != "lock":
            continue
        sig_hits = [
            (acq, fi) for rid, recs in per_root.items()
            if rid in model.signal_roots for acq, fi in recs
        ]
        if not sig_hits:
            continue
        # any acquisition on a non-signal context (main path, a worker
        # thread, the loop, cross-thread callers) can be interrupted by
        # the handler while holding the lock
        main_hits = [
            (acq, fi) for rid, recs in per_root.items()
            if rid not in model.signal_roots for acq, fi in recs
        ]
        if not main_hits:
            continue
        acq, fi = min(sig_hits, key=lambda p: (p[1].ms.sm.rel, p[0].line))
        # prefer a witness at a different site than the anchor so the
        # message shows the two colliding paths, not the same line twice
        macq, mfi = min(
            main_hits,
            key=lambda p: (p[0].line == acq.line and p[1].ms is fi.ms,
                           p[1].ms.sm.rel, p[0].line))
        sig_root = next(iter(
            rid for rid, recs in per_root.items()
            if rid in model.signal_roots))
        out.append(Finding(
            file=fi.ms.sm.rel, line=acq.line, code="ST904",
            severity="error",
            message=(
                f"non-reentrant lock `{model.lock_name(lid)}` is acquired "
                f"here on a path reachable from {model.describe_root(sig_root)} "
                f"and also on the main path (e.g. `{mfi.name}` at "
                f"{mfi.ms.sm.rel}:{macq.line}) — a signal interrupting the "
                "holder re-enters and deadlocks the process; use "
                "`threading.RLock`, or set a flag in the handler and do "
                "the work outside it"
            ),
        ))
    return out


# ---------------------------------------------------------------------------
# ST905 — acquire() without try/finally release
# ---------------------------------------------------------------------------

def _check_st905(model: ThreadModel) -> List[Finding]:
    out: List[Finding] = []
    for fn, facts in model.facts.items():
        fi = model.funcs[fn]
        for acq in facts.acquires:
            if acq.style == "bare" and not acq.safe_release:
                out.append(Finding(
                    file=fi.ms.sm.rel, line=acq.line, code="ST905",
                    severity="error",
                    message=(
                        f"`{model.lock_name(acq.lock)}.acquire()` without "
                        "`with` or an immediate `try/finally: release()` — "
                        "any exception before the release leaks the lock "
                        "and wedges every other acquirer; use `with "
                        "lock:`"
                    ),
                ))
    out.sort(key=lambda f: (f.file, f.line))
    return out


# ---------------------------------------------------------------------------
# ST906 — lock-order cycles (AB–BA deadlock)
# ---------------------------------------------------------------------------

def _check_st906(model: ThreadModel) -> List[Finding]:
    edges: Dict[LockId, Set[LockId]] = {}
    for (a, b) in model.order_edges:
        edges.setdefault(a, set()).add(b)
    out: List[Finding] = []
    reported: Set[FrozenSet[LockId]] = set()
    for (a, b), (acq, fi) in sorted(
            model.order_edges.items(),
            key=lambda kv: (kv[1][1].ms.sm.rel, kv[1][0].line)):
        if _reaches(edges, b, a):
            cyc = frozenset((a, b))
            if cyc in reported:
                continue
            reported.add(cyc)
            out.append(Finding(
                file=fi.ms.sm.rel, line=acq.line, code="ST906",
                severity="error",
                message=(
                    f"lock-order cycle: this path acquires "
                    f"`{model.lock_name(b)}` while holding "
                    f"`{model.lock_name(a)}`, but another path acquires "
                    f"them in the opposite order — two threads taking "
                    "opposite orders deadlock (AB–BA); impose one global "
                    "order or collapse to a single lock"
                ),
            ))
    return out


def _reaches(edges: Dict[LockId, Set[LockId]], src: LockId,
             dst: LockId) -> bool:
    seen: Set[LockId] = set()
    stack = [src]
    while stack:
        cur = stack.pop()
        if cur == dst:
            return True
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(edges.get(cur, ()))
    return False
