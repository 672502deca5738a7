"""ST6xx — collective symmetry across ranks (deadlock hazards).

Every cross-rank collective in the port — the ``torch.distributed``
collectives over a ``DeviceMesh`` group or the default group, the
``DecisionBus`` gathers and broadcasts, the ``dist.py`` object
collectives and barriers, ``torch.distributed.checkpoint`` save and
load (collective over the checkpoint group), a ``new_group`` (which
every rank of the world must enter) — must be entered by EVERY rank or
by NONE: a rank that skips one leaves its peers blocked inside a
collective nobody will complete. The hang watchdog
(``resilience_distributed.HangWatchdog``) catches that at run time;
this pass is its static dual and flags collectives reachable only under
*rank-divergent* conditions:

ST601  collective reachable only under a rank-divergent branch
       (``get_rank()``/``is_main``/rank comparisons, including the
       complement via a divergent early return/raise) — the classic
       one-sided gather; error.
ST602  collective inside an ``except`` handler — exceptions are
       rank-local, so a retry or fallback collective in a handler
       re-enters without the fleet; warning (a DecisionBus-agreed retry
       is the fix, see ``utils/checkpoint.py``).
ST603  collective guarded by per-host filesystem / environment /
       wall-clock state (``os.path.exists``, ``os.environ``,
       ``time.*``) — uniform on a lucky day, divergent the day the
       shared FS lags on one host; warning.

What never flags (the protocol the port uses, see
``CoordinatedResilience``): collectives entered unconditionally with
rank-divergent *computation* around them, rank-divergent RESULT
visibility after the collective, IfExp payloads, branches on uniform
facts (``get_world_size() == 1``, config flags), and rank-local actions
under rank guards (log files, directory retirement: not collectives).
The reference's JAX spellings (``multihost_utils``, ``process_index``,
orbax managers) are still recognised, so the two analyzers agree on
shared files.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Tuple

from .core import Finding
from .scopes import ModuleScopes, ProjectIndex, dotted_name, tail_name

# -- collective classification ------------------------------------------------

# jax.experimental.multihost_utils — every one of these is a cross-host
# collective (sync_global_devices is the barrier the others build on).
_MULTIHOST_TAILS = {
    "sync_global_devices", "process_allgather", "broadcast_one_to_all",
    "assert_equal",
}
# scaletorch_tpu.dist object collectives + barrier.
_DIST_TAILS = {
    "all_gather_object", "broadcast_object_list", "gather_object",
    "collect_results", "barrier", "global_barrier",
}
# torch.distributed collectives: matched on a ``dist``/``distributed``
# receiver (``dist.all_reduce``, ``torch.distributed.broadcast``) so a
# local helper named ``all_gather`` never flags. Point-to-point
# ``send``/``recv`` pair ranks by design and are absent.
_TORCH_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
    "reduce", "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "gather", "scatter", "monitored_barrier",
    "new_group", "new_subgroups", "batch_isend_irecv",
    "init_process_group", "destroy_process_group", "init_device_mesh",
}
_TORCH_DIST_RECEIVER_RE = re.compile(r"(^|\.)(dist|distributed|c10d)$")
# torch.distributed.checkpoint save/load (collective over its group)
_DCP_CALLS = {"save", "load", "async_save", "save_state_dict",
              "load_state_dict"}
# DecisionBus protocol methods — collective when called on a bus-like
# receiver (…bus / self._bus / decision_bus) or on ``self`` inside a
# *Bus class. `all_gather`/`broadcast` alone are too generic to match
# without the receiver check (jax.lax.all_gather is a device collective
# inside symmetric traced code, not a host hazard).
_BUS_METHODS = {
    "all_gather", "broadcast", "broadcast_from_main", "agree_all",
    "agree_any",
}
_BUS_RECEIVER_RE = re.compile(r"(^|\.|_)bus$|(^|\.|_)bus(\.|_)", re.I)
# orbax checkpoint collectives — save/restore/drain are cross-process on
# multi-host runs. Matched only on checkpoint-ish receivers so
# ``threading.Event.wait`` or ``img.save`` never flag.
_CKPT_METHODS = {"save", "restore", "wait", "wait_until_finished",
                 "load_latest"}
_CKPT_RECEIVER_RE = re.compile(
    r"ckpt|checkpoint|mngr|(^|\.|_)mgr$|(^|\.|_)manager$|orbax|(^|\.)ocp\.",
    re.I,
)

# -- divergence classification ------------------------------------------------

# Calls whose result differs per host. process_count()/device_count()
# are deliberately absent: they are uniform across the fleet.
_RANK_CALL_TAILS = {"process_index", "is_main_process", "getpid",
                    "gethostname", "get_rank", "get_local_rank",
                    "get_node_local_rank", "get_coordinate"}
# Names/attribute tails that hold a per-host identity when they appear
# inside a branch condition.
_RANK_NAME_TAILS = {"is_main", "is_main_process", "process_index", "rank",
                    "local_rank", "process_id", "host_id"}
# Per-host filesystem probes.
_FS_CALL_TAILS = {"exists", "isfile", "isdir", "is_file", "is_dir",
                  "stat", "getsize", "listdir", "glob", "iterdir"}
# Per-host environment reads.
_ENV_CALL_TAILS = {"getenv", "env_override", "get_env"}
# Wall clocks.
_CLOCK_DOTTED = {
    "time.time", "time.monotonic", "time.perf_counter", "time.process_time",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
}


def _collective_desc(node: ast.Call, class_name: Optional[str]
                     ) -> Optional[str]:
    """Dotted description when ``node`` is a host-level collective."""
    d = dotted_name(node.func) or ""
    t = tail_name(node.func)
    if t in _MULTIHOST_TAILS or "multihost_utils." in d:
        return d or t
    if t in _DIST_TAILS:
        return d or t
    if isinstance(node.func, ast.Attribute):
        recv = dotted_name(node.func.value) or ""
        if node.func.attr in _TORCH_COLLECTIVES and \
                _TORCH_DIST_RECEIVER_RE.search(recv):
            return d
        if node.func.attr in _DCP_CALLS and (
                recv == "dcp" or recv.endswith("distributed.checkpoint")):
            return d
        if node.func.attr in _BUS_METHODS:
            if _BUS_RECEIVER_RE.search(recv):
                return d
            if recv == "self" and class_name and class_name.endswith("Bus"):
                return d
        if node.func.attr in _CKPT_METHODS and _CKPT_RECEIVER_RE.search(recv):
            return d
    return None


def _divergence_kind(expr: ast.AST) -> Optional[Tuple[str, str]]:
    """(kind, what) when ``expr`` depends on host-divergent state; kind
    is 'rank' (ST601) or 'hostlocal' (ST603)."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            d = dotted_name(node.func) or ""
            t = tail_name(node.func)
            if t in _RANK_CALL_TAILS:
                return ("rank", f"{d or t}()")
            if t in _FS_CALL_TAILS or d.startswith("os.path."):
                return ("hostlocal", f"{d or t}()")
            if t in _ENV_CALL_TAILS:
                return ("hostlocal", f"{d or t}()")
            if d in _CLOCK_DOTTED or d.startswith("time."):
                return ("hostlocal", f"{d}()")
        elif isinstance(node, ast.Attribute):
            if node.attr in _RANK_NAME_TAILS:
                return ("rank", dotted_name(node) or node.attr)
        elif isinstance(node, ast.Name):
            if node.id in _RANK_NAME_TAILS:
                return ("rank", node.id)
        elif isinstance(node, ast.Subscript):
            base = dotted_name(node.value) or ""
            if base.endswith("os.environ") or base == "environ":
                return ("hostlocal", f"{base}[...]")
    return None


def _condition_src(test: ast.AST) -> str:
    try:
        src = ast.unparse(test)
    except Exception:  # pragma: no cover — unparse covers all exprs we see
        src = "<condition>"
    return src if len(src) <= 60 else src[:57] + "..."


def _always_exits(body: List[ast.stmt]) -> bool:
    """True when every path through ``body`` leaves the enclosing scope
    or loop iteration (return/raise/continue/break at top level)."""
    return any(
        isinstance(s, (ast.Return, ast.Raise, ast.Continue, ast.Break))
        for s in body
    )


# -- the pass -----------------------------------------------------------------

def run(index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for ms in index.scopes.values():
        findings.extend(_check_module(ms))
    return findings


def _check_module(ms: ModuleScopes) -> List[Finding]:
    out: List[Finding] = []
    # class context for each function (for the self-inside-*Bus rule)
    class_of = {}
    for node in ast.walk(ms.sm.tree):
        if isinstance(node, ast.ClassDef):
            for child in ast.walk(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    class_of.setdefault(child, node.name)
    for node in ast.walk(ms.sm.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _walk_body(ms, node.body, [], class_of.get(node), out)
    return out


# guard: (kind, description) — kind in {'rank', 'hostlocal', 'except'}
Guard = Tuple[str, str]


def _walk_body(
    ms: ModuleScopes,
    body: List[ast.stmt],
    guards: List[Guard],
    class_name: Optional[str],
    out: List[Finding],
) -> None:
    guards = list(guards)
    for stmt in body:
        # nested defs get their own walk (fresh guard context: they may
        # be called from anywhere, so outer guards don't transfer)
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        _check_calls(ms, stmt, guards, class_name, out)
        if isinstance(stmt, ast.If):
            div = _divergence_kind(stmt.test)
            inner = guards + [_as_guard(div, stmt.test)] if div else guards
            _walk_body(ms, stmt.body, inner, class_name, out)
            _walk_body(ms, stmt.orelse, inner, class_name, out)
            # `if <divergent>: return` — the REST of this body runs only
            # on the complement host set, which is just as one-sided.
            if div and _always_exits(stmt.body) and not stmt.orelse:
                guards = guards + [_as_guard(div, stmt.test, complement=True)]
        elif isinstance(stmt, ast.While):
            div = _divergence_kind(stmt.test)
            inner = guards + [_as_guard(div, stmt.test)] if div else guards
            _walk_body(ms, stmt.body, inner, class_name, out)
            _walk_body(ms, stmt.orelse, inner, class_name, out)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            _walk_body(ms, stmt.body, guards, class_name, out)
            _walk_body(ms, stmt.orelse, guards, class_name, out)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            _walk_body(ms, stmt.body, guards, class_name, out)
        elif isinstance(stmt, ast.Try):
            _walk_body(ms, stmt.body, guards, class_name, out)
            for handler in stmt.handlers:
                _walk_body(
                    ms, handler.body,
                    guards + [("except", _handler_desc(handler))],
                    class_name, out,
                )
            _walk_body(ms, stmt.orelse, guards, class_name, out)
            _walk_body(ms, stmt.finalbody, guards, class_name, out)


def _as_guard(div: Optional[Tuple[str, str]], test: ast.AST,
              complement: bool = False) -> Guard:
    kind, what = div if div else ("rank", "<divergent>")
    cond = _condition_src(test)
    if complement:
        return (kind, f"the complement of `{cond}` (divergent early exit)")
    return (kind, f"`{cond}` (via {what})")


def _handler_desc(handler: ast.ExceptHandler) -> str:
    if handler.type is None:
        return "bare `except:`"
    return f"`except {_condition_src(handler.type)}`"


def _check_calls(
    ms: ModuleScopes,
    stmt: ast.stmt,
    guards: List[Guard],
    class_name: Optional[str],
    out: List[Finding],
) -> None:
    if not guards:
        return
    # Only this statement's own expressions — compound bodies are walked
    # with their own guard context.
    headers: List[ast.AST]
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
        for node in _walk_pruned(header):
            if not isinstance(node, ast.Call):
                continue
            desc = _collective_desc(node, class_name)
            if desc is None:
                continue
            out.append(_finding_for(ms, node, desc, guards))


def _walk_pruned(root: ast.AST):
    """``ast.walk`` that does NOT descend into nested lambdas/defs:
    defining a callback under a divergent guard is not executing a
    collective there (ast.walk alone would still yield the lambda
    body's calls — its children are queued before the skip)."""
    stack = [root]
    while stack:
        node = stack.pop()
        if node is not root and isinstance(
            node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _finding_for(
    ms: ModuleScopes, node: ast.AST, desc: str, guards: List[Guard]
) -> Finding:
    kinds = [g[0] for g in guards]
    if "rank" in kinds:
        g = guards[kinds.index("rank")]
        return Finding(
            file=ms.sm.rel, line=getattr(node, "lineno", 1), code="ST601",
            severity="error",
            message=(
                f"host-level collective `{desc}` is reachable only under "
                f"the rank-divergent condition {g[1]} — hosts that skip it "
                "leave peers blocked inside the collective (fleet "
                "deadlock); enter it on every host, or make the decision "
                "collective first (DecisionBus)"
            ),
        )
    if "except" in kinds:
        g = guards[kinds.index("except")]
        return Finding(
            file=ms.sm.rel, line=getattr(node, "lineno", 1), code="ST602",
            severity="warning",
            message=(
                f"host-level collective `{desc}` runs inside {g[1]} — "
                "exceptions are host-local, so this host re-enters a "
                "collective its peers never reach; gather the per-host "
                "outcomes first and retry in lockstep (the "
                "utils/checkpoint.py coordinated-retry pattern)"
            ),
        )
    g = guards[kinds.index("hostlocal")]
    return Finding(
        file=ms.sm.rel, line=getattr(node, "lineno", 1), code="ST603",
        severity="warning",
        message=(
            f"host-level collective `{desc}` is guarded by per-host state "
            f"{g[1]} — filesystem/env/clock reads may disagree across "
            "hosts (one host skips, peers block); agree on the value over "
            "the bus before branching"
        ),
    )
