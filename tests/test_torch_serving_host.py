"""PyTorch port, the serving front door's host modules against the
reference's: ``serving/{protocol,admission,router,slo,supervisor}.py``
are copies of the JAX package's standard-library modules, so on shared
inputs they must give the reference's outputs and bytes exactly
(tolerance 0 throughout: hashes, frames, decisions and timings are
compared for equality, never within a bound).

* The copies are the reference's code: each module's syntax tree, with
  docstrings dropped and the package name mapped, equals the
  reference's (``slo.py`` adds only ``DEFAULT_SLO_PATH``).
* protocol: request parsing (valid bodies and every malformed one, the
  same error text), payloads, SSE bytes, traceparent handling, the warm
  frames (encode, corrupt, decode, read back) on seeded random bytes.
* router: page-aligned chunk hashes and rendezvous choices on a seeded
  grid of prompts and page sizes, a routed schedule with membership
  changes, headroom and learned owners, and the snapshot.
* admission: tenant specs, a seeded WFQ / token-bucket / shedding
  schedule on a fake clock, decision by decision.
* slo: the port's ``slo.json`` loads to the reference's
  ``tools/slo.json``; evaluation and the report on a grid.
* supervisor: scripted fake children through drain, the crash family,
  flapping and backoff, the two supervisors' state and restart counters
  equal; the seeded jitter sequence equal.
* ``config.ServingArguments``: the reference's fields, defaults and
  validation.
"""

import ast
import dataclasses
import io
import itertools
import json
import os
import random
import time

import numpy as np
import pytest

from scaletorch_tpu import config as jconfig
from scaletorch_tpu.serving import admission as jadmission
from scaletorch_tpu.serving import protocol as jprotocol
from scaletorch_tpu.serving import router as jrouter
from scaletorch_tpu.serving import slo as jslo
from scaletorch_tpu.serving import supervisor as jsupervisor
from scaletorch_tpu_torch import config as tconfig
from scaletorch_tpu_torch.serving import admission as tadmission
from scaletorch_tpu_torch.serving import protocol as tprotocol
from scaletorch_tpu_torch.serving import router as trouter
from scaletorch_tpu_torch.serving import slo as tslo
from scaletorch_tpu_torch.serving import supervisor as tsupervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ("protocol", "admission", "router", "slo", "supervisor")


# ---- the copies are the reference's code ---------------------------------
class _Normalize(ast.NodeTransformer):
    """Drop docstrings and map the port's package name to the
    reference's, so two copies of one module compare equal."""

    def _strip_doc(self, node):
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    def visit_Module(self, node):
        self.generic_visit(node)
        return self._strip_doc(node)

    visit_ClassDef = visit_FunctionDef = visit_AsyncFunctionDef = \
        visit_Module

    def visit_ImportFrom(self, node):
        if node.module:
            node.module = node.module.replace("scaletorch_tpu_torch",
                                              "scaletorch_tpu")
        return node


def _tree(path: str, drop=()) -> str:
    tree = _Normalize().visit(ast.parse(open(path).read()))
    tree.body = [n for n in tree.body
                 if not (isinstance(n, ast.Assign)
                         and any(getattr(t, "id", None) in drop
                                 for t in n.targets))
                 and not (isinstance(n, ast.Import)
                          and [a.name for a in n.names] == ["os"]
                          and "DEFAULT_SLO_PATH" in drop)]
    return ast.dump(tree)


@pytest.mark.parametrize("name", COPIES)
def test_each_copy_is_the_reference_code(name):
    drop = ("DEFAULT_SLO_PATH",) if name == "slo" else ()
    ours = _tree(os.path.join(REPO, "scaletorch_tpu_torch", "serving",
                              f"{name}.py"), drop)
    theirs = _tree(os.path.join(REPO, "scaletorch_tpu", "serving",
                                f"{name}.py"))
    assert ours == theirs


# ---- protocol -------------------------------------------------------------
BODIES = [
    {"prompt": [1, 2, 3]},
    {"prompt": [5], "max_new_tokens": 7, "eos_id": 2, "seed": 9,
     "ttl_s": 1.5, "stream": False, "tenant": "pro"},
    {"prompt": []},
    {"prompt": "abc"},
    {"prompt": [1, -1]},
    {"prompt": [1], "max_new_tokens": 0},
    {"prompt": [1], "max_new_tokens": "x"},
    {"prompt": [1], "ttl_s": -1},
    {"prompt": [1], "stream": "yes"},
    {"prompt": [1], "tenant": ""},
    {"prompt": [1], "tenant": "a" * 200},
    {"prompt": [1], "v": 2},
    {"max_new_tokens": 4},
    [1, 2],
]


def _parse(mod, body, header_tenant=None):
    raw = body if isinstance(body, bytes) else json.dumps(body).encode()
    try:
        return ("ok", dataclasses.asdict(mod.parse_generate_request(
            raw, header_tenant=header_tenant)))
    except mod.ProtocolError as exc:
        return ("error", str(exc), exc.status)


@pytest.mark.parametrize("body", BODIES + [b"not json", b"", b"\xff"],
                         ids=range(len(BODIES) + 3))
@pytest.mark.parametrize("header_tenant", [None, "hdr"])
def test_protocol_parses_like_the_reference(body, header_tenant):
    assert (_parse(tprotocol, body, header_tenant)
            == _parse(jprotocol, body, header_tenant))


def test_protocol_payload_and_frame_bytes():
    rng = np.random.default_rng(0)
    assert tprotocol.STATUS_BY_OUTCOME == jprotocol.STATUS_BY_OUTCOME
    assert tprotocol.PROTOCOL_VERSION == jprotocol.PROTOCOL_VERSION
    j, t = jprotocol, tprotocol
    for rid in (0, 7, 123456):
        toks = rng.integers(0, 151936, int(rng.integers(0, 9))).tolist()
        for outcome in j.STATUS_BY_OUTCOME:
            kw = dict(outcome=outcome, finish_reason="length",
                      token_ids=toks, prompt_tokens=4, detail="d",
                      trace_id="ab" * 16)
            assert (t.format_sse_event("done", t.result_payload(rid,
                                                               **kw))
                    == j.format_sse_event("done",
                                          j.result_payload(rid, **kw)))
        assert (t.format_sse_event("token", t.token_payload(rid, toks))
                == j.format_sse_event("token",
                                      j.token_payload(rid, toks)))
        assert (t.error_payload("x", outcome="shed", retry_after_s=2.5)
                == j.error_payload("x", outcome="shed",
                                   retry_after_s=2.5))
    raw = b"".join(j.format_sse_event(e, {"v": 1, "i": i})
                   for i, e in enumerate(["token", "done"]))
    assert t.parse_sse_stream(raw + b"noise\n") == \
        j.parse_sse_stream(raw + b"noise\n")
    # the warm frames, on seeded random page bytes
    for index in (0, 1, 5, j.WARM_END_INDEX):
        k = rng.bytes(int(rng.integers(0, 300)))
        v = rng.bytes(len(k))
        payload = t.encode_warm_page_payload(index % 97, k, v)
        assert payload == j.encode_warm_page_payload(index % 97, k, v)
        frame = t.encode_warm_frame(index, payload)
        assert frame == j.encode_warm_frame(index, payload)
        assert t.corrupt_warm_frame(frame) == j.corrupt_warm_frame(frame)
        for f in (frame, t.corrupt_warm_frame(frame), frame[:-1]):
            assert (t.read_warm_frame(io.BytesIO(f))
                    == j.read_warm_frame(io.BytesIO(f)))
        assert t.decode_warm_page_payload(payload) == \
            j.decode_warm_page_payload(payload)


TRACEPARENTS = [
    None, "", "garbage",
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    " 00-" + "ab" * 16 + "-" + "cd" * 8 + "-01 ",
    "01-" + "ab" * 16 + "-" + "cd" * 8 + "-01-extra",
    "00-" + "00" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "00" * 8 + "-01",
    "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "AB" * 16 + "-" + "cd" * 8 + "-01",
]


@pytest.mark.parametrize("header", TRACEPARENTS)
def test_protocol_traceparent_like_the_reference(header):
    assert tprotocol.parse_traceparent(header) == \
        jprotocol.parse_traceparent(header)
    parsed = jprotocol.parse_traceparent(header)
    if parsed:
        assert tprotocol.make_traceparent(*parsed) == \
            jprotocol.make_traceparent(*parsed)


# ---- router ---------------------------------------------------------------
@pytest.mark.parametrize("page_size", [1, 4, 16])
def test_router_hashes_and_rendezvous_like_the_reference(page_size):
    rng = np.random.default_rng(page_size)
    replicas = [f"r{i}" for i in range(5)]
    for _ in range(50):
        prompt = rng.integers(0, 151936, int(rng.integers(0, 70))).tolist()
        for cap in (None, 3):
            kw = {} if cap is None else {"max_chunks": cap}
            assert trouter.page_chunk_hashes(prompt, page_size, **kw) == \
                jrouter.page_chunk_hashes(prompt, page_size, **kw)
        key = str(prompt)
        assert trouter._rendezvous(key, replicas[:3]) == \
            jrouter._rendezvous(key, replicas[:3])
        weights = {r: float(rng.random()) for r in replicas}
        assert trouter._weighted_rendezvous(key, weights) == \
            jrouter._weighted_rendezvous(key, weights)


def _route_schedule(mod, seed: int):
    """A routed schedule with shared prefixes, learned owners, deaths,
    rejoins and headroom; returns every decision and the snapshots."""
    rng = random.Random(seed)
    router = mod.PrefixAwareRouter(["r0", "r1", "r2"], 4)
    prefixes = [[rng.randrange(64) for _ in range(8)] for _ in range(3)]
    out = []
    for step in range(60):
        prompt = rng.choice(prefixes) + [rng.randrange(64)
                                         for _ in range(rng.randrange(6))]
        headroom = ({r: rng.random() for r in router.replicas}
                    if step % 3 == 0 else None)
        try:
            out.append(router.route(prompt, headroom=headroom))
        except mod.NoReplicaAvailable as exc:
            out.append(("none", str(exc)))
        if step == 10:
            router.report_exit("r1", -9)
        if step == 20:
            router.rejoin("r1")
        if step == 30:
            router.report_exit("r2", 0)
        if step == 35:
            router.learn_owner(prefixes[0], "r0")
        if step == 40:
            router.mark_dead("r0", 44)
            router.mark_dead("r1", 43)
        out.append(router.snapshot())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_schedule_like_the_reference(seed):
    assert _route_schedule(trouter, seed) == _route_schedule(jrouter, seed)


def test_router_crash_family_is_the_reference():
    assert trouter.CRASH_EXIT_CODES == jrouter.CRASH_EXIT_CODES


# ---- admission ------------------------------------------------------------
SPECS = ["", "free:1:100:200,pro:4,batch:0.5", "a:2", "a:1:0",
         "a", "a:0", "a:1:-1", "a:1,a:2", ":1", "a:1:2:3:4", "a:x"]


def _spec(mod, spec):
    try:
        return ("ok", {k: dataclasses.asdict(v)
                       for k, v in mod.parse_tenant_spec(spec).items()})
    except ValueError as exc:
        return ("error", str(exc))


@pytest.mark.parametrize("spec", SPECS)
def test_admission_tenant_spec_like_the_reference(spec):
    assert _spec(tadmission, spec) == _spec(jadmission, spec)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _admission_schedule(mod, seed: int):
    rng = random.Random(seed)
    clock = _Clock()
    gauges = {"pages_in_use": 10.0, "page_pool_free": 90.0,
              "queue_depth": 0.0, "num_slots": 4.0}
    shed_by_callback = []
    ctl = mod.AdmissionController(
        gauges_fn=lambda: dict(gauges),
        tenants=mod.parse_tenant_spec("free:1:50:100,pro:4,batch:0.5"),
        max_backlog=12, free_page_watermark=0.2,
        on_shed=lambda item, d: shed_by_callback.append(
            (item, d.outcome, d.reason)),
        clock=clock)
    out = []
    n = itertools.count()
    for _ in range(300):
        clock.t += rng.random() * 0.05
        op = rng.random()
        if op < 0.55:
            tenant = rng.choice(["free", "pro", "batch", "storm", "x"])
            item = next(n)
            d = ctl.offer(tenant, item, float(rng.randrange(1, 40)))
            out.append(("offer", tenant, item, None if d is None else
                        (d.outcome, d.reason, d.retry_after_s)))
        elif op < 0.85:
            out.append(("next", ctl.next_ready()))
        elif op < 0.9:
            gauges["queue_depth"] = float(rng.randrange(0, 6))
        elif op < 0.95:
            gauges["page_pool_free"] = float(rng.randrange(0, 100))
        else:
            out.append(("hint", ctl.retry_after_hint()))
        out.append((ctl.depths(), ctl.shed_count,
                    dict(ctl.shed_by_tenant)))
    out.append(("drain", ctl.queue.drain_all(), shed_by_callback))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_admission_schedule_like_the_reference(seed):
    assert _admission_schedule(tadmission, seed) == \
        _admission_schedule(jadmission, seed)


# ---- slo ------------------------------------------------------------------
def test_slo_file_is_the_reference_file():
    ours = tslo.load_slo(tslo.DEFAULT_SLO_PATH)
    theirs = jslo.load_slo(os.path.join(REPO, "tools", "slo.json"))
    assert ours == theirs
    for preset in theirs["presets"]:
        assert tslo.preset_targets(ours, preset) == \
            jslo.preset_targets(theirs, preset)


def _slo(mod, spec, quantiles, outcomes):
    def qfn(metric, q):
        return quantiles.get((metric, q))
    try:
        result = mod.evaluate_slo(spec, quantile_fn=qfn, outcomes=outcomes)
    except ValueError as exc:
        return ("error", str(exc))
    return result, mod.format_report("p", result)


@pytest.mark.parametrize("seed", range(6))
def test_slo_evaluation_like_the_reference(seed):
    rng = random.Random(seed)
    spec = {"min_requests": rng.choice([1, 10, 100]),
            "error_budget": rng.choice([0.0, 0.01, 0.5]),
            "targets": {"ttft_p95_s": 1.0, "tpot_p99_s": 0.05,
                        "e2e_p99_9_s": 30.0, "queue_wait_p50_s": 0.5}}
    quantiles = {(m, q): rng.choice([None, rng.random() * 2])
                 for m, q in (("ttft", 0.95), ("tpot", 0.99),
                              ("e2e", 0.999), ("queue_wait", 0.5))}
    outcomes = {o: rng.randrange(0, 40) for o in
                ("ok", "timeout", "shed", "rejected", "quarantined",
                 "aborted")}
    assert _slo(tslo, spec, quantiles, outcomes) == \
        _slo(jslo, spec, quantiles, outcomes)
    for key in ("ttft_p95_s", "e2e_p99_9_s", "bad", "ttft_p100_s"):
        got = []
        for mod in (tslo, jslo):
            try:
                got.append(mod.parse_target_key(key))
            except ValueError as exc:
                got.append(str(exc))
        assert got[0] == got[1]


# ---- supervisor -----------------------------------------------------------
class _Stdout:
    def __init__(self, lines):
        self._lines = list(lines)

    def readline(self):
        return self._lines.pop(0) if self._lines else ""

    def __iter__(self):
        return iter(())


class _Proc:
    """A scripted Popen double: exits with the code it is told."""

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode = None
        self.stdout = _Stdout([f"READY port={7000 + pid}\n"])

    def exit(self, code):
        self.returncode = code

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        if self.returncode is None:
            self.returncode = 0
        return self.returncode

    def terminate(self):
        self.exit(0)

    def kill(self):
        if self.returncode is None:
            self.returncode = -9


def _wait(predicate, what: str, ceiling: float = 10.0):
    deadline = time.monotonic() + ceiling
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def _status(sup):
    return {rid: {k: v for k, v in st.items() if k not in ("pid", "port",
                                                           "uptime_s")}
            for rid, st in sup.status().items()}


def _supervise(mod, code_schedule):
    """Drive one supervisor through scripted exits; returns the states
    and counters after each step, the exit callbacks and the restarts."""
    procs = {"r0": [], "r1": []}
    pids = itertools.count(1)

    def spawn(rid):
        procs[rid].append(_Proc(next(pids)))
        return procs[rid][-1]

    exits, restarts = [], []
    sup = mod.ReplicaSupervisor(
        spawn, ["r0", "r1"], on_exit=lambda r, c: exits.append((r, c)),
        on_restart=lambda r, w: restarts.append(r), poll_interval_s=0.005,
        backoff_base_s=0.01, backoff_max_s=0.04, backoff_jitter=0.0,
        flap_window_s=60.0, flap_max_restarts=3, ready_timeout_s=5.0,
        rng=random.Random(0))
    sup.start()
    trail = [_status(sup)]
    try:
        for rid, code in code_schedule:
            before = len(procs[rid])
            procs[rid][-1].exit(code)
            _wait(lambda: any(e == (rid, code) for e in exits[-1:]),
                  f"{rid} exit {code}")
            state = sup.replica_status(rid)["state"]
            if state not in ("drained", "failed"):
                _wait(lambda: len(procs[rid]) > before
                      and sup.replica_status(rid)["state"] == "up",
                      f"{rid} restarted")
            trail.append(_status(sup))
    finally:
        sup.stop(drain=False)
    return trail, exits, restarts, {r: len(p) for r, p in procs.items()}


@pytest.mark.parametrize("schedule", [
    [("r0", 0)],
    [("r0", -9), ("r1", 44), ("r0", 42)],
    [("r1", 43), ("r1", 1), ("r1", -9)],
    [("r0", 44), ("r0", 0)],
], ids=["drain", "crash_family", "flapping", "crash_then_drain"])
def test_supervisor_contract_like_the_reference(schedule):
    assert _supervise(tsupervisor, schedule) == \
        _supervise(jsupervisor, schedule)


def test_supervisor_backoff_and_jitter_like_the_reference():
    got = []
    for mod in (tsupervisor, jsupervisor):
        sup = mod.ReplicaSupervisor(
            lambda rid: _Proc(1), ["r0"], backoff_base_s=0.5,
            backoff_max_s=8.0, backoff_jitter=0.5, rng=random.Random(7))
        got.append([sup._backoff_s(n) for n in range(1, 12)])
    assert got[0] == got[1]
    assert tsupervisor.READY_PREFIX == jsupervisor.READY_PREFIX
    assert tsupervisor.STATES == jsupervisor.STATES


# ---- config.ServingArguments ---------------------------------------------
def test_serving_arguments_are_the_reference_fields():
    ours = dataclasses.fields(tconfig.ServingArguments)
    theirs = dataclasses.fields(jconfig.ServingArguments)
    assert [(f.name, f.default) for f in ours] == \
        [(f.name, f.default) for f in theirs]
    assert {f.name for f in theirs} <= {
        f.name for f in dataclasses.fields(tconfig.ScaleTorchTPUArguments)}


@pytest.mark.parametrize("bad", [
    dict(serve_port=-1), dict(serve_default_weight=0),
    dict(serve_max_backlog=0), dict(serve_free_page_watermark=1.0),
    dict(serve_default_ttl_s=-1), dict(serve_replicas=0),
    dict(serve_tenants="a:0"), dict(serve_disagg="1:2:3"),
    dict(serve_slo_path="/nonexistent/slo.json"),
])
def test_serving_arguments_validate_like_the_reference(bad):
    msgs = []
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError) as err:
            mod.ServingArguments(**bad)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
