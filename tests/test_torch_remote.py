"""PyTorch port, the replica wire on the CPU: ``ReplicaServer`` and
``RemoteEngineWorker`` over loopback, replica processes of the port's own
entry (``python -m scaletorch_tpu_torch.replica --device cpu``), and the
warm rejoin, against the reference's wire and its fake replica.

* The port's ``ReplicaServer`` over the port's engine and the reference's
  over the JAX engine (the same tiny Llama weights, carried with
  ``models/convert.py``; fp32, greedy) answer the same submits through
  the port's ``RemoteEngineWorker`` with the same tokens, outcomes and
  ``done`` payloads, and the port's tokens equal the port's engine
  driven directly (tolerance 0: tokens are integers; a port/JAX
  difference is accepted only at a top-2 JAX logit margin below 1e-4).
* The warm wire: frame 0 of ``/warm`` is byte for byte the reference's
  for the same pool (the wire carries the reference's dtype names), the
  ``/prefix_map`` chains and hashes equal; a pull warms a fresh engine
  whose first shared-prefix request is a prefix hit with the donor's
  tokens; a corrupted chunk is dropped and the valid prefix imported;
  a donor process that SIGKILLs itself mid-transfer falls through to the
  next peer; every allocator stays conserved.
* Replica processes: a SIGKILL mid-stream ends the stream in exactly one
  ``aborted`` terminal and the poller marks the replica dead; SIGTERM
  and ``POST /v1/drain`` exit 0; the reference's fake replica speaks the
  same wire to the port's ``RemoteEngineWorker``.

Every wait is on an event or a bounded poll; ports are ephemeral.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.inference import InferenceEngine as JaxEngine
from scaletorch_tpu.inference import SamplingParams as JaxSampling
from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.serving.gateway import EngineWorker as JaxWorker
from scaletorch_tpu.serving.remote import ReplicaServer as JaxServer
from scaletorch_tpu_torch.inference import (
    InferenceEngine,
    SamplingParams,
    ServingFaultInjector,
)
from scaletorch_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from scaletorch_tpu_torch.serving import protocol
from scaletorch_tpu_torch.serving.gateway import EngineWorker
from scaletorch_tpu_torch.serving.protocol import GenerateRequest
from scaletorch_tpu_torch.serving.remote import (
    RemoteEngineWorker,
    ReplicaServer,
    pull_warm_state,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAKE_REPLICA = os.path.join(REPO, "tests", "serving", "fake_replica.py")
KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
ENGINE = dict(max_slots=2, max_seq=32, prefill_len=16, cache_layout="paged",
              page_size=4, strict_submit=False)
# the replica entry's flags for the same engine (its tiny preset is KW,
# drawn from a seeded torch.Generator)
REPLICA_FLAGS = ["--device", "cpu", "--max_slots", "2", "--max_seq", "32",
                 "--prefill_len", "16", "--page_size", "4"]
CHAIN = [7, 7, 7, 7, 3, 3, 3, 3]  # two full pages
MARGIN = 1e-4
CEILING_S = 60.0


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig(**KW, dtype=jnp.float32)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = LlamaConfig(**KW, dtype=torch.float32)
    model = LlamaForCausalLM.from_params(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    return jcfg, params, tcfg, model


def torch_engine(models, **kw):
    return InferenceEngine(models[3], models[2],
                           sampling=SamplingParams(temperature=0.0),
                           device="cpu", **{**ENGINE, **kw})


def jax_engine(models, **kw):
    return JaxEngine(models[1], models[0],
                     sampling=JaxSampling(temperature=0.0),
                     **{**ENGINE, **kw})


class ServerThread:
    """A ``ReplicaServer`` on its own event-loop thread."""

    def __init__(self, server_cls, worker, injector=None):
        self.server_cls, self.worker, self.injector = (server_cls, worker,
                                                       injector)
        self.server = None
        self._loop = None
        self._started = threading.Event()
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self._main()), daemon=True)

    async def _main(self):
        self._loop = asyncio.get_running_loop()
        self.server = self.server_cls(self.worker, port=0,
                                      injector=self.injector)
        await self.server.start()
        self._started.set()
        await self.server.wait_drain()
        await self.server.close()

    @property
    def port(self):
        return self.server.port

    def __enter__(self):
        self._thread.start()
        assert self._started.wait(CEILING_S), "replica server never bound"
        return self

    def __exit__(self, *exc):
        self._loop.call_soon_threadsafe(self.server.request_drain)
        self._thread.join(CEILING_S)
        self.worker.shutdown(drain=True)
        self.worker.join(CEILING_S)


def run_request(remote, req):
    done = threading.Event()
    out = {"tokens": [], "result": None, "submitted": None}
    remote.submit(
        req, lambda rid, toks: out["tokens"].extend(toks),
        lambda res: (out.__setitem__("result", res), done.set()),
        ttl_s=req.ttl_s,
        on_submitted=lambda rid: out.__setitem__("submitted", rid))
    assert done.wait(CEILING_S), "no terminal result"
    return out


def wait_until(predicate, what):
    deadline = time.monotonic() + CEILING_S
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def raw_submit(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/submit",
        data=json.dumps(body).encode(), method="POST")
    return urllib.request.urlopen(req, timeout=CEILING_S).read()


def top2_margin(models, tokens):
    logits = np.asarray(jllama.forward(
        models[1], jnp.asarray([tokens], jnp.int32), models[0]))[0, -1]
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


REQUESTS = [([1, 2, 3], 6), ([7, 8, 9, 10], 5), (CHAIN + [2], 4)]


def test_wire_matches_the_reference(models):
    sides = {}
    for name, (server_cls, worker_cls, make) in {
            "port": (ReplicaServer, EngineWorker, torch_engine),
            "reference": (JaxServer, JaxWorker, jax_engine)}.items():
        engine = make(models)
        with ServerThread(server_cls,
                          worker_cls(engine, replica_id="r0").start()) as st:
            # the test's own ceiling: the reference replica's first
            # request waits on its engine's first JAX compile, which under
            # a loaded test run outlasts the 10 s default
            remote = RemoteEngineWorker("127.0.0.1", st.port,
                                        replica_id="r0",
                                        connect_timeout_s=CEILING_S).start()
            try:
                outs = [run_request(remote, GenerateRequest(
                    prompt=p, max_new_tokens=n, trace_id="ab" * 16))
                    for p, n in REQUESTS]
                raw = raw_submit(st.port, {"prompt": [5, 6],
                                           "max_new_tokens": 3})
                health = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{st.port}/healthz").read())
                pmap = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{st.port}/prefix_map").read())
                pages = [p for c in pmap["chains"] for p in c["pages"]]
                req = urllib.request.Request(
                    f"http://127.0.0.1:{st.port}/warm",
                    data=json.dumps({"pages": pages}).encode(),
                    method="POST")
                resp = urllib.request.urlopen(req, timeout=CEILING_S)
                frames = []
                while (frame := protocol.read_warm_frame(resp)) is not None:
                    frames.append(frame)
                    if frame[0] == protocol.WARM_END_INDEX:
                        break
            finally:
                remote.stop_polling()
            if name == "port":
                assert engine.decode_compile_count == 1
                engine.allocator.check_conservation()
        sides[name] = (outs, raw, health, pmap, frames)
    ours, theirs = sides["port"], sides["reference"]
    for (prompt, n), mine, ref in zip(REQUESTS, ours[0], theirs[0]):
        assert mine["tokens"] == mine["result"].tokens
        assert mine["result"].outcome == ref["result"].outcome == "ok"
        assert mine["submitted"] == ref["submitted"]
        direct = torch_engine(models)
        rid = direct.submit(prompt, max_new_tokens=n)
        assert mine["tokens"] == direct.run()[rid].tokens
        if mine["tokens"] != ref["tokens"]:
            k = next(i for i, (a, b) in enumerate(
                zip(mine["tokens"], ref["tokens"])) if a != b)
            assert top2_margin(models, prompt + ref["tokens"][:k]) < MARGIN
    assert sorted(ours[2]) == sorted(theirs[2])
    for key in ("page_size", "inflight", "warm_pages", "prefix_pages",
                "alive", "draining"):
        assert ours[2][key] == theirs[2][key], key
    assert ours[3] == theirs[3]  # chains, page ids, hashes, dtype name
    # frame 0 (the pool's meta) byte for byte; page frames alike in
    # index, length and order (their K/V bytes are two frameworks' fp32)
    assert ours[4][0] == theirs[4][0]
    assert [(i, len(p), ok) for i, p, ok in ours[4]] == \
        [(i, len(p), ok) for i, p, ok in theirs[4]]
    if protocol.parse_sse_stream(ours[1]) != protocol.parse_sse_stream(
            theirs[1]):
        mine = [d for e, d in protocol.parse_sse_stream(ours[1])
                if e == "done"][0]
        ref = [d for e, d in protocol.parse_sse_stream(theirs[1])
               if e == "done"][0]
        assert {k for k in mine if k != "token_ids"} == \
            {k for k in ref if k != "token_ids"}


def warmed_donor(models, **kw):
    eng = torch_engine(models, **kw)
    eng.submit(CHAIN + [1], max_new_tokens=3)
    eng.run()
    return eng


def donor_address(port):
    return {"host": "127.0.0.1", "port": port, "replica": f"d{port}"}


@pytest.mark.parametrize("corrupt_chunk", [0, 2])
def test_warm_pull_and_a_corrupted_chunk(models, corrupt_chunk):
    donor = warmed_donor(models)
    injector = (ServingFaultInjector(gw_warm_corrupt_chunk_at=corrupt_chunk)
                if corrupt_chunk else None)
    recipient = torch_engine(models)
    worker = EngineWorker(recipient, replica_id="rx").start()
    try:
        with ServerThread(ReplicaServer,
                          EngineWorker(donor, replica_id="d").start(),
                          injector) as st:
            summary = pull_warm_state(worker, [donor_address(st.port)],
                                      backoff_s=0.01)
        if corrupt_chunk:
            # chunk 2 (the chain's second page) dropped: the first page
            # of the chain is imported, the rest stays cold
            assert summary["chunks_dropped"] == 1
            assert summary["pages"] == 1
            assert summary["chains"] == [CHAIN[:4]]
        else:
            assert summary["status"] == "warmed"
            assert summary["pages"] == 2 and summary["chains"] == [CHAIN]
        done = threading.Event()
        box = {}
        worker.submit(GenerateRequest(prompt=CHAIN + [2], max_new_tokens=4),
                      lambda rid, toks: None,
                      lambda res: (box.setdefault("r", res), done.set()))
        assert done.wait(CEILING_S)
    finally:
        worker.shutdown(drain=True)
        worker.join(CEILING_S)
    result = box["r"]
    assert result.outcome == "ok" and result.prefix_hit
    direct = warmed_donor(models)
    rid = direct.submit(CHAIN + [2], max_new_tokens=4)
    assert result.tokens == direct.run()[rid].tokens
    for eng in (donor, recipient):
        eng.allocator.check_conservation()
        assert eng.decode_compile_count == eng.prefill_compile_count == 1


def spawn(cmd):
    """A child speaking the wire; returns (proc, port) after READY."""
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    deadline = time.monotonic() + CEILING_S
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"child died before READY rc={proc.poll()}")
        if line.startswith("READY port="):
            return proc, int(line.strip().split("=")[1])
    raise RuntimeError("child never printed READY")


def port_replica(*extra):
    return spawn([sys.executable, "-m", "scaletorch_tpu_torch.replica",
                  *REPLICA_FLAGS, *extra])


@pytest.mark.parametrize("with_peer", [True, False],
                         ids=["next_peer", "only_donor"])
def test_donor_crash_falls_through_to_the_next_peer(with_peer):
    """The flaky donor corrupts chunk 1 and SIGKILLs itself right after
    it, so it delivers nothing usable: the pull takes the next peer, or
    without one rejoins cold."""
    flaky, port_a = port_replica("--ft_gw_warm_corrupt_chunk_at", "1",
                                 "--ft_gw_warm_donor_crash_at", "1")
    procs, donors = [flaky], [donor_address(port_a)]
    try:
        if with_peer:
            steady, port_b = port_replica()
            procs.append(steady)
            donors.append(donor_address(port_b))
        for donor in donors:
            raw_submit(donor["port"], {"prompt": CHAIN + [1],
                                       "max_new_tokens": 2})
        recipient = InferenceEngine(
            *_replica_model(), sampling=SamplingParams(temperature=0.0),
            device="cpu", **ENGINE)
        worker = EngineWorker(recipient, replica_id="rx").start()
        try:
            summary = pull_warm_state(worker, donors, attempts_per_donor=2,
                                      backoff_s=0.01)
        finally:
            worker.shutdown(drain=True)
            worker.join(CEILING_S)
        assert flaky.wait(CEILING_S) == -signal.SIGKILL
        if with_peer:
            assert summary["status"] == "warmed"
            assert summary["donor"] == donors[1]["replica"]
            assert summary["pages"] == 2
        else:
            assert summary["status"] == "cold" and summary["pages"] == 0
        assert recipient.metrics.warm_pages_total == summary["pages"]
        recipient.allocator.check_conservation()
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(CEILING_S)


def _replica_model():
    """The replica entry's tiny model (the same seeded draw)."""
    from scaletorch_tpu_torch.serve import build_model, parse_args

    cfg, model = build_model(parse_args(REPLICA_FLAGS))
    return model, cfg


@pytest.mark.parametrize("kind", ["port_replica", "reference_fake"])
def test_kill9_mid_stream_is_one_aborted(kind):
    if kind == "port_replica":
        proc, port = port_replica()
    else:
        proc, port = spawn([sys.executable, FAKE_REPLICA,
                            "--token_delay_s", "0.05"])
    remote = RemoteEngineWorker("127.0.0.1", port, replica_id="r0",
                                proc=proc, poll_interval_s=0.02).start()
    try:
        done = threading.Event()
        first = threading.Event()
        box = {"tokens": [], "results": []}

        def on_tokens(rid, toks):
            box["tokens"].extend(toks)
            first.set()

        def on_done(res):
            box["results"].append(res)
            done.set()

        remote.submit(GenerateRequest(prompt=[1, 2, 3], max_new_tokens=25),
                      on_tokens, on_done)
        assert first.wait(CEILING_S), "no first token"
        os.kill(proc.pid, signal.SIGKILL)
        assert done.wait(CEILING_S)
        wait_until(lambda: not remote.alive, "the poller's verdict")
        assert [r.outcome for r in box["results"]] == ["aborted"]
        assert proc.wait(CEILING_S) == -signal.SIGKILL
    finally:
        remote.stop_polling()
        if proc.poll() is None:
            proc.kill()


@pytest.mark.parametrize("how", ["sigterm", "post_drain"])
def test_replica_drains_to_exit_zero(how):
    proc, port = port_replica()
    try:
        out = []

        def client():
            try:
                out.append(raw_submit(port, {"prompt": [4, 5],
                                             "max_new_tokens": 20}))
            except OSError:
                pass  # the drain closed the socket before the submit

        t = threading.Thread(target=client)
        t.start()
        if how == "sigterm":
            proc.send_signal(signal.SIGTERM)
        else:
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/drain", data=b"{}",
                method="POST"), timeout=CEILING_S).read()
        t.join(CEILING_S)
        assert proc.wait(CEILING_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    # a request in flight (or refused at once) still got one terminal
    if out:
        dones = [d for e, d in protocol.parse_sse_stream(out[0])
                 if e == "done"]
        assert len(dones) == 1
