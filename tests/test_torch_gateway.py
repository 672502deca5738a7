"""PyTorch port, the serving gateway on the CPU against the reference's:
the port's ``ServingGateway`` over the port's ``InferenceEngine`` and
the reference's ``ServingGateway`` over the JAX engine, the same tiny
Llama weights carried across with ``models/convert.py`` (fp32, greedy,
paged), serve the same requests over real HTTP.

* SSE streams and unary bodies: every event and every ``done`` payload
  equal, the trace ids left out (they are random); the port's streamed
  tokens equal the port's engine driven directly, bit for bit
  (tolerance 0: tokens are integers). A token where the port and the
  JAX package differ is accepted only where the JAX logits' top-2 margin
  is below 1e-4 (fp32 on two frameworks), and the test checks it.
* One capture of each step (``decode_compile_count ==
  prefill_compile_count == 1``) with the gateway attached.
* ``/metrics``: the same family names, types and label sets;
  ``/healthz``: the same keys.
* Conservation (``http_requests_received == sum(outcomes)``, the engine's
  own ledger and the page allocator) under a tenant storm, a deadline
  storm and a mid-stream disconnect, on both gateways; the disconnect
  aborts the request and releases its pages (read on the engine's worker
  thread, which owns the engine).

Every wait is on an event or a bounded poll of a counter; ports are
ephemeral.
"""

import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.inference import InferenceEngine as JaxEngine
from scaletorch_tpu.inference import SamplingParams as JaxSampling
from scaletorch_tpu.inference import ServingFaultInjector as JaxInjector
from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.serving.gateway import ServingGateway as JaxGateway
from scaletorch_tpu_torch.inference import (
    InferenceEngine,
    SamplingParams,
    ServingFaultInjector,
)
from scaletorch_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from scaletorch_tpu_torch.serving.gateway import ServingGateway
from scaletorch_tpu_torch.serving.protocol import (
    STATUS_BY_OUTCOME,
    parse_sse_stream,
    stream_tokens,
)
from tests.test_torch_one_thread import one_torch_thread  # noqa: F401


KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
ENGINE = dict(max_slots=2, max_seq=32, prefill_len=16, cache_layout="paged",
              page_size=4, strict_submit=False)
MARGIN = 1e-4
CEILING_S = 60.0
REQUESTS = [([1, 2, 3], 6, True), ([7, 8, 9, 10], 5, True),
            ([4, 4, 4], 4, False), ([1, 2, 3, 4, 5, 6], 6, True),
            ([1, 2, 3, 4, 9], 3, False), ([11], 1, True)]


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


SIDES = {"port": (ServingGateway, torch_engine, ServingFaultInjector),
         "reference": (JaxGateway, jax_engine, JaxInjector)}


def post(port, body, *, timeout=CEILING_S):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(), method="POST")
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
        return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def get(port, path):
    try:
        resp = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                      timeout=CEILING_S)
        return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def wait_until(predicate, what):
    deadline = time.monotonic() + CEILING_S
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def untraced(events):
    return [(e, {k: v for k, v in d.items() if k != "trace_id"})
            for e, d in events]


def top2_margin(models, tokens):
    jcfg, params = models[0], models[1]
    logits = np.asarray(jllama.forward(
        params, jnp.asarray([tokens], jnp.int32), jcfg))[0, -1]
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


def serve_requests(side, models):
    gateway_cls, make, _ = SIDES[side]
    engine = make(models)
    gw = gateway_cls(engine, port=0).start_in_thread()
    replies = []
    try:
        for prompt, n, stream in REQUESTS:
            status, _, raw = post(gw.port, {"prompt": prompt,
                                            "max_new_tokens": n,
                                            "stream": stream})
            body = (untraced(parse_sse_stream(raw)) if stream else
                    {k: v for k, v in json.loads(raw).items()
                     if k != "trace_id"})
            replies.append((status, body))
        compiles = (engine.decode_compile_count,
                    engine.prefill_compile_count)
    finally:
        gw.stop_sync()
    gw.metrics.check_conservation()
    return replies, compiles, engine


def done_tokens(reply):
    status, body = reply
    if isinstance(body, dict):
        return body["token_ids"]
    return [d for e, d in body if e == "done"][0]["token_ids"]


def test_sse_and_unary_replies_match_the_reference(models):
    ours, compiles, engine = serve_requests("port", models)
    theirs, _, _ = serve_requests("reference", models)
    assert compiles == (1, 1)
    engine.allocator.check_conservation()
    for (prompt, n, stream), mine, ref in zip(REQUESTS, ours, theirs):
        assert mine[0] == ref[0] == 200
        tokens = done_tokens(mine)
        if stream:
            events = mine[1]
            assert [e for e, _ in events].count("done") == 1
            assert events[-1][0] == "done"
            assert stream_tokens(events) == tokens
        # the port's gateway == the port's engine driven directly
        direct = torch_engine(models)
        rid = direct.submit(prompt, max_new_tokens=n)
        assert tokens == direct.run()[rid].tokens
        if mine == ref:
            continue
        # a port/JAX divergence only at a near-tie of the JAX logits
        ref_tokens = done_tokens(ref)
        k = next(i for i, (a, b) in enumerate(zip(tokens, ref_tokens))
                 if a != b)
        assert top2_margin(models, prompt + ref_tokens[:k]) < MARGIN


def families(text):
    """{family: (type, sorted label-key sets of its samples)} of a
    Prometheus exposition."""
    types = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
    labels = {name: set() for name in types}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([^{\s]+)(?:\{(.*)\})?\s", line)
        name, raw = m.group(1), m.group(2) or ""
        family = next((f for f in (name, re.sub(r"_(bucket|sum|count)$",
                                                "", name)) if f in types),
                      name)
        keys = tuple(sorted(re.findall(r'(\w+)="', raw)))
        labels.setdefault(family, set()).add(keys)
    return {n: (types.get(n), sorted(labels[n])) for n in labels}


def scrape(side, models):
    gateway_cls, make, _ = SIDES[side]
    gw = gateway_cls({"r0": make(models), "r1": make(models)},
                     port=0).start_in_thread()
    try:
        for prompt, n, stream in REQUESTS[:3]:
            post(gw.port, {"prompt": prompt, "max_new_tokens": n,
                           "stream": stream, "tenant": "t1"})
        status, metrics = get(gw.port, "/metrics")
        assert status == 200
        status, health = get(gw.port, "/healthz")
        assert status == 200
    finally:
        gw.stop_sync()
    health = json.loads(health)
    return (families(metrics.decode()), sorted(health),
            {rid: sorted(r) for rid, r in health["replicas"].items()})


def test_metrics_and_healthz_match_the_reference(models):
    ours, theirs = scrape("port", models), scrape("reference", models)
    assert ours == theirs


def sse_disconnect_after_first_token(port, body):
    """A raw-socket SSE client that walks away mid-stream."""
    payload = json.dumps(body).encode()
    sock = socket.create_connection(("127.0.0.1", port), timeout=CEILING_S)
    try:
        sock.sendall(
            b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
            + f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
        got = b""
        while b"event: token" not in got:
            chunk = sock.recv(4096)
            if not chunk:
                raise AssertionError(f"stream closed early: {got!r}")
            got += chunk
    finally:
        sock.close()


@pytest.mark.parametrize("side", ["port", "reference"])
def test_disconnect_aborts_and_releases_pages(side, models):
    gateway_cls, make, _ = SIDES[side]
    engine = make(models, max_slots=1)
    gw = gateway_cls(engine, port=0).start_in_thread()
    try:
        sse_disconnect_after_first_token(
            gw.port, {"prompt": [1, 2, 3, 4, 5], "max_new_tokens": 25,
                      "stream": True})
        wait_until(lambda: gw.metrics.outcomes["aborted"] == 1
                   and engine.metrics.outcomes["aborted"] == 1,
                   "the disconnect's abort")

        def pages_after_the_abort(eng):
            eng.allocator.check_conservation()
            return dict(eng.allocator._ref)

        # the engine is the worker thread's: read its pages there, after
        # the cancel (the engine counts the abort before it releases the
        # slot's pages, so a read from this thread could fall between)
        refs = gw.workers["r0"].call_engine(pages_after_the_abort,
                                            timeout_s=CEILING_S)
        # only the radix tree's own reference remains on any page
        assert all(c == 1 for c in refs.values())
        status, _, _ = post(gw.port, {"prompt": [9, 9],
                                      "max_new_tokens": 2,
                                      "stream": False})
        assert status == 200
    finally:
        gw.stop_sync()
    gw.metrics.check_conservation()


@pytest.mark.parametrize("side", ["port", "reference"])
def test_tenant_storm_keeps_conservation(side, models):
    gateway_cls, make, injector_cls = SIDES[side]
    engine = make(models)
    gw = gateway_cls(engine, port=0, max_backlog=4,
                     injector=injector_cls(gw_tenant_storm_at=1,
                                           gw_tenant_storm_count=6),
                     ).start_in_thread()
    try:
        for i in range(3):
            status, _, raw = post(gw.port, {
                "prompt": [2 + i, 3], "max_new_tokens": 2,
                "tenant": "victim", "stream": False})
            assert status == 200, raw
        wait_until(lambda: sum(gw.metrics.storm_outcomes.values()) == 6,
                   "every storm request's terminal")
    finally:
        gw.stop_sync()
    assert gw.metrics.injected_storm_requests == 6
    assert gw.metrics.storm_outcomes["shed"] > 0
    gw.metrics.check_conservation()
    assert sum(engine.metrics.outcomes.values()) == \
        engine.metrics.requests_submitted
    engine.allocator.check_conservation()


@pytest.mark.parametrize("side", ["port", "reference"])
def test_deadline_storm_and_disconnects_keep_conservation(side, models):
    """Concurrent clients (streamed, unary, walk-away) while the
    engine's deadline storm expires everything in flight at its third
    tick: every HTTP request has exactly one terminal."""
    gateway_cls, make, injector_cls = SIDES[side]
    engine = make(models, injector=injector_cls(deadline_storm_at_step=3))
    gw = gateway_cls(engine, port=0, max_backlog=3).start_in_thread()
    statuses, lock = [], threading.Lock()

    def client(i):
        body = {"prompt": [1 + i % 8, 2, 3], "max_new_tokens": 4 + i % 3,
                "tenant": ("flood", "quiet")[i % 2]}
        if i % 5 == 4:
            try:
                sse_disconnect_after_first_token(
                    gw.port, dict(body, stream=True, max_new_tokens=20))
            except (AssertionError, OSError):
                pass  # answered before the first token: still recorded
            return
        body["stream"] = i % 2 == 0
        status, _, raw = post(gw.port, body)
        if body["stream"] and status == 200:
            dones = [d for e, d in parse_sse_stream(raw) if e == "done"]
            assert len(dones) == 1
            status = STATUS_BY_OUTCOME[dones[0]["outcome"]]
        with lock:
            statuses.append(status)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(15)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=CEILING_S)
            assert not t.is_alive(), "a request hung"
        wait_until(lambda: sum(gw.metrics.outcomes.values())
                   == gw.metrics.http_requests_received,
                   "every HTTP request's terminal")
    finally:
        gw.stop_sync()
    assert set(statuses) <= set(STATUS_BY_OUTCOME.values())
    assert gw.metrics.http_requests_received == 15
    gw.metrics.check_conservation()
    assert engine.metrics.outcomes["timeout"] > 0
    assert sum(engine.metrics.outcomes.values()) == \
        engine.metrics.requests_submitted
    engine.allocator.check_conservation()
    if side == "port":
        assert engine.decode_compile_count == 1
