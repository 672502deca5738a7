"""Gateway smoke: boot the serve entry, stream one SSE request, verify.

Counterpart of the reference's ``scripts/gateway_smoke.py`` over the
port's serve entry (``python -m scaletorch_tpu_torch.serve``), end to
end:

  1. boot the serve entry as a child process with ``--telemetry_dir``
     and ``--slo_path`` and wait for its ``READY port=<p>`` line;
  2. stream one greedy request over HTTP (SSE) carrying a W3C
     ``traceparent`` header with a known trace id;
  3. rebuild the same engine in this process from the same flags
     (``--param_seed``) and assert the streamed tokens equal the direct
     ``InferenceEngine``'s bit for bit: the gateway adds transport,
     never arithmetic;
  4. scrape ``/healthz`` (the live SLO verdict) and ``/metrics``
     (tenant-labelled histogram series; the scrape is saved);
  5. SIGTERM the server and assert it drains to exit code 0, and read
     the kernel launch counts it prints after its drain (returned as
     ``serve_kernel_launches``: the serve process's own, so a caller on
     the card can tell its decode ran the hand-written kernel);
  6. read the telemetry back: the Chrome trace holds the request's spans
     on the gateway thread and on the engine worker, correlated by the
     trace id sent, beside the tick loop's phase spans; the access JSONL
     holds the request's record; and the port's ``slo_check`` accepts
     the JSONL and the ``/metrics`` scrape.

``--procs N`` runs the reference's process-fleet drill instead (serve
``--serve_replica_procs N --ft_gw_replica_crash_at 1``): the replica
serving the first stream is SIGKILLed mid-stream and that stream ends in
exactly one ``aborted``; the supervisor restarts it; a follow-up streams
the direct engine's tokens; the ledger balances through the crash; the
other replica is killed and rejoins warm (the donor's prefix pages
pulled over the wire), and its first shared-prefix request is a prefix
hit with the direct engine's tokens and no recapture; SIGTERM drains
the fleet to exit 0. ``--disagg P:D`` runs the single-process smoke
over the serve entry's disaggregated prefill/decode engine, the oracle
staying the colocated engine.

Every flag this tool does not know goes to the serve entry and to the
oracle's ``serve.parse_args`` after the defaults below, so it overrides
them: the card's smoke passes e.g. ``--preset qwen3-0.6b --dtype
float32 --max_slots 8 --max_seq 2048 --prefill_len 512 --page_size
16``. The engines run on the CUDA card (the paged decode through the
hand-written kernel) unless ``--device cpu`` is given; without a card
``cuda`` is an error.

Usage (from the root of a checkout):
    python -m scaletorch_tpu_torch.tools.gateway_smoke --device cpu
    python -m scaletorch_tpu_torch.tools.gateway_smoke --device cpu \\
        --procs 2
    python -m scaletorch_tpu_torch.tools.gateway_smoke --device cpu \\
        --disagg 1:1

Exit 0 when every check passed; a failed check prints its diagnostic
and exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from typing import Any, Dict, List, Optional

from scaletorch_tpu_torch.serving.protocol import (
    parse_sse_stream,
    stream_tokens,
)
from scaletorch_tpu_torch.serving.slo import DEFAULT_SLO_PATH

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PROMPT = [1, 2, 3, 5, 8]
MAX_NEW = 12
SEED = 7
TRACE_ID = "0af7651916cd43dd8448eb211c80319c"
PARENT_SPAN = "b7ad6b7169203331"
# the reference's serve flags (its SERVE_ARGS); extra flags come after
MODEL_ARGS = [
    "--preset", "tiny", "--param_seed", str(SEED),
    "--max_slots", "2", "--max_seq", "64", "--prefill_len", "16",
    "--cache_layout", "paged", "--page_size", "4",
]
# the line the serve entry prints after its drain: its kernel launch counts
LAUNCHES_PREFIX = "KERNEL_LAUNCHES "
OUTCOMES = ("ok", "timeout", "shed", "rejected", "quarantined", "aborted")


class Smoke:
    """One smoke's settings: the serve flags, the telemetry directory,
    the SLO file and preset, the request's length."""

    def __init__(self, device: str, extra: List[str], telemetry_dir: str,
                 slo_path: str, slo_preset: str, max_new: int,
                 ready_timeout_s: float) -> None:
        self.model_args = MODEL_ARGS + ["--device", device] + list(extra)
        self.telemetry_dir = os.path.abspath(telemetry_dir)
        self.slo_path = slo_path
        self.slo_preset = slo_preset
        self.max_new = max_new
        self.ready_timeout_s = ready_timeout_s

    def serve_args(self) -> List[str]:
        return self.model_args + [
            "--serve_port", "0", "--telemetry_dir", self.telemetry_dir,
            "--slo_path", self.slo_path, "--slo_preset", self.slo_preset]

    def fresh_dir(self) -> None:
        if os.path.isdir(self.telemetry_dir):
            shutil.rmtree(self.telemetry_dir)  # stale artifacts must not pass
        os.makedirs(self.telemetry_dir, exist_ok=True)

    def boot(self, *extra: str) -> "ServeEntry":
        return ServeEntry(self.serve_args() + list(extra),
                          self.ready_timeout_s)

    def direct_engine_tokens(self) -> list:
        """The oracle: the same engine, built from the same flags in this
        process, no HTTP in sight."""
        import torch

        from scaletorch_tpu_torch import serve as serve_mod

        args = serve_mod.parse_args(self.model_args)
        with torch.no_grad():
            cfg, model = serve_mod.build_model(args)
            engine = serve_mod.build_engine(args, cfg, model)
            rid = engine.submit(PROMPT, max_new_tokens=self.max_new)
            tokens = engine.run()[rid].tokens
        del engine, model
        return tokens

    def stream_generate(self, base: str) -> "Stream":
        """One streamed request of the smoke's prompt with the known
        traceparent."""
        return sse_request(base, PROMPT, self.max_new,
                           traceparent=f"00-{TRACE_ID}-{PARENT_SPAN}-01")

    def run_slo_check(self, events_path: str, prom_path: str) -> None:
        from scaletorch_tpu_torch.tools import slo_check

        for extra in ([events_path], ["--prom", prom_path]):
            rc = slo_check.main(["--slo", self.slo_path,
                                 "--preset", self.slo_preset, *extra])
            assert rc == 0, f"slo_check {extra} failed rc={rc}"
        print("[smoke] slo_check OK (JSONL + /metrics scrape)")

    def check_access_log(self, events_path: str) -> None:
        access = [json.loads(line) for line in open(events_path)
                  if '"access"' in line]
        access = [e for e in access if e.get("kind") == "access"]
        assert len(access) == 1, f"want exactly one access record: {access}"
        rec = access[0]
        assert rec["v"] == 1 and rec["trace_id"] == TRACE_ID, rec
        assert rec["tenant"] == "default" and rec["outcome"] == "ok", rec
        assert rec["status"] == 200 and rec["replica"] == "r0", rec
        assert rec["tokens"] == self.max_new, rec
        assert rec["ttft_s"] > 0 and rec["e2e_s"] >= rec["ttft_s"], rec
        assert rec["prefix_hit"] is False, rec
        print("[smoke] access record OK")


class ServeEntry:
    """``python -m scaletorch_tpu_torch.serve ARGS`` as a child in a
    session of its own (it and any replica process it starts). Its
    output is echoed and kept from a reader thread, so the READY
    deadline stays real: a wedged server that prints nothing fails at
    the timeout instead of hanging on a blocking readline. ``drain()``
    sends SIGTERM and reads the exit code and the output to its end;
    ``close()`` kills the session, whatever happened."""

    def __init__(self, args: List[str], ready_timeout_s: float) -> None:
        self.ready_timeout_s = ready_timeout_s
        self.log: List[str] = []
        self._lines: "queue.Queue" = queue.Queue()
        t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "scaletorch_tpu_torch.serve", *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO, start_new_session=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        try:
            self.port = self._wait_ready()
        except BaseException:
            self.close()
            raise
        self.ready_s = time.monotonic() - t0
        self.base = f"http://127.0.0.1:{self.port}"

    def _read(self) -> None:
        for line in self.proc.stdout:
            sys.stdout.write(f"[serve] {line}")
            sys.stdout.flush()
            self.log.append(line)
            self._lines.put(line)
        self._lines.put(None)  # EOF

    def _wait_ready(self) -> int:
        deadline = time.monotonic() + self.ready_timeout_s
        while time.monotonic() < deadline:
            try:
                line = self._lines.get(timeout=1.0)
            except queue.Empty:
                continue
            if line is None:
                raise AssertionError(
                    f"server exited early (rc={self.proc.poll()})")
            if line.startswith("READY port="):
                return int(line.strip().split("=", 1)[1])
        raise AssertionError(
            f"server never printed READY in {self.ready_timeout_s:g}s")

    def drain(self) -> int:
        """SIGTERM, the drain's exit code, the output read to its end."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=self.ready_timeout_s)
            self._reader.join(timeout=30)
            return rc
        finally:
            self.close()

    def kernel_launches(self) -> Dict[str, int]:
        """The serve process's own kernel launch counts, printed after
        its drain (``KERNEL_LAUNCHES {...}``)."""
        for line in reversed(self.log):
            if line.startswith(LAUNCHES_PREFIX):
                return json.loads(line[len(LAUNCHES_PREFIX):])
        raise AssertionError("the serve process printed no kernel launch "
                             "counts after its drain")

    def close(self) -> None:
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass  # the drain ended every process of the session
        self.proc.wait(timeout=30)


@dataclasses.dataclass
class Stream:
    """What one streamed request saw."""

    events: list          # (event, data) pairs, the protocol's parse
    tokens: list          # the streamed token ids
    dones: list           # the done events' data
    times: list           # each token event's arrival (host monotonic)
    traceparent: str      # the response's traceparent header


def sse_request(base: str, prompt, max_new_tokens: int, *,
                traceparent: Optional[str] = None, on_token=None,
                timeout: float = 120.0) -> Stream:
    """One streamed ``POST /v1/generate`` to the gateway at ``base``;
    ``on_token()`` after each token event."""
    body = json.dumps({"prompt": list(prompt),
                       "max_new_tokens": max_new_tokens,
                       "stream": True}).encode()
    request = urllib.request.Request(
        f"{base}/v1/generate", data=body, method="POST")
    if traceparent:
        request.add_header("traceparent", traceparent)
    raw, times, event = [], [], None
    with urllib.request.urlopen(request, timeout=timeout) as response:
        echo = response.headers.get("traceparent", "")
        for line in response:
            raw.append(line)
            text = line.decode().rstrip("\r\n")
            if text.startswith("event:"):
                event = text[6:].strip()
            elif text.startswith("data:") and event == "token":
                times.append(time.monotonic())
                if on_token is not None:
                    on_token()
    events = parse_sse_stream(b"".join(raw))
    return Stream(events, stream_tokens(events),
                  [d for e, d in events if e == "done"], times, echo)


def check_trace_correlation(trace_path: str, *, disagg: bool = False) -> int:
    """One trace in which the request's spans on the gateway (asyncio)
    thread and on the engine worker thread share the trace id sent,
    beside the tick loop's phase spans; returns the request's events."""
    from scaletorch_tpu_torch.telemetry.spans import load_trace

    events = load_trace(trace_path)
    ours = [e for e in events if e.get("id") == TRACE_ID]
    names = {e["name"] for e in ours}
    gw_names = {"gw.request", "gw.queued", "gw.stream"}
    engine_names = {"request", "req.queued", "req.prefill", "req.decode",
                    "req.finalize"}
    if disagg:
        engine_names = engine_names | {"req.handoff"}
    assert gw_names <= names, f"missing gateway spans: {gw_names - names}"
    assert engine_names <= names, \
        f"missing engine lifecycle spans: {engine_names - names}"
    gw_tids = {e["tid"] for e in ours if e["name"] in gw_names}
    engine_tids = {e["tid"] for e in ours if e["name"] in engine_names}
    assert gw_tids and engine_tids and not (gw_tids & engine_tids), (
        "request spans did not cross threads: gateway tids "
        f"{gw_tids}, engine tids {engine_tids}")
    tick_spans = {e["name"] for e in events
                  if e.get("ph") == "X" and e.get("tid") in engine_tids}
    want_ticks = {"tick", "decode", "prefill"}
    if disagg:
        want_ticks = want_ticks | {"handoff"}
    assert want_ticks <= tick_spans, (
        f"engine tick-loop phase spans missing on the worker thread: "
        f"{tick_spans}")
    outcome = [e for e in ours
               if e["name"] == "req.finalize"][0]["args"]["outcome"]
    assert outcome == "ok", outcome
    print(f"[smoke] trace correlation OK: {len(ours)} request events "
          f"across tids {sorted(gw_tids | engine_tids)}")
    return len(ours)


def parse_prom(text: str) -> dict:
    """Flat ``{series-with-labels: value}`` out of an exposition page."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name, _, value = line.rpartition(" ")
        try:
            out[name] = float(value)
        except ValueError:
            continue
    return out


def get_json(url: str) -> dict:
    return json.loads(get_text(url))


def get_text(url: str) -> str:
    with urllib.request.urlopen(url, timeout=60) as response:
        return response.read().decode()


def run_single(smoke: Smoke, disagg: str = "") -> Dict[str, Any]:
    """The single-process smoke (``--disagg P:D``: over the
    disaggregated engine, the oracle colocated)."""
    smoke.fresh_dir()
    proc = smoke.boot(*(["--disagg", disagg] if disagg else []))
    try:
        base = proc.base
        stream = smoke.stream_generate(base)
        events, streamed, dones = stream.events, stream.tokens, stream.dones
        echo = stream.traceparent
        assert len(dones) == 1, f"expected exactly one done event: {events}"
        assert dones[0]["outcome"] == "ok", dones[0]
        assert streamed == dones[0]["token_ids"], (streamed, dones[0])
        # the trace id sent came back: response header and terminal
        assert echo.startswith(f"00-{TRACE_ID}-"), echo
        assert dones[0]["trace_id"] == TRACE_ID, dones[0]

        reference = smoke.direct_engine_tokens()
        assert streamed == reference, (
            f"SSE stream diverged from the direct engine:\n"
            f"  streamed:  {streamed}\n  reference: {reference}")
        print(f"[smoke] SSE bit-parity OK over {len(streamed)} tokens "
              f"(traceparent round-tripped)")

        health = get_json(f"{base}/healthz")
        assert health["status"] == "ok", health
        assert health["slo"]["ok"] is True, health["slo"]
        assert health["slo"]["requests"] == 1, health["slo"]
        if disagg:
            n_p, n_d = (int(x) for x in disagg.split(":"))
            dis = health["replicas"]["r0"].get("disagg")
            assert dis is not None, health["replicas"]
            assert dis["prefill_slice"]["devices"] == n_p, dis
            assert dis["decode_slice"]["devices"] == n_d, dis
            assert dis["handoffs"] >= 1, dis
            assert dis["handoff_failures"] == 0, dis
            assert dis["pages_handed_off"] >= 1, dis
            print(f"[smoke] /healthz disagg block OK "
                  f"({dis['handoffs']:g} handoffs, "
                  f"{dis['pages_handed_off']:g} pages)")
        metrics = get_text(f"{base}/metrics")
        assert "scaletorch_http_requests_received 1.0" in metrics, \
            metrics[:400]
        needles = [
            "# TYPE scaletorch_request_ttft_seconds histogram",
            'scaletorch_request_ttft_seconds_count{tenant="default"} 1',
            "scaletorch_request_tpot_seconds_bucket{le=",
            'scaletorch_request_queue_wait_seconds_count'
            '{tenant="default"} 1',
            'scaletorch_engine_pages_in_use{replica="r0"}',
            'scaletorch_engine_decode_compile_count{replica="r0"} 1.0',
        ]
        if disagg:
            needles += [
                'scaletorch_engine_prefill_slice_busy_fraction'
                '{replica="r0"}',
                'scaletorch_engine_decode_slice_busy_fraction'
                '{replica="r0"}',
                'scaletorch_engine_pages_handed_off{replica="r0"}',
                "# TYPE scaletorch_handoff_seconds histogram",
                'scaletorch_handoff_seconds_count{replica="r0"} 1',
            ]
        for needle in needles:
            assert needle in metrics, f"missing {needle}"
        prom_path = os.path.join(smoke.telemetry_dir, "metrics_scrape.txt")
        with open(prom_path, "w") as f:
            f.write(metrics)
        print("[smoke] /healthz (SLO ok) + /metrics histogram series OK")

        rc = proc.drain()
        assert rc == 0, f"drain exit code {rc}, want 0"
        launches = proc.kernel_launches()
        print(f"[smoke] SIGTERM drain exit 0 OK; the serve process's "
              f"kernel launches {launches}")

        trace_events = check_trace_correlation(
            os.path.join(smoke.telemetry_dir, "serve.trace.json"),
            disagg=bool(disagg))
        events_path = os.path.join(smoke.telemetry_dir,
                                   "gateway_events.jsonl")
        smoke.check_access_log(events_path)
        smoke.run_slo_check(events_path, prom_path)
        return {"mode": "disagg" if disagg else "single", "tokens": streamed,
                "tokens_equal_direct": True, "ready_s": proc.ready_s,
                "drain_exit_code": rc, "trace_events": trace_events,
                "slo_check_exit_code": 0, "health_slo_ok": True,
                "serve_kernel_launches": launches}
    finally:
        proc.close()


def _wait_health(base: str, pred, what: str, timeout_s: float) -> dict:
    deadline = time.monotonic() + timeout_s
    health = get_json(f"{base}/healthz")
    while not pred(health):
        assert time.monotonic() < deadline, f"{what}: {health}"
        time.sleep(0.25)
        health = get_json(f"{base}/healthz")
    return health


def run_fleet(smoke: Smoke, procs: int) -> Dict[str, Any]:
    """The process-fleet drill: kill -9 mid-stream, survive, heal, rejoin
    warm."""
    smoke.fresh_dir()
    proc = smoke.boot("--serve_replica_procs", str(procs),
                      "--ft_gw_replica_crash_at", "1",
                      "--supervisor_backoff_base_s", "0.2",
                      "--supervisor_backoff_max_s", "1.0")
    try:
        base = proc.base
        health = get_json(f"{base}/healthz")
        pids_before = {rid: rep["pid"]
                       for rid, rep in health["replicas"].items()}
        assert len(pids_before) == procs, health
        assert all(isinstance(p, int) for p in pids_before.values()), health

        # 1. the armed drill SIGKILLs the serving replica mid-stream: the
        #    stream still ends in exactly one terminal
        stream = smoke.stream_generate(base)
        streamed, dones = stream.tokens, stream.dones
        assert len(dones) == 1, f"want exactly one done event: {dones}"
        assert dones[0]["outcome"] == "aborted", dones[0]
        assert streamed == dones[0]["token_ids"], (streamed, dones[0])
        print("[smoke-mp] kill -9 mid-stream -> exactly one terminal "
              f"(aborted, {len(streamed)} partial tokens) OK")

        # 2. the supervisor restarts the victim: new pid, counter bumped
        health = _wait_health(
            base, lambda h: any(
                rep.get("restarts_total", 0) >= 1 and rep.get("state") == "up"
                for rep in h["replicas"].values()),
            "no replica restarted", smoke.ready_timeout_s)
        victim = next(rid for rid, rep in health["replicas"].items()
                      if rep.get("restarts_total", 0) >= 1
                      and rep.get("state") == "up")
        rep = health["replicas"][victim]
        assert rep["pid"] != pids_before[victim], (rep, pids_before)
        assert rep["last_exit_code"] not in (None, 0), rep
        print(f"[smoke-mp] supervisor restarted {victim}: "
              f"pid {pids_before[victim]} -> {rep['pid']}, "
              f"exit {rep['last_exit_code']} OK")

        # 3. the healed fleet streams the direct engine's tokens
        stream = smoke.stream_generate(base)
        streamed, dones, echo = stream.tokens, stream.dones, \
            stream.traceparent
        assert len(dones) == 1 and dones[0]["outcome"] == "ok", dones
        assert echo.startswith(f"00-{TRACE_ID}-"), echo
        reference = smoke.direct_engine_tokens()
        assert streamed == reference, (
            f"post-restart stream diverged:\n"
            f"  streamed:  {streamed}\n  reference: {reference}")
        print(f"[smoke-mp] post-restart SSE bit-parity OK over "
              f"{len(streamed)} tokens")

        # 4. the ledger balances through the crash
        prom = parse_prom(get_text(f"{base}/metrics"))
        received = prom["scaletorch_http_requests_received"]
        outcome_sum = sum(prom.get(f"scaletorch_http_{o}", 0.0)
                          for o in OUTCOMES)
        assert received == 2.0, received
        assert outcome_sum == received, (outcome_sum, received, prom)
        assert prom["scaletorch_http_aborted"] == 1.0, prom
        assert prom["scaletorch_http_ok"] == 1.0, prom
        restarts = [v for k, v in prom.items()
                    if k.startswith("scaletorch_replica_restarts_total")]
        assert restarts and sum(restarts) >= 1.0, prom
        ups = [v for k, v in prom.items()
               if k.startswith("scaletorch_replica_up")]
        assert len(ups) == procs and all(u == 1.0 for u in ups), prom
        print("[smoke-mp] conservation through the crash OK "
              f"(received={received:g} == outcomes={outcome_sum:g}; "
              f"restarts={sum(restarts):g})")

        # 5. warm rejoin: request 2 left prefix pages on one replica (the
        #    donor); kill -9 the other, which must come back warmed
        health = _wait_health(
            base, lambda h: any((rep.get("prefix_pages") or 0) > 0
                                for rep in h["replicas"].values()),
            "no replica registered prefix pages after request 2", 120.0)
        donor = next(rid for rid, rep in health["replicas"].items()
                     if (rep.get("prefix_pages") or 0) > 0)
        victim2 = next(rid for rid in sorted(health["replicas"])
                       if rid != donor)
        rep2 = health["replicas"][victim2]
        restarts_before = rep2["restarts_total"]
        os.kill(rep2["pid"], signal.SIGKILL)
        health = _wait_health(
            base, lambda h: (
                h["replicas"][victim2].get("state") == "up"
                and h["replicas"][victim2].get("restarts_total", 0)
                > restarts_before
                and (h["replicas"][victim2].get("warm_pages") or 0) > 0),
            f"restarted {victim2} never reported warmed pages",
            smoke.ready_timeout_s)
        warmed = health["replicas"][victim2]
        print(f"[smoke-mp] warm rejoin OK: {victim2} restarted with "
              f"{warmed['warm_pages']:g} pages pulled from {donor}")

        # 6. the first shared-prefix request after the restart is served
        #    by the warmed replica, a prefix hit, the direct tokens
        stream = smoke.stream_generate(base)
        streamed, dones = stream.tokens, stream.dones
        assert len(dones) == 1 and dones[0]["outcome"] == "ok", dones
        assert streamed == reference, (
            f"warmed-replica stream diverged:\n"
            f"  streamed:  {streamed}\n  reference: {reference}")
        print("[smoke-mp] warmed-replica SSE bit-parity OK over "
              f"{len(streamed)} tokens")

        # 7. the ledger balances through the warm cycle, and no engine
        #    captured its decode step again
        metrics = get_text(f"{base}/metrics")
        prom = parse_prom(metrics)
        assert prom["scaletorch_http_requests_received"] == 3.0, prom
        assert prom["scaletorch_http_aborted"] == 1.0, prom
        assert prom["scaletorch_http_ok"] == 2.0, prom
        warm_key = (f'scaletorch_replica_warm_pages_total'
                    f'{{replica="{victim2}"}}')
        assert prom.get(warm_key, 0.0) >= 1.0, (warm_key, prom)
        assert "scaletorch_warm_transfer_seconds" in metrics, metrics[:400]
        deadline = time.monotonic() + 60
        while True:
            compiles = [v for k, v in parse_prom(
                get_text(f"{base}/metrics")).items()
                if k.startswith("scaletorch_engine_decode_compile_count")]
            if (len(compiles) == procs and all(c == 1.0 for c in compiles)) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        assert len(compiles) == procs and all(c == 1.0 for c in compiles), (
            f"warming must not recapture: decode compile counts {compiles}")
        prom_path = os.path.join(smoke.telemetry_dir, "metrics_scrape.txt")
        with open(prom_path, "w") as f:
            f.write(metrics)
        print("[smoke-mp] conservation + one capture through the warm "
              "cycle OK (received=3)")

        # 8. SIGTERM drains the whole fleet to exit 0
        rc = proc.drain()
        assert rc == 0, f"drain exit code {rc}, want 0"
        print("[smoke-mp] SIGTERM fleet drain exit 0 OK")

        # 9. the supervisor's events, the warmup record, the access
        #    records and the SLO gate
        events_path = os.path.join(smoke.telemetry_dir,
                                   "gateway_events.jsonl")
        records = [json.loads(line) for line in open(events_path)]
        sup_events = [r["event"] for r in records
                      if r.get("kind") == "supervisor"]
        for needed in ("spawn", "ready", "crash", "restart"):
            assert needed in sup_events, (needed, sup_events)
        warmups = [r for r in records if r.get("kind") == "warmup"]
        assert any(r["replica"] == victim2 and r["status"] == "warmed"
                   and r["pages"] >= 1 and r["donor"] == donor
                   for r in warmups), warmups
        access = [r for r in records if r.get("kind") == "access"]
        assert len(access) == 3, access
        assert sorted(r["outcome"] for r in access) == \
            ["aborted", "ok", "ok"], access
        assert any(r["outcome"] == "ok" and r["replica"] == victim2
                   and r["prefix_hit"] is True for r in access), access
        print(f"[smoke-mp] supervisor + warmup event streams OK "
              f"({sup_events})")
        smoke.run_slo_check(events_path, prom_path)
        return {"mode": f"procs{procs}", "tokens": streamed,
                "tokens_equal_direct": True, "drain_exit_code": rc,
                "restarted": victim, "warmed": victim2, "donor": donor,
                "slo_check_exit_code": 0}
    finally:
        proc.close()


def run(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Parse the flags and run the smoke; raises on the first failed
    check, returns what it saw."""
    from scaletorch_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m scaletorch_tpu_torch.tools.gateway_smoke",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engines run; 'cuda' fails without a "
                         "card")
    ap.add_argument("--procs", type=int, default=0,
                    help="N >= 2: the process-fleet crash drill "
                         "(serve --serve_replica_procs N) instead of the "
                         "single-process smoke")
    ap.add_argument("--disagg", default="",
                    help="'P:D': the single-process smoke over serve "
                         "--disagg P:D; the oracle stays colocated")
    ap.add_argument("--telemetry_dir",
                    default=os.path.join(REPO, "build", "gateway-smoke"),
                    help="where the serve entry's artifacts go (emptied "
                         "first)")
    ap.add_argument("--slo_path", default=DEFAULT_SLO_PATH)
    ap.add_argument("--slo_preset", default="tiny")
    ap.add_argument("--max_new_tokens", type=int, default=MAX_NEW)
    ap.add_argument("--ready_timeout_s", type=float, default=300.0)
    args, extra = ap.parse_known_args(argv)
    if args.procs and args.disagg:
        ap.error("--disagg runs in-process replicas only (no --procs)")
    resolve_device(args.device)  # no card for 'cuda': fail here, at once
    smoke = Smoke(args.device, extra, args.telemetry_dir, args.slo_path,
                  args.slo_preset, args.max_new_tokens, args.ready_timeout_s)
    if args.procs:
        return run_fleet(smoke, args.procs)
    return run_single(smoke, args.disagg)


def main(argv: Optional[List[str]] = None) -> int:
    try:
        run(argv)
    except AssertionError:
        traceback.print_exc()
        print("[smoke] FAILED")
        return 1
    print("[smoke] all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
