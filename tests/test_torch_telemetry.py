"""PyTorch port, telemetry on the CPU, held to the JAX package's.

* ``render_prometheus`` and ``render_families`` (gauges, counters, and
  histograms over the port's ``LogHistogram``) give byte-identical text.
* ``SpanTracer``: the same call sequence gives the same event stream
  (phases, spans, instants, counters, async events) once ``ts``/``dur``
  and thread ids are normalised; the trace file is valid Chrome JSON,
  capped, and readable by both ``load_trace``s when crashed mid-write.
* ``TelemetryExporter`` lines carry the same envelope.
* ``SlowStepDetector``, ``StragglerDetector`` and ``AnomalyProfiler``
  (recording backends) flag the same steps and windows on seeded timing
  streams; ``parse_profile_steps`` accepts and refuses the same specs.
* ``TorchProfilerBackend`` on the CPU writes a Chrome trace and a window
  summary; ``LiveSnapshotter`` dumps on a real SIGUSR1 (raised only while
  it is installed); ``Telemetry.from_config`` and the env override agree
  with the reference's; ``PrometheusEndpoint`` serves on 127.0.0.1.
"""

import json
import os
import signal
import urllib.request

import numpy as np
import pytest
import torch

from scaletorch_tpu import config as jconfig
from scaletorch_tpu import telemetry as jtel
from scaletorch_tpu.telemetry import histogram as jhist
from scaletorch_tpu_torch import config as tconfig
from scaletorch_tpu_torch import telemetry as ttel
from scaletorch_tpu_torch.telemetry import histogram as thist


def metric_values(seed):
    rng = np.random.default_rng(seed)
    return {"tokens_per_second": float(rng.uniform(1, 1e5)),
            "queue depth": int(rng.integers(0, 50)),
            "slot-occupancy": float(rng.random()), "flag": True,
            "name": "skipped", "requests_ok": int(rng.integers(0, 9))}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_is_byte_identical(seed):
    m = metric_values(seed)
    assert ttel.render_prometheus(m) == jtel.render_prometheus(m)
    assert (ttel.render_prometheus(m, namespace="x")
            == jtel.render_prometheus(m, namespace="x"))
    rng = np.random.default_rng(seed)
    samples = rng.lognormal(-3, 1.5, 200)
    fams = []
    for hmod in (thist, jhist):
        a, b = hmod.LogHistogram(), hmod.LogHistogram()
        for x in samples[:120]:
            a.observe(float(x))
        for x in samples[120:]:
            b.observe(float(x))
        fams.append([
            {"name": "ttft_seconds", "type": "histogram",
             "series": [({"tenant": 'a"b\\c'}, a), ({"tenant": "z"}, b)]},
            {"name": "shed", "type": "counter",
             "samples": [({"tenant": "a\nb"}, 3), (None, 4.5)]},
        ])
    assert (ttel.render_families(fams[0])
            == jtel.render_families(fams[1]))


def trace_calls(tracer):
    tracer.phase("step_boundary", step=0)
    with tracer.span("checkpoint_save", step=2):
        tracer.instant("rollback", step=3)
    tracer.phase("data_fetch", step=1)
    tracer.counter("queue_depth", 4)
    tracer.async_begin("request", "t-1", request_id=0)
    tracer.async_instant("req.admitted", "t-1", slot=1)
    tracer.async_end("request", "t-1", outcome="ok")
    with pytest.raises(ValueError):
        tracer.async_event("x", "bad", "t-1")
    tracer.phase("step_dispatch", step=1)
    tracer.end_phase()


def normalised(events):
    drop = ("ts", "dur", "tid")
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in drop}
        if e.get("name") == "trace_origin":
            e["args"] = {"clock": e["args"]["clock"]}
        out.append(e)
    return out


def test_span_streams_match_the_reference(tmp_path):
    streams = []
    for mod in (ttel, jtel):
        path = str(tmp_path / f"{mod.__name__}.trace.json")
        tracer = mod.SpanTracer(path, process_index=2, role="train")
        trace_calls(tracer)
        tail = tracer.tail()
        tracer.close()
        tracer.close()  # idempotent
        streams.append((normalised(tail),
                        normalised(mod.load_trace(path))))
    assert streams[0] == streams[1]
    names = [e["name"] for e in streams[0][1]]
    assert names.count("step_boundary") == names.count("data_fetch") == 1


def test_trace_cap_and_a_crashed_trace(tmp_path):
    path = str(tmp_path / "t.trace.json")
    tracer = ttel.SpanTracer(path, max_events=3, tail_size=5)
    for i in range(8):
        tracer.instant(f"e{i}")
    tracer.flush()
    # not closed: the file lacks its terminator, both readers take it
    for load in (ttel.load_trace, jtel.load_trace):
        assert [e["name"] for e in load(path)][-3:] == ["e0", "e1", "e2"]
    assert [e["name"] for e in tracer.tail()] == [f"e{i}" for i in range(3, 8)]
    tracer.close()
    events = json.load(open(path))
    assert events[-1] == {"name": "events_dropped", "ph": "M", "pid": 0,
                          "tid": 0, "args": {"count": 5}}
    off = ttel.SpanTracer(None, enabled=False)
    assert off.span("x") is ttel.NOOP_SPAN
    off.phase("x")
    assert off.tail() == []


def test_exported_lines_match_the_reference(tmp_path):
    lines = []
    for mod in (ttel, jtel):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        exp = mod.TelemetryExporter(path, process_index=1)
        exp.emit("train_step", {"step": 1, "loss": 2.5, "obj": object()})
        exp.close()
        exp.emit("train_step", {"step": 2})  # closed: dropped
        rec = ttel.read_jsonl(path)
        assert len(rec) == 1
        rec[0].pop("time")
        rec[0]["obj"] = rec[0]["obj"].split(" object")[0]
        lines.append(rec)
    assert lines[0] == lines[1]
    assert ttel.SCHEMA_VERSION == jtel.SCHEMA_VERSION


def step_times(seed, n=40):
    rng = np.random.default_rng(seed)
    times = list(rng.uniform(0.5, 0.6, n))
    times[0] = 30.0  # a cold first step
    for i in rng.choice(np.arange(3, n), 4, replace=False):
        times[int(i)] *= float(rng.uniform(2.0, 8.0))
    return [float(t) for t in times]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("factor", [1.5, 3.0])
def test_slow_steps_and_windows_match_the_reference(tmp_path, seed, factor):
    outs = []
    for mod in (ttel, jtel):
        det = mod.SlowStepDetector(factor, ema_beta=0.8)
        flags = [det.observe(t) for t in step_times(seed)]
        calls = []

        class Recorder:
            def start(self, log_dir):
                calls.append(("start", os.path.basename(log_dir)))

            def stop(self):
                calls.append(("stop",))

        prof = mod.AnomalyProfiler(str(tmp_path / mod.__name__),
                                   window_steps=2, spike_factor=factor,
                                   max_captures=2, profile_steps=(4, 6),
                                   backend=Recorder())
        for step, t in enumerate(step_times(seed), 1):
            prof.before_step(step)
            prof.after_step(step, t)
        prof.close()
        caps = [(c["trigger"], c["start_step"], c["stop_step"])
                for c in prof.captures]
        outs.append((flags, det.ema, det.spikes, calls, caps))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("spec", ["", "2:5", "1:2", "0:3", "4:4", "3",
                                  "a:b", "1:2:3"])
def test_parse_profile_steps_matches_the_reference(spec):
    results = []
    for mod in (ttel, jtel):
        try:
            results.append(mod.parse_profile_steps(spec))
        except ValueError as exc:
            results.append(str(exc))
    assert results[0] == results[1]


def host_timings(seed, hosts, steps=12):
    rng = np.random.default_rng(seed)
    slow = int(rng.integers(0, hosts))
    out = []
    for step in range(steps):
        row = []
        for h in range(hosts):
            t = float(rng.uniform(0.9, 1.1))
            if h == slow and step >= 3:
                t *= 3.0
            row.append(None if rng.random() < 0.05 else
                       {"step_time": t,
                        "data_fetch_time": float(rng.uniform(0, 0.1))})
        out.append(row)
    return out


@pytest.mark.parametrize("seed,hosts", [(0, 2), (1, 4), (2, 8), (3, 1)])
def test_stragglers_match_the_reference(seed, hosts):
    outs = []
    for mod in (ttel, jtel):
        det = mod.StragglerDetector(factor=2.0, patience=3, log_frequency=4)
        summaries = [det.observe(step, row) for step, row in
                     enumerate(host_timings(seed, hosts), 1)]
        outs.append((summaries, det.counters()))
    assert outs[0] == outs[1]
    with pytest.raises(ValueError):
        ttel.StragglerDetector(factor=1.0)


def test_torch_profiler_window_on_the_cpu(tmp_path):
    prof = ttel.AnomalyProfiler(str(tmp_path), profile_steps=(2, 3))
    x = torch.randn(64, 64)
    for step in range(1, 5):
        prof.before_step(step)
        x = x @ x.T / 64
        prof.after_step(step, 0.01)
    prof.close()
    assert len(prof.captures) == 1
    cap = prof.captures[0]
    assert (cap["trigger"], cap["start_step"], cap["stop_step"]) == (
        "manual", 2, 3)
    assert cap["launches"] == cap["launches_lost"] == 0  # no card
    assert cap["start_s"] >= 0 and cap["stop_s"] >= 0
    with open(os.path.join(cap["dir"], "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    assert json.load(open(os.path.join(cap["dir"], "window.json")))[
        "kernels"] == 0


def test_live_snapshot_on_a_real_sigusr1(tmp_path):
    snap = ttel.LiveSnapshotter(str(tmp_path))
    prev = signal.getsignal(signal.SIGUSR1)
    assert snap.install(lambda: {"step": 7, "span_tail": [{"name": "x"}]})
    try:
        signal.raise_signal(signal.SIGUSR1)
    finally:
        snap.uninstall()
    assert signal.getsignal(signal.SIGUSR1) is prev
    with open(tmp_path / "live_snapshot_1.json") as f:
        payload = json.load(f)
    assert payload["step"] == 7 and "MainThread" in payload["thread_stacks"]


@pytest.mark.parametrize("env", [None, "", "dir"])
def test_facade_from_config_matches_the_reference(tmp_path, monkeypatch,
                                                  env):
    if env is not None:
        monkeypatch.setenv("SCALETORCH_TPU_TELEMETRY_DIR",
                           str(tmp_path / "env") if env else "")
    kw = dict(telemetry_dir=str(tmp_path / "cfg"), profile_window_steps=2)
    if env != "":  # an empty override turns telemetry off: no profiler
        kw["profile_on_slow_step"] = 2.0
    shapes = []
    for mod, cfgmod in ((ttel, tconfig), (jtel, jconfig)):
        tel = mod.Telemetry.from_config(cfgmod.ScaleTorchTPUArguments(**kw))
        shapes.append((tel.enabled, tel.directory,
                       [getattr(tel, k) is None for k in
                        ("tracer", "exporter", "profiler", "snapshotter")],
                       tel.tracer and os.path.basename(tel.tracer.path)))
        tel.close()
    assert shapes[0] == shapes[1]
    assert ttel.Telemetry.disabled().span_tail() == []


def test_prometheus_endpoint_serves_on_localhost():
    with ttel.PrometheusEndpoint(lambda: {"tokens": 3}) as ep:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{ep.port}/metrics", timeout=5).read()
    assert body.decode() == ttel.render_prometheus({"tokens": 3})
