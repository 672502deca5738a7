"""PyTorch port, the engine's runtime on the CPU: the port's paged
``InferenceEngine`` and the JAX package's, fp32 and greedy, take the same
``ServingFaultInjector`` drills and must agree.

* A NaN poison quarantines exactly the poisoned request; the others end
  ``ok`` with a clean run's tokens; a submit storm sheds oldest-first, a
  deadline storm times out queued and mid-decode requests; a preemption
  request makes ``run()`` drain. Outcomes, details and token counts equal
  the reference's; tokens equal it (a divergence is accepted only where
  the JAX logits' top-2 margin is below 1e-4, and the test checks it).
* Through every drill: one terminal result per request, page
  conservation, one static step each, and the KV pool and every static
  input keep their storage (the poison writes in place).
* The tracer sees the reference's span and request-event stream (names,
  phases and arguments, once times and thread ids are dropped), the
  exporter its ``engine_metrics`` records, and a stalled step fires the
  serving watchdog with a crash report and exit code 44 (a recording
  ``exit_fn``, a wait of at most 1 s).
"""

import json
import os
import signal
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu import resilience as jres
from scaletorch_tpu.inference import InferenceEngine as JaxEngine
from scaletorch_tpu.inference import SamplingParams as JaxSampling
from scaletorch_tpu.inference import ServingFaultInjector as JInjector
from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu.telemetry import SpanTracer as JTracer
from scaletorch_tpu.telemetry import TelemetryExporter as JExporter
from scaletorch_tpu_torch import resilience as tres
from scaletorch_tpu_torch.inference import (
    SERVING_STALL_EXIT_CODE,
    TERMINAL_OUTCOMES,
    InferenceEngine,
    SamplingParams,
    ServingFaultInjector,
    make_serving_watchdog,
)
from scaletorch_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from scaletorch_tpu_torch.telemetry import (
    SpanTracer,
    TelemetryExporter,
    read_jsonl,
)

KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=16, max_position_embeddings=256, qk_norm=True,
          tie_word_embeddings=True, rope_theta=1e6)
GREEDY = SamplingParams(temperature=0.0)
PAGE = 4
MARGIN = 1e-4
ENGINE = dict(max_slots=2, max_seq=32, prefill_len=12, page_size=PAGE,
              cache_layout="paged")


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig(**KW, dtype=jnp.float32)
    tcfg = LlamaConfig(**KW, dtype=torch.float32)
    params = jllama.init_params(jax.random.PRNGKey(3), jcfg)
    model = LlamaForCausalLM.from_params(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    return jcfg, params, tcfg, model


def engines(models, **kw):
    """(JAX engine, port engine) over the same weights and arguments."""
    jcfg, params, tcfg, model = models
    jax_kw, torch_kw = kw.pop("jax", {}), kw.pop("torch", {})
    je = JaxEngine(params, jcfg, sampling=JaxSampling(temperature=0.0),
                   **{**ENGINE, **kw, **jax_kw})
    te = InferenceEngine(model, tcfg, sampling=GREEDY, device="cpu",
                         **{**ENGINE, **kw, **torch_kw})
    return je, te


def static_pointers(eng):
    """The storage of the KV pool, the page tables and every static step
    input: a reallocation anywhere would mean a new capture on the
    card."""
    ptrs = {f"cache{i}": t.data_ptr() for i, t in enumerate(eng.cache)}
    ptrs["tables"] = eng._tables_dev.data_ptr()
    for name, step in (("prefill", eng._prefill), ("decode", eng._decode)):
        for key, t in step._staging.items():
            ptrs[f"{name}.{key}"] = t.data_ptr()
    return ptrs


def assert_conserved(eng):
    m = eng.metrics
    assert m.requests_submitted == sum(m.outcomes.values())
    assert m.requests_submitted == len(eng._results)
    assert all(r.outcome in TERMINAL_OUTCOMES for r in eng._results.values())
    assert not any(s.active for s in eng._slots) and eng.pending == 0
    eng.allocator.check_conservation()


def top2_margin(params, jcfg, tokens):
    logits = np.asarray(jllama.forward(
        params, jnp.asarray([tokens], jnp.int32), jcfg))[0, -1]
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


def assert_tokens_match(models, j, t):
    """Equal tokens, or a first divergence at a near-tie of the JAX
    logits."""
    jcfg, params = models[0], models[1]
    assert len(j.tokens) == len(t.tokens)
    if j.tokens != t.tokens:
        k = next(i for i, (a, b) in enumerate(zip(j.tokens, t.tokens))
                 if a != b)
        margin = top2_margin(params, jcfg, j.prompt + j.tokens[:k])
        assert margin < MARGIN, (j.request_id, k, margin)


def prompts(n, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, int(rng.integers(3, 9))).tolist()
            for _ in range(n)]


def drive(eng, schedule, before_run=None):
    ids = [eng.submit(p, max_new_tokens=m) for p, m in schedule]
    if before_run is not None:
        before_run(eng)
    return ids, eng.run()


# name: (engine kwargs with the injector made per engine, schedule,
#        an action before run())
DRILLS = {
    "poison": (dict(injector=lambda mod: mod(nan_logits_at_step=3,
                                             nan_logits_slot=0)),
               [(p, 8) for p in prompts(2)], None),
    "submit_storm": (dict(max_slots=1, queue_capacity=2,
                          injector=lambda mod: mod(submit_storm_at_step=2,
                                                   submit_storm_count=6)),
                     [(prompts(1)[0], 6)], None),
    "deadline_storm": (dict(max_slots=1,
                            injector=lambda mod: mod(
                                deadline_storm_at_step=3)),
                       [(prompts(2)[0], 20), (prompts(2)[1], 2)], None),
    "preemption": (dict(max_slots=1), [(prompts(2)[0], 6),
                                       (prompts(2)[1], 30)],
                   "sigterm"),
}


@pytest.mark.parametrize("drill", sorted(DRILLS))
def test_drill_matches_the_reference_engine(models, drill):
    kw, schedule, action = DRILLS[drill]
    kw = dict(kw)
    make = kw.pop("injector", None)
    if make is not None:
        kw["jax"] = dict(injector=make(JInjector))
        kw["torch"] = dict(injector=make(ServingFaultInjector))
    if action == "sigterm":
        kw["jax"] = dict(preemption=jres.PreemptionHandler())
        kw["torch"] = dict(preemption=tres.PreemptionHandler())
    je, te = engines(models, **kw)
    before = static_pointers(te)

    def sigterm(eng):
        eng.step()                       # admit the first request
        eng.preemption.trigger(signal.SIGTERM)

    hook = sigterm if action == "sigterm" else None
    j_ids, j_res = drive(je, schedule, hook)
    t_ids, t_res = drive(te, schedule, hook)
    assert sorted(j_res) == sorted(t_res)
    for rid in j_res:
        j, t = j_res[rid], t_res[rid]
        assert (j.outcome, j.finish_reason, j.detail) == (
            t.outcome, t.finish_reason, t.detail), rid
        assert_tokens_match(models, j, t)
    assert je.metrics.snapshot()["requests_submitted"] == \
        te.metrics.snapshot()["requests_submitted"]
    assert dict(je.metrics.outcomes) == dict(te.metrics.outcomes)
    assert_conserved(te)
    assert te.decode_compile_count == te.prefill_compile_count == 1
    assert static_pointers(te) == before
    counts = Counter(r.outcome for r in t_res.values())
    expected = {"poison": {"quarantined": 1, "ok": 1},
                "submit_storm": {"ok": 3, "shed": 4},
                "deadline_storm": {"timeout": 2},
                "preemption": {"ok": 1, "aborted": 1}}[drill]
    assert dict(counts) == expected


def test_poison_leaves_the_other_requests_as_a_clean_run(models):
    schedule = [(p, 8) for p in prompts(2)]
    _, te_clean = engines(models)
    _, clean = drive(te_clean, schedule)
    _, te = engines(models, torch=dict(injector=ServingFaultInjector(
        nan_logits_at_step=3, nan_logits_slot=0)))
    ids, faulty = drive(te, schedule)
    a, b = ids
    assert faulty[a].outcome == "quarantined"
    assert "non-finite" in faulty[a].detail
    # the prefill token and two decode tokens landed before the poison
    assert faulty[a].tokens == clean[a].tokens[:3]
    assert faulty[b].outcome == "ok" and faulty[b].tokens == clean[b].tokens


def normalised(events):
    """Events without their times and thread ids (the rest must agree)."""
    drop = ("ts", "dur", "tid", "pid")
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


def test_spans_and_exports_match_the_reference(models, tmp_path):
    schedule = [(p, 4) for p in prompts(3, seed=4)]
    streams, records = [], []
    for side, tracer_cls, exp_cls in (("jax", JTracer, JExporter),
                                      ("torch", SpanTracer,
                                       TelemetryExporter)):
        tracer = tracer_cls(None, role="serve", tail_size=4096)
        exporter = exp_cls(str(tmp_path / f"{side}.jsonl"))
        kw = {side: dict(tracer=tracer, exporter=exporter, monitor_every=2)}
        je, te = engines(models, **kw)
        eng = je if side == "jax" else te
        for i, (p, m) in enumerate(schedule):
            eng.submit(p, max_new_tokens=m, trace_id=f"trace-{i}")
        eng.run()
        exporter.close()
        streams.append(normalised(tracer.tail()))
        records.append(read_jsonl(str(tmp_path / f"{side}.jsonl")))
    assert streams[0] == streams[1]
    names = Counter(e["name"] for e in streams[1])
    assert names["tick"] == names["decode"] > 0 and names["prefill"] > 0
    assert names["request"] == 2 * len(schedule)
    assert [r["kind"] for r in records[0]] == [r["kind"] for r in records[1]]
    for j, t in zip(*records):
        for key in ("decode_steps", "requests_submitted", "requests_ok",
                    "tokens_generated", "prefill_calls"):
            assert j[key] == t[key], key


def test_stalled_step_fires_the_serving_watchdog(models, tmp_path):
    exits = []
    inj = ServingFaultInjector(slow_decode_at_step=6,
                               slow_decode_seconds=1.0)
    tracer = SpanTracer(None, role="serve")
    _, eng = engines(models, torch=dict(injector=inj, tracer=tracer,
                                        max_slots=1))
    # warm before the watchdog is armed: the first ticks pay one-time
    # costs that a loaded machine can stretch past a short timeout
    eng.submit(prompts(1)[0], max_new_tokens=4)
    eng.run()
    wd = make_serving_watchdog(eng, timeout=0.5,
                               crash_report_dir=str(tmp_path),
                               exit_fn=exits.append)
    assert eng.watchdog is wd
    rid = eng.submit(prompts(1)[0], max_new_tokens=4)
    with wd:
        results = eng.run()
    assert exits == [SERVING_STALL_EXIT_CODE] and wd.fired
    # the recorder does not end the process: the stalled step completes
    assert results[rid].outcome == "ok"
    reports = [f for f in os.listdir(tmp_path)
               if f.startswith("crash_report")]
    assert reports == ["crash_report_step5.json"]  # beaten before step 6
    with open(tmp_path / reports[0]) as f:
        report = json.load(f)
    assert report["serving"] is True
    assert report["exit_code"] == SERVING_STALL_EXIT_CODE
    assert "requests_quarantined" in report["counters"]
    assert "time.sleep(stall)" in report["thread_stacks"]["MainThread"]
    assert any(e["name"] == "tick" for e in report["span_timeline_tail"])
    assert eng.decode_compile_count == 1


def test_serving_injector_from_config_matches_the_reference(monkeypatch):
    from scaletorch_tpu import config as jconfig
    from scaletorch_tpu_torch import config as tconfig

    kw = dict(ft_serve_nan_at_step=4, ft_serve_nan_slot=1,
              ft_serve_slow_at_step=6, ft_serve_slow_seconds=0.25,
              ft_serve_submit_storm_at_step=2,
              ft_serve_submit_storm_count=3,
              ft_serve_deadline_storm_at_step=9, ft_gw_tenant_storm_at=5,
              ft_gw_replica_down_at=7)
    monkeypatch.setenv("SCALETORCH_TPU_FT_SERVE_NAN_SLOT", "0")
    monkeypatch.setenv("SCALETORCH_TPU_FT_GW_REPLICA_HANG_AT", "3")
    j = JInjector.from_config(jconfig.ScaleTorchTPUArguments(**kw))
    t = ServingFaultInjector.from_config(tconfig.ScaleTorchTPUArguments(**kw))
    assert repr(j) == repr(t) and j.active and t.active
    for step in range(1, 21):
        for name in ("take_nan_logits", "take_slow_decode",
                     "take_submit_storm", "take_deadline_storm",
                     "take_gw_tenant_storm", "take_gw_replica_down",
                     "take_gw_replica_crash", "take_gw_replica_hang",
                     "take_gw_warm_donor_crash",
                     "take_gw_warm_corrupt_chunk"):
            assert getattr(j, name)(step) == getattr(t, name)(step), (
                name, step)
