"""PyTorch port, disaggregated prefill/decode serving on the CPU: the
port's ``DisaggregatedEngine`` (split ``"1:1"`` over two CPU devices, a
page pool per slice) against the port's colocated paged engine and
against the reference's ``DisaggregatedEngine`` (split ``(1, 1)`` over
two of the 8 virtual CPU devices), the same tiny Llama weights carried
with ``models/convert.py`` (fp32, greedy).

* Greedy tokens and terminal outcomes: the port's disaggregated engine
  == the port's colocated engine bit for bit (tolerance 0: tokens are
  integers); == the reference's disaggregated engine, a token difference
  accepted only where the JAX logits' top-2 margin is below 1e-4 (two
  frameworks' fp32), and the test checks it. Handoff counters equal the
  reference's.
* One static step per slice (``prefill_compile_count ==
  decode_compile_count == 1``), through handoffs, quarantines, wire
  faults, deadlines and cancels.
* Both allocators conserved under a seeded randomized admit / handoff /
  cancel / deadline / ``fail_next`` schedule (the same schedule on the
  reference gives the same outcomes), the radix evictable back to full
  capacity.
* ``parse_disagg_spec`` and ``plan_slice_split`` match the reference on
  a grid of specs, device counts and budget files.
* The gateway over the port's disaggregated engine streams the
  colocated engine's tokens and shows the per-slice ``/healthz`` block.
"""

import json
import random
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.inference import DisaggregatedEngine as JaxDisagg
from scaletorch_tpu.inference import PageHandoffChannel as JaxChannel
from scaletorch_tpu.inference import SamplingParams as JaxSampling
from scaletorch_tpu.inference import disagg as jdisagg
from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu_torch.inference import (
    DisaggregatedEngine,
    InferenceEngine,
    PageHandoffChannel,
    SamplingParams,
)
from scaletorch_tpu_torch.inference import disagg as tdisagg
from scaletorch_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from scaletorch_tpu_torch.models import llama as tllama
from scaletorch_tpu_torch.serving.gateway import ServingGateway
from scaletorch_tpu_torch.serving.protocol import (
    parse_sse_stream,
    stream_tokens,
)
from scaletorch_tpu_torch.telemetry import TelemetryExporter, read_jsonl

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
ENGINE = dict(max_slots=2, max_seq=32, prefill_len=8, page_size=4)
SCHEDULE = [([1, 2, 3], 3), ([9, 8], 5), ([4, 5, 6, 7], 2), ([11], 6),
            ([1, 2, 3, 5], 4)]
OUTCOMES = {"ok", "timeout", "aborted", "quarantined", "rejected", "shed"}
POISON = 63
MARGIN = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig(**KW, dtype=jnp.float32)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = LlamaConfig(**KW, dtype=torch.float32)
    model = LlamaForCausalLM.from_params(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    return jcfg, params, tcfg, model


def poisoned_torch(model, tokens, cfg, cache, **kw):
    """NaN logits on every row fed the token POISON."""
    logits, cache = tllama.forward_cached(model, tokens, cfg, cache, **kw)
    bad = (tokens == POISON).any(dim=1)
    return logits.masked_fill(bad[:, None, None], float("nan")), cache


def poisoned_jax(params, tokens, cfg, cache, *, positions, write_mask=None,
                 **kw):
    logits, cache = jllama.forward_cached(params, tokens, cfg, cache,
                                          positions=positions,
                                          write_mask=write_mask, **kw)
    bad = jnp.any(tokens == POISON, axis=-1)
    return jnp.where(bad[:, None, None], jnp.nan, logits), cache


def disagg(models, poisoned=False, **kw):
    if poisoned:
        kw["forward_fn"] = poisoned_torch
    return DisaggregatedEngine(
        models[3], models[2], **{**ENGINE, **dict(
            devices=["cpu", "cpu"], disagg_split="1:1",
            sampling=SamplingParams(temperature=0.0)), **kw})


def colocated(models, poisoned=False, **kw):
    if poisoned:
        kw["forward_fn"] = poisoned_torch
    return InferenceEngine(models[3], models[2], device="cpu",
                           cache_layout="paged",
                           sampling=SamplingParams(temperature=0.0),
                           **{**ENGINE, **kw})


def reference(models, poisoned=False, channel=None, **kw):
    if poisoned:
        kw["forward_fn"] = poisoned_jax
    return JaxDisagg(models[1], models[0], devices=jax.devices()[:2],
                     disagg_split=(1, 1), channel=channel,
                     sampling=JaxSampling(temperature=0.0),
                     **{**ENGINE, **kw})


def serve(eng, schedule=SCHEDULE):
    ids = [eng.submit(p, max_new_tokens=n) for p, n in schedule]
    results = eng.run()
    return [results[i] for i in ids]


def assert_conserved_both(eng):
    """After a drain, NEITHER pool leaked, and evicting the decode-side
    radix returns both pools to full capacity."""
    eng.check_conservation()
    assert all(not s.active for s in eng._slots)
    assert not eng._handoff
    if eng.radix is not None:
        eng.radix.evict(eng.num_pages)
    assert eng.allocator.free_count == eng.allocator.capacity
    assert (eng.prefill_allocator.free_count
            == eng.prefill_allocator.capacity)


def top2_margin(models, tokens):
    logits = np.asarray(jllama.forward(
        models[1], jnp.asarray([tokens], jnp.int32), models[0]))[0, -1]
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


def same_as_reference(models, ours, theirs, schedule):
    """Outcomes equal; tokens equal or apart only at a JAX near-tie."""
    for (prompt, _), mine, ref in zip(schedule, ours, theirs):
        assert mine.outcome == ref.outcome
        assert mine.finish_reason == ref.finish_reason
        if mine.tokens != ref.tokens:
            k = next(i for i, (a, b) in enumerate(zip(mine.tokens,
                                                      ref.tokens))
                     if a != b)
            assert top2_margin(models, prompt + ref.tokens[:k]) < MARGIN


HANDOFF_COUNTERS = ("handoffs", "handoff_failures", "pages_handed_off",
                    "handoff_bytes", "prefix_hits", "requests_admitted",
                    "prefill_calls", "decode_steps", "prefill_tokens_saved")


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_tokens_match_colocated_and_reference(models, prefix_cache):
    eng = disagg(models, prefix_cache=prefix_cache)
    dis = serve(eng)
    colo = serve(colocated(models, prefix_cache=prefix_cache))
    for c, d in zip(colo, dis):
        assert (d.tokens, d.finish_reason, d.outcome) == \
            (c.tokens, c.finish_reason, "ok")
    assert eng.prefill_compile_count == eng.decode_compile_count == 1
    assert eng.metrics.handoffs > 0
    assert eng.prefill_model is eng.model  # one device: shared
    assert eng.prefill_cache.k.data_ptr() != eng.cache.k.data_ptr()
    ref = reference(models, prefix_cache=prefix_cache)
    same_as_reference(models, dis, serve(ref), SCHEDULE)
    for key in HANDOFF_COUNTERS:
        assert getattr(eng.metrics, key) == getattr(ref.metrics, key), key
    assert_conserved_both(eng)
    if prefix_cache:
        assert eng.radix is not None
    else:
        assert eng.radix is None


def test_quarantine_at_the_prefill_slice(models):
    schedule = [([1, 2, POISON], 4), ([7, 8, 9], 4)]
    eng = disagg(models, poisoned=True)
    dis = serve(eng, schedule)
    colo = serve(colocated(models, poisoned=True), schedule)
    for c, d in zip(colo, dis):
        assert (d.outcome, d.tokens) == (c.outcome, c.tokens)
    assert dis[0].outcome == "quarantined" and dis[0].tokens == []
    assert "prefill" in dis[0].detail
    same_as_reference(models, dis,
                      serve(reference(models, poisoned=True), schedule),
                      schedule)
    assert eng.prefill_compile_count == eng.decode_compile_count == 1
    assert_conserved_both(eng)


def test_counters_busy_fractions_and_prefix_sharing(models):
    sys_prompt = [7, 7, 7, 7, 3, 3, 3, 3]  # two full pages
    eng = disagg(models, prefill_len=12)
    r1 = eng.submit(sys_prompt + [1], max_new_tokens=4)
    eng.run()
    assert eng.channel.pages_transferred == 3  # ceil(9 / 4)
    r2 = eng.submit(sys_prompt + [2], max_new_tokens=4)
    results = eng.run()
    # the second request's shared pages stay on the decode pool: only
    # its tail page crosses, and the full prompt is prefilled anyway
    assert eng.channel.pages_transferred == 4
    assert eng.metrics.prefix_hits == 1
    assert eng.metrics.prefill_tokens_saved == 0
    ref = colocated(models, prefill_len=12)
    rr = ref.submit(sys_prompt + [2], max_new_tokens=4)
    assert results[r2].tokens == ref.run()[rr].tokens
    assert results[r1].outcome == "ok"
    m = eng.metrics
    assert m.handoffs == eng.channel.transfers == m.hist["handoff"].count
    assert m.pages_handed_off == eng.channel.pages_transferred
    assert m.handoff_bytes == eng.channel.bytes_transferred > 0
    busy_p, busy_d = m.busy_fractions()
    assert 0.0 < busy_p <= 1.0 and 0.0 < busy_d <= 1.0
    snap = m.snapshot()
    theirs = reference(models, prefill_len=12).metrics.snapshot()
    assert set(snap) == set(theirs)
    assert eng.decode_compile_count == 1
    assert_conserved_both(eng)


def test_first_token_stop_skips_the_handoff(models):
    eng = disagg(models)
    res = serve(eng, [([1, 2, 3], 1)])[0]
    ref = serve(colocated(models), [([1, 2, 3], 1)])[0]
    assert (res.outcome, res.finish_reason, res.tokens) == \
        ("ok", "length", ref.tokens)
    assert eng.metrics.handoffs == eng.channel.transfers == 0
    assert eng._decode.replays == 0  # the decode slice never ran
    assert_conserved_both(eng)


def test_transport_fault_aborts_exactly_once(models):
    channel = PageHandoffChannel()
    channel.fail_next()
    eng = disagg(models, channel=channel)
    aborted, ok = serve(eng, [([1, 2, 3], 5), ([7, 8, 9], 5)])
    assert aborted.outcome == "aborted" and "handoff failed" in \
        aborted.detail
    assert len(aborted.tokens) == 1  # the already-streamed token
    ref = serve(colocated(models), [([7, 8, 9], 5)])[0]
    assert (ok.outcome, ok.tokens) == ("ok", ref.tokens)
    assert eng.metrics.handoff_failures == channel.failures == 1
    assert eng.metrics.handoffs == 1
    assert eng.prefill_compile_count == eng.decode_compile_count == 1
    assert_conserved_both(eng)


@pytest.mark.parametrize("how", ["deadline", "cancel", "drain"])
def test_a_request_parked_for_handoff(models, how):
    """One decode slot, taken: the second request prefills and waits in
    the handoff queue, where its deadline passes, it is cancelled, or a
    drain finishes it through the decode slice."""
    eng = disagg(models, max_slots=1)
    occupant = eng.submit([1, 2, 3], max_new_tokens=20)
    eng.step()
    blocked = eng.submit([4, 5, 6], max_new_tokens=5)
    eng.step()
    assert len(eng._handoff) == 1
    if how == "deadline":
        eng._handoff[0].req.deadline = time.monotonic() - 1.0
        eng.step()
        results = eng.run()
        assert results[blocked].outcome == "timeout"
        assert "handoff" in results[blocked].detail
        assert len(results[blocked].tokens) == 1
    elif how == "cancel":
        assert eng.cancel(blocked) is True and not eng._handoff
        results = eng.run()
        assert results[blocked].outcome == "aborted"
    else:
        results = eng.drain()
        ref = serve(colocated(models, max_slots=1), [([4, 5, 6], 5)])[0]
        assert (results[blocked].outcome, results[blocked].tokens) == \
            ("ok", ref.tokens)
    assert results[occupant].outcome == "ok"
    assert eng.decode_compile_count == 1
    assert_conserved_both(eng)


def randomized(eng, channel, seed):
    """Seeded interleavings of submits (poison prompts, deadlines already
    past at the next tick), cancels, wire faults and ticks, then a full
    run; returns every request's (outcome, tokens)."""
    rng = random.Random(seed)
    ids = []
    for _ in range(40):
        op = rng.random()
        if op < 0.5:
            prompt = [rng.randint(1, 62) for _ in range(rng.randint(1, 8))]
            if rng.random() < 0.15:
                prompt[-1] = POISON
            kw = {}
            if rng.random() < 0.15:
                kw["ttl_s"] = 1e-9  # expires before any later tick
            ids.append(eng.submit(prompt, max_new_tokens=rng.randint(1, 6),
                                  **kw))
        elif op < 0.62 and ids:
            eng.cancel(rng.choice(ids))
        elif op < 0.72:
            channel.fail_next()
        else:
            eng.step()
    results = eng.run()
    assert sum(eng.metrics.outcomes.values()) == len(ids) == \
        eng.metrics.requests_submitted
    assert set(eng.metrics.outcomes) <= OUTCOMES
    return [(results[i].outcome, results[i].tokens) for i in ids]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_schedule_conserves_both_pools(models, seed):
    channel = PageHandoffChannel()
    eng = disagg(models, poisoned=True, channel=channel,
                 strict_submit=False)
    ours = randomized(eng, channel, seed)
    assert eng.prefill_compile_count == eng.decode_compile_count == 1
    assert_conserved_both(eng)
    jchannel = JaxChannel()
    ref = reference(models, poisoned=True, channel=jchannel,
                    strict_submit=False)
    theirs = randomized(ref, jchannel, seed)
    assert [o for o, _ in ours] == [o for o, _ in theirs]
    assert eng.metrics.handoff_failures == ref.metrics.handoff_failures


SPECS = ["4:4", " 3:5 ", "", "auto", "none", "1:1", "4", "1:2:3", "a:b",
         "4:", "0:4", "2:0", "-1:3", 7]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_disagg_spec_matches_the_reference(spec):
    got = []
    for mod in (tdisagg, jdisagg):
        try:
            got.append(mod.parse_disagg_spec(spec))
        except ValueError as exc:
            got.append(str(exc))
    assert got[0] == got[1]


BUDGETS = [None, {"disagg_prefill_slice": {"peak_mb": 3.0},
                  "disagg_decode_slice": {"peak_mb": 1.0}},
           {"prefill_step": {"peak_mb": 1.0},
            "paged_decode_step": {"peak_mb": 5.0}},
           {"disagg_prefill_slice": {"peak_mb": "x"}}]


@pytest.mark.parametrize("budget", range(len(BUDGETS)))
def test_plan_slice_split_matches_the_reference(budget, tmp_path):
    # the port reads the rows from the budget's ``slices`` (the slice
    # programs at a served width), the reference the same rows from its
    # ``entries``: the same arithmetic on the same rows
    path, ref = tmp_path / "hbm.json", tmp_path / "ref.json"
    if BUDGETS[budget] is not None:
        path.write_text(json.dumps({"slices": BUDGETS[budget]}))
        ref.write_text(json.dumps({"entries": BUDGETS[budget]}))
    for n in range(1, 10):
        got = []
        for mod, p in ((tdisagg, path), (jdisagg, ref)):
            try:
                got.append(mod.plan_slice_split(n, budget_path=str(p)))
            except ValueError as exc:
                got.append(str(exc))
        assert got[0] == got[1], n
    # the default budget is the port's own file (the analyzer's memory
    # tier, measured on the card); its slice rows size the split as the
    # reference's function sizes it from the same rows
    default = json.loads(open(tdisagg.DEFAULT_HBM_BUDGET).read())
    assert {row["source"] for row in default["slices"].values()} == {"cuda"}
    ref.write_text(json.dumps({"entries": default["slices"]}))
    assert tdisagg.plan_slice_split(8) == \
        jdisagg.plan_slice_split(8, budget_path=str(ref))
    with pytest.raises(ValueError, match=">= 2 devices"):
        tdisagg.plan_slice_split(1)


def test_constructor_validation(models):
    with pytest.raises(ValueError, match="paged"):
        disagg(models, cache_layout="dense")
    with pytest.raises(ValueError, match="mesh"):
        disagg(models, mesh=object())
    with pytest.raises(ValueError, match="devices"):
        disagg(models, disagg_split=(8, 8))
    with pytest.raises(ValueError, match=">= 2 devices"):
        DisaggregatedEngine(models[3], models[2], devices=["cpu"],
                            **ENGINE)
    with pytest.raises(ValueError, match="prefill_pool_pages"):
        disagg(models, prefill_pool_pages=1)
    with pytest.raises(ValueError, match="device="):
        disagg(models, device="cpu")
    with pytest.raises(NotImplementedError, match="one device"):
        DisaggregatedEngine(models[3], models[2], devices=["cpu"] * 3,
                            disagg_split="2:1", **ENGINE)


def test_jsonl_export_carries_the_disagg_kind(models, tmp_path):
    path = str(tmp_path / "events.jsonl")
    exporter = TelemetryExporter(path)
    eng = disagg(models, exporter=exporter)
    serve(eng, [([1, 2, 3], 4)])
    exporter.close()
    records = read_jsonl(path)
    assert {"engine_metrics", "disagg"} <= {r["kind"] for r in records}
    dis = [r for r in records if r["kind"] == "disagg"][-1]
    assert dis["prefill_slice_devices"] == dis["decode_slice_devices"] == 1
    assert dis["handoffs"] >= 1 and dis["handoff_failures"] == 0


def test_gateway_over_the_disaggregated_engine(models):
    eng = disagg(models, prefill_len=16, strict_submit=False)
    gw = ServingGateway(eng, port=0).start_in_thread()
    try:
        for prompt, n in SCHEDULE:
            req = urllib.request.Request(
                f"http://127.0.0.1:{gw.port}/v1/generate",
                data=json.dumps({"prompt": prompt, "max_new_tokens": n,
                                 "stream": True}).encode(), method="POST")
            events = parse_sse_stream(
                urllib.request.urlopen(req, timeout=60).read())
            dones = [d for e, d in events if e == "done"]
            assert len(dones) == 1 and dones[0]["outcome"] == "ok"
            direct = colocated(models, prefill_len=16)
            rid = direct.submit(prompt, max_new_tokens=n)
            assert stream_tokens(events) == direct.run()[rid].tokens
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{gw.port}/healthz", timeout=60).read())
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{gw.port}/metrics", timeout=60).read()
    finally:
        gw.stop_sync()
    gw.metrics.check_conservation()
    block = health["replicas"]["r0"]["disagg"]
    assert block["prefill_slice"]["devices"] == 1
    assert block["decode_slice"]["devices"] == 1
    assert block["handoffs"] > 0
    assert b"scaletorch_handoff_seconds_bucket" in metrics
    assert eng.prefill_compile_count == eng.decode_compile_count == 1
    assert_conserved_both(eng)
