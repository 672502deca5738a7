"""PyTorch port, the serving engine: the port's paged ``InferenceEngine`` on
the CPU and the JAX package's, fp32 and greedy, serve the same requests
and must agree — generated tokens (a divergence is accepted only where
the JAX logits' top-2 margin is below 1e-4, and the test checks it),
outcomes, prefix hits and saved prefill tokens; page conservation holds
after the drain. Inside the port, the paged and dense layouts give equal
tokens and bit-equal logits, and the pools are written in place. Then
the engine's host-side contracts: admission limits, deadlines, cancel,
drain, quarantine and the token hook."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.inference import InferenceEngine as JaxEngine
from scaletorch_tpu.inference import SamplingParams as JaxSampling
from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu_torch.inference import (
    EngineDraining,
    InferenceEngine,
    SamplingParams,
)
from scaletorch_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from scaletorch_tpu_torch.models import llama as tllama

KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=16, max_position_embeddings=256, qk_norm=True,
          tie_word_embeddings=True, rope_theta=1e6)
GREEDY = SamplingParams(temperature=0.0)
PAGE = 4
MARGIN = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig(**KW, dtype=jnp.float32)
    tcfg = LlamaConfig(**KW, dtype=torch.float32)
    params = jllama.init_params(jax.random.PRNGKey(11), jcfg)
    model = LlamaForCausalLM.from_params(jax.tree.map(np.asarray, params),
                                         tcfg, device="cpu")
    return jcfg, params, tcfg, model


def schedule():
    """Six requests on three slots and a 14-page budget: r0 and r3 share
    a 2-page prefix (r3 is admitted after r0 registered it), and r2 must
    wait for pages while a slot is free."""
    rng = np.random.default_rng(5)

    def toks(n):
        return rng.integers(0, 128, n).tolist()

    prefix = toks(2 * PAGE)
    return [(prefix + toks(3), 5),    # r0: 4 pages
            (toks(12), 12),           # r1: 6 pages
            (toks(14), 10),           # r2: 6 pages -> waits
            (prefix + toks(2), 6),    # r3: 4 pages, 2 shared
            (toks(5), 4),             # r4
            (toks(7), 3)]             # r5


ENGINE = dict(max_slots=3, max_seq=32, prefill_len=16, page_size=PAGE,
              num_pages=15, cache_layout="paged")


def serve_both(models):
    jcfg, params, tcfg, model = models
    je = JaxEngine(params, jcfg, sampling=JaxSampling(temperature=0.0),
                   **ENGINE)
    te = InferenceEngine(model, tcfg, sampling=GREEDY, device="cpu", **ENGINE)
    waited = []
    for eng in (je, te):
        ids = [eng.submit(p, max_new_tokens=n) for p, n in schedule()]
        eng.step()
        waited.append(bool(eng._queue)
                      and any(not s.active for s in eng._slots))
        eng.run()
        eng.drain()
        waited.append([eng.result(i) for i in ids])
    return je, te, waited


def top2_margin(params, jcfg, tokens):
    logits = np.asarray(jllama.forward(
        params, jnp.asarray([tokens], jnp.int32), jcfg))[0, -1]
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


def test_paged_engine_matches_the_jax_engine(models):
    jcfg, params, _, _ = models
    je, te, (j_waited, j_res, t_waited, t_res) = serve_both(models)
    assert j_waited and t_waited  # r2 waited for pages with a slot free
    for j, t in zip(j_res, t_res):
        assert (j.outcome, j.finish_reason) == (t.outcome, t.finish_reason)
        assert j.prefix_hit == t.prefix_hit
        if j.tokens != t.tokens:
            k = next(i for i, (a, b) in enumerate(zip(j.tokens, t.tokens))
                     if a != b)
            margin = top2_margin(params, jcfg, j.prompt + j.tokens[:k])
            assert margin < MARGIN, (j.request_id, k, margin)
    assert te.metrics.prefix_hits == je.metrics.prefix_hits >= 1
    assert (te.metrics.prefill_tokens_saved
            == je.metrics.prefill_tokens_saved == 2 * PAGE)
    assert te.metrics.snapshot()["requests_ok"] == 6
    te.allocator.check_conservation()
    assert all(not s.active for s in te._slots)


def record_logits(eng):
    """Wrap the engine's steps to keep the logits rows of the slots each
    step serves (the admitted slots of a prefill, the active ones of a
    decode; the other rows compute garbage that goes nowhere)."""
    seen = []
    mask_arg = {"_prefill": "write_mask", "_decode": "active"}
    for name, mask in mask_arg.items():
        step = getattr(eng, name)

        def wrapped(_step=step, _mask=mask, **arrays):
            out = _step(**arrays)
            seen.append(out[1][torch.from_numpy(arrays[_mask])].clone())
            return out

        setattr(eng, name, wrapped)
    return seen


def test_paged_and_dense_layouts_are_bit_identical(models):
    _, _, tcfg, model = models
    runs = {}
    for layout in ("dense", "paged"):
        eng = InferenceEngine(model, tcfg, max_slots=3, max_seq=32,
                              prefill_len=16, sampling=GREEDY,
                              cache_layout=layout, page_size=PAGE,
                              prefix_cache=False, device="cpu")
        logits = record_logits(eng)
        ptrs = (eng.cache.k.data_ptr(), eng.cache.v.data_ptr())
        ids = [eng.submit(p, max_new_tokens=n) for p, n in schedule()]
        results = eng.run()
        assert (eng.cache.k.data_ptr(), eng.cache.v.data_ptr()) == ptrs
        runs[layout] = ([results[i].tokens for i in ids], logits)
    assert runs["dense"][0] == runs["paged"][0]
    assert len(runs["dense"][1]) == len(runs["paged"][1])
    for d, p in zip(runs["dense"][1], runs["paged"][1]):
        assert torch.equal(d, p)


def test_prefix_sharing_keeps_greedy_tokens(models):
    _, _, tcfg, model = models
    out = []
    for prefix_cache in (False, True):
        eng = InferenceEngine(model, tcfg, sampling=GREEDY,
                              prefix_cache=prefix_cache, device="cpu",
                              **ENGINE)
        ids = [eng.submit(p, max_new_tokens=n) for p, n in schedule()]
        results = eng.run()
        out.append([results[i].tokens for i in ids])
    assert out[0] == out[1]


def test_engine_without_device_needs_a_card(models):
    _, _, tcfg, _ = models
    if torch.cuda.is_available():
        pytest.skip("a card is present; the error path is for hosts without")
    params = tllama.init_params(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(params, tcfg, cache_layout="paged")


def test_parameter_tree_builds_the_model(models):
    jcfg, params, tcfg, model = models
    tree = jax.tree.map(np.asarray, params)
    eng = InferenceEngine(tree, tcfg, max_slots=2, max_seq=16,
                          sampling=GREEDY, device="cpu")
    ref = InferenceEngine(model, tcfg, max_slots=2, max_seq=16,
                          sampling=GREEDY, device="cpu")
    for e in (eng, ref):
        e.submit([1, 2, 3], max_new_tokens=4)
    assert eng.run()[0].tokens == ref.run()[0].tokens


class TestHostContracts:
    def engine(self, models, **kw):
        _, _, tcfg, model = models
        base = dict(max_slots=2, max_seq=16, prefill_len=8, sampling=GREEDY,
                    cache_layout="paged", page_size=PAGE, device="cpu")
        base.update(kw)
        return InferenceEngine(model, tcfg, **base)

    def test_invalid_submissions(self, models):
        eng = self.engine(models)
        with pytest.raises(ValueError, match="at least one token"):
            eng.submit([])
        with pytest.raises(ValueError, match="prefill buffer"):
            eng.submit(list(range(9)))
        lax = self.engine(models, strict_submit=False)
        rid = lax.submit([])
        assert lax.result(rid).outcome == "rejected"
        eng.stop_admissions()
        lax.stop_admissions()
        with pytest.raises(EngineDraining):
            eng.submit([1])
        assert lax.result(lax.submit([1])).outcome == "rejected"

    def test_queue_capacity_sheds_the_oldest(self, models):
        eng = self.engine(models, queue_capacity=2)
        ids = [eng.submit([i + 1], max_new_tokens=2) for i in range(4)]
        assert [eng.result(i).outcome for i in ids[:2]] == ["shed", "shed"]
        results = eng.run()
        assert [results[i].outcome for i in ids[2:]] == ["ok", "ok"]
        snap = eng.metrics.snapshot()
        assert snap["requests_submitted"] == 4 == (
            snap["requests_ok"] + snap["requests_shed"])

    def test_deadline_cancel_and_drain(self, models):
        eng = self.engine(models)
        timed = eng.submit([1, 2], max_new_tokens=8, ttl_s=1e-9)
        live = eng.submit([3, 4], max_new_tokens=8)
        queued = eng.submit([5], max_new_tokens=8)
        gone = eng.submit([6], max_new_tokens=8)
        assert eng.cancel(gone) and not eng.cancel(gone)
        eng.step()
        assert eng.result(timed).outcome == "timeout"
        assert eng.cancel(live)
        assert eng.result(live).outcome == "aborted"
        assert eng.result(live).tokens  # partial tokens attached
        eng.drain()  # the admitted request finishes
        assert eng.result(queued).outcome == "ok"
        eng.allocator.check_conservation()
        assert eng.pending == 0

    def test_quarantine_keeps_the_other_slots_serving(self, models):
        poison = 99
        _, _, tcfg, model = models

        def forward(m, tokens, cfg, cache, **kw):
            logits, cache = tllama.forward_cached(m, tokens, cfg, cache, **kw)
            bad = (tokens == poison).any(dim=1)
            logits = logits.masked_fill(bad[:, None, None], float("nan"))
            return logits, cache

        outs = []
        for fwd in (None, forward):
            eng = self.engine(models, forward_fn=fwd)
            ids = [eng.submit([1, 2, 3], max_new_tokens=5),
                   eng.submit([4, poison], max_new_tokens=5)]
            results = eng.run()
            eng.allocator.check_conservation()
            outs.append([results[i] for i in ids])
        clean, drilled = outs
        assert drilled[1].outcome == "quarantined"
        assert drilled[0].outcome == "ok"
        assert drilled[0].tokens == clean[0].tokens

    def test_on_tokens_streams_every_token(self, models):
        streamed = {}
        eng = self.engine(
            models, on_tokens=lambda slot, rid, toks:
            streamed.setdefault(rid, []).extend(toks))
        ids = [eng.submit([7, 8, 9], max_new_tokens=5),
               eng.submit([1], max_new_tokens=3)]
        results = eng.run()
        for i in ids:
            assert streamed[i] == results[i].tokens
        assert eng.metrics.hist["ttft"].count == 2
