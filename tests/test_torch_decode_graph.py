"""PyTorch port, the engine's one-compile contract on the CPU.

The engine runs each step over static buffers (``StaticStep``): on the
card it captures the step once as a CUDA graph and replays it
(``tests/test_torch_decode_graph_cuda.py``); on the CPU the same step
functions run eagerly over the same buffers, which is what these tests
hold:

  * the static-buffer steps against the JAX package's steps on the same
    teacher-forced inputs (dense and paged, Qwen3 and Qwen3-MoE):
    logits within 1e-4 (the tolerance of ``test_torch_moe_engine.py``),
    greedy tokens equal wherever the JAX logits' top-2 margin is at
    least 1e-4 (the rule of ``test_torch_engine.py``); and the engines
    end to end, with one compile of each step on both sides;
  * every static buffer and pool keeps its ``data_ptr`` through
    admissions, a prefix hit, a cancel, a deadline and a quarantine, and
    both compile counts stay at 1, as the reference's tests hold them;
  * the serving MoE block equals ``moe_block``'s x bit for bit;
  * the sampler (Gumbel-max over hashed noise): a function of (seed,
    position) alone, the filtered distribution by a chi-square limit,
    greedy unchanged, uniforms strictly inside (0, 1) at the hash's edge
    inputs.

Inputs come from numpy seeds; JAX runs on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.inference import InferenceEngine as JaxEngine
from scaletorch_tpu.inference import SamplingParams as JaxSampling
from scaletorch_tpu.inference import decode as jdecode
from scaletorch_tpu.inference import kv_cache as jkv
from scaletorch_tpu.models import qwen3 as jqwen3
from scaletorch_tpu.models import qwen3_moe as jmoe
from scaletorch_tpu_torch.inference import (
    InferenceEngine,
    SamplingParams,
    StaticStep,
)
from scaletorch_tpu_torch.inference import sampling as tsampling
from scaletorch_tpu_torch.models import Qwen3Config
from scaletorch_tpu_torch.models import llama as tllama
from scaletorch_tpu_torch.models import qwen3_moe as tmoe

DENSE_KW = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=16,
                max_position_embeddings=256, rope_theta=1e6)
MOE_KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, moe_intermediate_size=48,
              num_experts=4, num_experts_per_tok=2, capacity_factor=2.0,
              tie_word_embeddings=False)
GREEDY = SamplingParams(temperature=0.0)
TOL = 1e-4     # logits, port vs JAX (test_torch_moe_engine.py's)
MARGIN = 1e-4  # a greedy divergence needs a top-2 margin below this
SLOTS, MAX_SEQ, PREFILL, PAGE = 3, 16, 8, 4


@pytest.fixture(scope="module", params=["qwen3", "qwen3_moe"])
def family(request):
    """(name, JAX config, JAX params, port config, numpy tree)."""
    if request.param == "qwen3":
        jcfg = jqwen3.Qwen3Config(**DENSE_KW, dtype=jnp.float32)
        tcfg = Qwen3Config(**DENSE_KW, dtype=torch.float32)
        params = jqwen3.init_params(jax.random.PRNGKey(3), jcfg)
    else:
        jcfg = jmoe.Qwen3MoEConfig(**MOE_KW, dtype=jnp.float32)
        tcfg = tmoe.Qwen3MoEConfig(**MOE_KW, dtype=torch.float32)
        params = jmoe.init_params(jax.random.PRNGKey(3), jcfg)
    return (request.param, jcfg, params, tcfg,
            jax.tree.map(np.asarray, params))


def identity_tables() -> np.ndarray:
    """Slot b owns pages b * pages_per_slot + 1, ... (page 0 is TRASH)."""
    pps = -(-MAX_SEQ // PAGE)
    return (np.arange(SLOTS * pps, dtype=np.int32) + 1).reshape(SLOTS, pps)


def check_tokens(got, want_logits, want_tokens):
    """Greedy tokens equal, except where the JAX logits' top-2 margin is
    below MARGIN (a tie the two frameworks may break apart)."""
    for row, (g, w) in enumerate(zip(got, want_tokens)):
        if g != w:
            top = np.sort(want_logits[row])[-2:]
            assert top[1] - top[0] < MARGIN, (row, g, w, top)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_static_steps_match_the_jax_steps(family, layout):
    """Teacher-forced: one prefill of the [B, P] buffer (one slot masked
    out), then four decode steps of given tokens, through the engine's
    static steps and through the JAX package's steps, same inputs."""
    _, jcfg, params, tcfg, tree = family
    paged = layout == "paged"
    eng = InferenceEngine(tree, tcfg, max_slots=SLOTS, max_seq=MAX_SEQ,
                          prefill_len=PREFILL, sampling=GREEDY,
                          cache_layout=layout, page_size=PAGE,
                          prefix_cache=False, device="cpu")
    jsampling = JaxSampling(temperature=0.0)
    keys = jnp.zeros((SLOTS, 2), jnp.uint32)
    tables = identity_tables()
    if paged:
        eng._tables[...] = tables
        eng._tables_dirty = True
        eng._upload_tables()
        jprefill = jdecode.make_paged_prefill_step(
            jcfg, jsampling, page_size=PAGE, seq_limit=MAX_SEQ)
        jdecode_step = jdecode.make_paged_decode_step(
            jcfg, jsampling, page_size=PAGE, seq_limit=MAX_SEQ)
        cache = jkv.init_paged_kv_cache(jcfg, eng.num_pages, PAGE)
        jtables = (jnp.asarray(tables),)
    else:
        jprefill = jdecode.make_prefill_step(jcfg, jsampling)
        jdecode_step = jdecode.make_decode_step(jcfg, jsampling)
        cache = jkv.init_kv_cache(jcfg, SLOTS, MAX_SEQ)
        jtables = ()
    rng = np.random.default_rng(21)
    vocab = tcfg.vocab_size
    tokens = rng.integers(0, vocab, (SLOTS, PREFILL)).astype(np.int32)
    lengths = np.array([5, 8, 3], np.int32)
    live = np.array([True, True, False])
    seeds = np.zeros(SLOTS, np.int64)
    if paged:
        zeros = np.zeros(SLOTS, np.int32)
        got = eng._prefill(tokens=tokens, tail_lens=lengths, starts=zeros,
                           write_mask=live, seeds=seeds)
        want = jprefill(params, jnp.asarray(tokens), jnp.asarray(lengths),
                        jnp.asarray(zeros), jnp.asarray(live), *jtables,
                        cache, keys)
    else:
        got = eng._prefill(tokens=tokens, lengths=lengths, write_mask=live,
                           seeds=seeds)
        want = jprefill(params, jnp.asarray(tokens), jnp.asarray(lengths),
                        jnp.asarray(live), cache, keys)
    steps = [(got, want)]
    cache = want[3]
    for t in range(4):
        step_tokens = rng.integers(0, vocab, SLOTS).astype(np.int32)
        positions = (lengths + t).astype(np.int32)
        got = eng._decode(tokens=step_tokens, positions=positions,
                          active=live, seeds=seeds)
        want = jdecode_step(params, jnp.asarray(step_tokens),
                            jnp.asarray(positions), jnp.asarray(live),
                            *jtables, cache, keys)
        cache = want[3]
        steps.append((got, want))
    for got, want in steps:
        want_logits = np.asarray(want[1])[live]
        np.testing.assert_allclose(got[1].numpy()[live], want_logits,
                                   atol=TOL, rtol=0)
        assert got[2].numpy()[live].all() and np.asarray(want[2])[live].all()
        check_tokens(got[0].numpy()[live].tolist(), want_logits,
                     np.asarray(want[0])[live].tolist())
    assert eng.prefill_compile_count == eng.decode_compile_count == 1


def schedule(vocab: int):
    """Five requests on two slots: the third and fourth wait, the fourth
    shares the first's two-page prefix (registered before it is
    admitted)."""
    rng = np.random.default_rng(5)

    def toks(n):
        return rng.integers(0, vocab, n).tolist()

    prefix = toks(2 * PAGE)
    return [(prefix + toks(3), 5), (toks(12), 4), (toks(6), 6),
            (prefix + toks(2), 5), (toks(7), 3)]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_matches_the_jax_engine_with_one_compile(family, layout):
    _, jcfg, params, tcfg, tree = family
    kw = dict(max_slots=2, max_seq=32, prefill_len=16, page_size=PAGE,
              cache_layout=layout)
    je = JaxEngine(params, jcfg, sampling=JaxSampling(temperature=0.0), **kw)
    te = InferenceEngine(tree, tcfg, sampling=GREEDY, device="cpu", **kw)
    out = []
    for eng in (je, te):
        ids = [eng.submit(p, max_new_tokens=n)
               for p, n in schedule(tcfg.vocab_size)]
        results = eng.run()
        out.append([results[i] for i in ids])
        assert eng.decode_compile_count == 1
        assert eng.prefill_compile_count == 1
    for j, t in zip(*out):
        assert (j.outcome, j.finish_reason) == (t.outcome, t.finish_reason)
        if j.tokens != t.tokens:
            k = next(i for i, (a, b) in enumerate(zip(j.tokens, t.tokens))
                     if a != b)
            logits = np.asarray(jqwen3_or_moe_forward(
                family, j.prompt + j.tokens[:k]))
            top = np.sort(logits)[-2:]
            assert top[1] - top[0] < MARGIN, (j.request_id, k, top)
    if layout == "paged":
        assert te.metrics.prefix_hits == je.metrics.prefix_hits >= 1
        te.allocator.check_conservation()


def jqwen3_or_moe_forward(family, tokens):
    name, jcfg, params, _, _ = family
    module = jqwen3 if name == "qwen3" else jmoe
    return module.forward(params, jnp.asarray([tokens], jnp.int32),
                          jcfg)[0, -1]


def static_pointers(eng) -> dict:
    ptrs = {f"{step}.{name}": buf.data_ptr()
            for step in ("_prefill", "_decode")
            for name, buf in getattr(eng, step).inputs.items()}
    ptrs.update(k=eng.cache.k.data_ptr(), v=eng.cache.v.data_ptr())
    if eng.cache_layout == "paged":
        ptrs["tables"] = eng._tables_dev.data_ptr()
    return ptrs


POISON = 99


def poisoned_forward(model, tokens, cfg, cache, **kw):
    """NaN logits on every row fed the token POISON."""
    logits, cache = tllama.forward_cached(model, tokens, cfg, cache, **kw)
    bad = (tokens == POISON).any(dim=1)
    return logits.masked_fill(bad[:, None, None], float("nan")), cache


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_buffers_and_compile_counts_hold_through_the_lifecycle(layout):
    """Admissions past the slots, a prefix hit, a cancel, a deadline and
    a quarantine: every static buffer and pool stays where it was, and
    each step is built once (the reference holds its jit cache sizes at
    1 through the same events)."""
    cfg = Qwen3Config(**DENSE_KW, dtype=torch.float32)
    eng = InferenceEngine(
        tllama.init_params(cfg, torch.Generator().manual_seed(2), "cpu"),
        cfg, max_slots=2, max_seq=32, prefill_len=16, sampling=GREEDY,
        cache_layout=layout, page_size=PAGE, forward_fn=poisoned_forward,
        device="cpu")
    before = static_pointers(eng)
    shared = list(range(1, 2 * PAGE + 1))
    first = eng.submit(shared + [20, 21], max_new_tokens=4)
    eng.step()
    hit = eng.submit(shared + [30], max_new_tokens=4)
    bad = eng.submit([5, POISON, 6], max_new_tokens=4)
    gone = eng.submit([7, 8, 9], max_new_tokens=20)
    late = eng.submit([10, 11], max_new_tokens=4, ttl_s=1e-9)
    queued = [eng.submit([12 + i], max_new_tokens=3) for i in range(3)]
    eng.step()
    eng.step()
    assert eng.cancel(gone) or eng.result(gone) is not None
    results = eng.run()
    assert results[first].outcome == results[hit].outcome == "ok"
    assert results[bad].outcome == "quarantined"
    assert results[gone].outcome == "aborted"
    assert results[late].outcome == "timeout"
    assert all(results[q].outcome == "ok" for q in queued)
    if layout == "paged":
        assert results[hit].prefix_hit
        eng.allocator.check_conservation()
    assert static_pointers(eng) == before
    assert eng.decode_compile_count == 1
    assert eng.prefill_compile_count == 1


def test_static_step_fills_its_buffers_in_place():
    """A call copies each host array into its own input; the buffers
    keep their storage; the outputs are the step function's."""
    def fn(x, y):
        return (x.long() * 2 + y,)

    step = StaticStep(fn, dict(x=np.zeros(3, np.int32),
                               y=np.ones(3, np.int64)), torch.device("cpu"))
    ptrs = {k: v.data_ptr() for k, v in step.inputs.items()}
    (out,) = step(x=np.array([1, 2, 3], np.int32))
    assert out.tolist() == [3, 5, 7]
    (out,) = step(x=np.array([4, 5, 6], np.int32), y=np.zeros(3, np.int64))
    assert out.tolist() == [8, 10, 12]
    assert {k: v.data_ptr() for k, v in step.inputs.items()} == ptrs
    assert step.compile_count == 1 and step.graph is None


@pytest.mark.parametrize("mode", ["index", "einsum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kernel", [False, True], ids=["bmm", "grouped"])
def test_serving_moe_block_equals_the_training_block(mode, dtype, kernel):
    cfg = tmoe.Qwen3MoEConfig(**MOE_KW, dtype=dtype, moe_dispatch=mode,
                              use_grouped_mlp_kernel=kernel)
    params = tmoe.init_params(cfg, torch.Generator().manual_seed(8), "cpu")
    layer = {k: v[0] for k, v in params["layers"].items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 7, cfg.hidden_size)).astype(np.float32)).to(dtype)
    with torch.no_grad():
        want, aux, stats = tmoe.moe_block(x, layer, cfg)
        got = tmoe.moe_block_serving(x, layer, cfg)
    assert torch.equal(got, want)
    assert torch.isfinite(aux) and set(stats) == {"moe_dropped_fraction",
                                                  "moe_load_cv"}


# ---- the sampler ------------------------------------------------------------
def test_draws_do_not_depend_on_the_batch():
    """A row's draw is the same alone, inside batches of random
    neighbours and at any row index."""
    params = tsampling.SamplingParams(temperature=0.9, top_k=20, top_p=0.95)
    rng = np.random.default_rng(12)
    logits = torch.from_numpy(rng.standard_normal((6, 97)).astype(
        np.float32))
    seeds = torch.tensor([0, 1, -5, 2**40 + 3, 7, 7])
    positions = torch.tensor([0, 3, 3, 100, 9, 10])
    whole = tsampling.sample(logits, seeds, positions, params)
    for i in range(6):
        alone = tsampling.sample(logits[i:i + 1], seeds[i:i + 1],
                                 positions[i:i + 1], params)
        assert alone.item() == whole[i].item()
    for trial in range(3):
        perm = torch.from_numpy(np.random.default_rng(trial).permutation(6))
        noise = torch.from_numpy(rng.standard_normal((6, 97)).astype(
            np.float32))
        mixed = torch.cat([logits[perm], noise])
        got = tsampling.sample(
            mixed, torch.cat([seeds[perm], torch.arange(6)]),
            torch.cat([positions[perm], torch.arange(6)]), params)
        assert torch.equal(got[:6], whole[perm])


# chi-square 0.999 quantiles by degrees of freedom (a sound sampler fails
# one such check in a thousand)
CHI2_999 = {1: 10.83, 2: 13.82, 3: 16.27, 4: 18.47}


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (3, 1.0), (0, 0.7)])
def test_draws_over_many_seeds_follow_the_filtered_distribution(top_k, top_p):
    """20000 requests, one draw each (distinct seeds, one position): the
    counts of the kept tokens pass a chi-square test at the 0.999
    quantile, and no filtered token is ever drawn."""
    params = tsampling.SamplingParams(temperature=0.8, top_k=top_k,
                                      top_p=top_p)
    logits = torch.tensor([1.0, 0.2, -0.3, 0.7, -1.5])
    n = 20000
    draws = tsampling.sample(logits.expand(n, 5), torch.arange(n) * 7919,
                             torch.full((n,), 12), params)
    counts = torch.bincount(draws, minlength=5).double()
    want = tsampling._filtered_probs(logits[None], params)[0].double()
    kept = want > 0
    assert torch.all(counts[~kept] == 0)
    expected = n * want[kept]
    chi2 = float(((counts[kept] - expected) ** 2 / expected).sum())
    assert chi2 < CHI2_999[int(kept.sum()) - 1], chi2


def test_greedy_is_argmax_whatever_the_seeds():
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (5, 33)).astype(np.float32))
    for seed in (0, 1, 12345):
        got = tsampling.sample(logits, torch.full((5,), seed),
                               torch.arange(5) + seed, GREEDY)
        assert torch.equal(got, torch.argmax(logits, dim=-1))


def test_uniforms_stay_inside_the_open_interval():
    """The hash's edges: the smallest and largest 32-bit hashes map to
    2^-24 and 1 - 2^-24; seeds at the int64 and 32-bit edges and
    positions at the int32 edge give uniforms in (0, 1) and finite
    Gumbel noise; the mixer keeps its state in [0, 2^32)."""
    h = torch.tensor([0, 1, 2**9 - 1, 2**9, 2**32 - 2**9, 2**32 - 1])
    u = tsampling.unit_interval(h)
    assert u[0].item() == 2.0 ** -24 and u[-1].item() == 1 - 2.0 ** -24
    assert torch.all((u > 0) & (u < 1))
    edges = [0, 1, -1, 2**31 - 1, 2**32 - 1, 2**32, 2**63 - 1, -2**63]
    seeds = torch.tensor(edges).repeat_interleave(3)
    positions = torch.tensor([0, 1, 2**31 - 1]).repeat(len(edges))
    u = tsampling.uniform_noise(seeds, positions, 4096)
    assert torch.all((u > 0) & (u < 1))
    assert torch.isfinite(-torch.log(-torch.log(u))).all()
    mixed = tsampling._mix32(torch.tensor(
        [0, 1, 2**31, 2**32 - 1], dtype=torch.long))
    assert torch.all((mixed >= 0) & (mixed < 2**32))


def test_engine_with_einsum_dispatch_runs_on_the_cpu():
    """The one-hot movement cannot be captured, so a card engine refuses
    it; on the CPU nothing is captured and it serves."""
    cfg = tmoe.Qwen3MoEConfig(**MOE_KW, dtype=torch.float32,
                              moe_dispatch="einsum")
    params = tmoe.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    eng = InferenceEngine(params, cfg, max_slots=2, max_seq=16,
                          sampling=GREEDY, device="cpu")
    index = InferenceEngine(
        params, dataclasses.replace(cfg, moe_dispatch="index"), max_slots=2,
        max_seq=16, sampling=GREEDY, device="cpu")
    for e in (eng, index):
        e.submit([1, 2, 3], max_new_tokens=4)
    assert eng.run()[0].tokens == index.run()[0].tokens
