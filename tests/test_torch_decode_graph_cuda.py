"""PyTorch port, the engine's CUDA graphs on the card.

Each engine captures its prefill step and its decode step once as CUDA
graphs and only replays them after that. Here, at small widths that the
kernels take (head_dim 32, H and I multiples of 64):

  * every replay's outputs (token, fp32 logits, finite flag) equal the
    eager step function's on the same static buffers, bit for bit:
    dense and paged, fp32 and bf16, paged through K4 and through the
    gather path, and Qwen3-MoE through K4 + K5;
  * both capture counts stay at 1 through admissions past the slots, a
    prefix hit and a quarantine forced inside the graph, every static
    buffer in place;
  * ``launch_counts`` equals the capture warm-ups' launches plus each
    capture's launches once per replay;
  * a second engine on the card captures its own graphs without
    touching the first's, and sampled tokens do not depend on the
    submission order.

Every test needs a CUDA card and skips without one (decided in a
fixture, at run time). The file imports no JAX, so it runs on the GPU
machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_decode_graph_cuda.py
"""

import pytest
import torch

from scaletorch_tpu_torch.inference import (
    InferenceEngine,
    SamplingParams,
    StaticStep,
)
from scaletorch_tpu_torch.models import LlamaConfig
from scaletorch_tpu_torch.models import llama as tllama
from scaletorch_tpu_torch.models import qwen3_moe as tmoe
from scaletorch_tpu_torch.ops import _build
from scaletorch_tpu_torch.ops import grouped_mlp as gm

pytestmark = pytest.mark.cuda

DENSE_KW = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=32, qk_norm=True,
                max_position_embeddings=512)
MOE_KW = dict(DENSE_KW, moe_intermediate_size=128, num_experts=8,
              num_experts_per_tok=2, capacity_factor=4.0,
              tie_word_embeddings=False, use_grouped_mlp_kernel=True)
GREEDY = SamplingParams(temperature=0.0)
ENGINE = dict(max_slots=4, max_seq=64, prefill_len=32, page_size=8)
POISON = 255


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine captures CUDA graphs "
                    "and its kernels are CUDA C++ built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def dense_model(dtype):
    cfg = LlamaConfig(**DENSE_KW, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, tllama.LlamaForCausalLM.from_params(
        tllama.init_params(cfg, gen, "cuda"), cfg)


def moe_model(dtype):
    cfg = tmoe.Qwen3MoEConfig(**MOE_KW, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, tmoe.Qwen3MoEForCausalLM(cfg, "cuda").init_weights_(gen)


def prompts(vocab, n=7, seed=3):
    gen = torch.Generator().manual_seed(seed)
    shared = torch.randint(0, vocab - 1, (16,), generator=gen).tolist()
    out = []
    for i in range(n):
        length = int(torch.randint(3, 15, (1,), generator=gen))
        tail = torch.randint(0, vocab - 1, (length,), generator=gen).tolist()
        out.append(shared + tail if i % 3 == 0 else tail)
    return out


def bits(t):
    return t.contiguous().view(torch.uint8)


def hold_replays_to_eager(eng):
    """Before each replay, run the step function eagerly on the same
    buffers and require the replay's outputs to equal it bit for bit in
    the rows the step serves (the other rows read the TRASH page, which
    the eager run has just written). Returns the per-step count of
    replays checked."""
    checked = {"_prefill": "write_mask", "_decode": "active"}
    for name, mask in list(checked.items()):
        step = getattr(eng, name)
        checked[name] = 0

        def replay(step=step, name=name, mask=mask):
            rows = step.inputs[mask].clone()
            eager = [bits(t[rows]) for t in step.run_eager()]
            out = StaticStep.replay(step)
            for a, b in zip(eager, out):
                assert torch.equal(a, bits(b[rows])), (name, checked[name])
            checked[name] += 1
            return out

        step.replay = replay
    return checked


CASES = [("dense", None, torch.float32), ("dense", None, torch.bfloat16),
         ("paged", None, torch.float32), ("paged", None, torch.bfloat16),
         ("paged", False, torch.float32), ("paged", False, torch.bfloat16)]


@pytest.mark.parametrize(
    "layout,kernel,dtype", CASES,
    ids=[f"{lay}-{'gather' if k is False else 'k4'}-"
         f"{'fp32' if d == torch.float32 else 'bf16'}"
         for lay, k, d in CASES])
def test_replay_equals_the_eager_step(cuda, layout, kernel, dtype):
    cfg, model = dense_model(dtype)
    with torch.inference_mode():
        eng = InferenceEngine(model, cfg, sampling=GREEDY,
                              cache_layout=layout, paged_kernel=kernel,
                              **ENGINE)
        checked = hold_replays_to_eager(eng)
        ids = [eng.submit(p, max_new_tokens=10)
               for p in prompts(cfg.vocab_size)]
        results = eng.run()
    assert all(results[i].outcome == "ok" for i in ids)
    assert checked["_decode"] == eng.metrics.decode_steps > 10
    assert checked["_prefill"] == eng.metrics.prefill_calls >= 2
    assert eng.decode_compile_count == eng.prefill_compile_count == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_moe_replay_equals_the_eager_step(cuda, dtype):
    cfg, model = moe_model(dtype)
    with torch.inference_mode():
        _build.reset_launch_counts()
        eng = InferenceEngine(model, cfg, sampling=GREEDY,
                              cache_layout="paged", **ENGINE)
        checked = hold_replays_to_eager(eng)
        ids = [eng.submit(p, max_new_tokens=8)
               for p in prompts(cfg.vocab_size)]
        results = eng.run()
    assert all(results[i].outcome == "ok" for i in ids)
    assert checked["_decode"] == eng.metrics.decode_steps
    layers = cfg.num_hidden_layers
    assert eng._decode.captured_launches == {"paged_decode": layers,
                                             gm.K5_NAME: layers}
    assert eng._prefill.captured_launches == {gm.K5_NAME: layers}


def test_moe_engine_refuses_the_one_hot_movement(cuda):
    cfg, model = moe_model(torch.bfloat16)
    einsum = tmoe.Qwen3MoEConfig(**{**MOE_KW, "moe_dispatch": "einsum"},
                                 dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="nonzero"):
        InferenceEngine(model, einsum, **ENGINE)


def poisoned_forward(model, tokens, cfg, cache, **kw):
    logits, cache = tllama.forward_cached(model, tokens, cfg, cache, **kw)
    bad = (tokens == POISON).any(dim=1)
    return logits.masked_fill(bad[:, None, None], float("nan")), cache


def static_pointers(eng):
    ptrs = {f"{s}.{n}": b.data_ptr() for s in ("_prefill", "_decode")
            for n, b in getattr(eng, s).inputs.items()}
    ptrs.update(k=eng.cache.k.data_ptr(), v=eng.cache.v.data_ptr(),
                tables=eng._tables_dev.data_ptr())
    ptrs.update({f"{s}.out{i}": t.data_ptr()
                 for s in ("_prefill", "_decode")
                 for i, t in enumerate(getattr(eng, s).outputs)})
    return ptrs


def test_one_capture_through_admissions_prefix_hit_and_quarantine(cuda):
    cfg, model = dense_model(torch.bfloat16)
    with torch.inference_mode():
        _build.reset_launch_counts()
        eng = InferenceEngine(model, cfg, sampling=GREEDY,
                              cache_layout="paged",
                              forward_fn=poisoned_forward, **ENGINE)
        before = static_pointers(eng)
        shared = list(range(1, 17))
        first = eng.submit(shared + [20, 21], max_new_tokens=6)
        eng.step()
        hit = eng.submit(shared + [30], max_new_tokens=6)
        bad = eng.submit([5, POISON, 6], max_new_tokens=6)
        more = [eng.submit([40 + i, 41], max_new_tokens=5) for i in range(5)]
        results = eng.run()
    assert results[first].outcome == results[hit].outcome == "ok"
    assert results[hit].prefix_hit
    assert results[bad].outcome == "quarantined"
    assert all(results[i].outcome == "ok" for i in more)
    eng.allocator.check_conservation()
    assert static_pointers(eng) == before
    assert eng.decode_compile_count == eng.prefill_compile_count == 1
    # the counts mean launches on the card: the warm-ups' plus each
    # capture's once per replay
    dec, pre = eng._decode, eng._prefill
    assert dec.replays == eng.metrics.decode_steps
    assert pre.replays == eng.metrics.prefill_calls
    assert dec.captured_launches["paged_decode"] == cfg.num_hidden_layers
    want = (dec.warmup_launches["paged_decode"]
            + dec.captured_launches["paged_decode"] * dec.replays)
    assert _build.launch_counts["paged_decode"] == want


def test_a_second_engine_captures_its_own_graphs(cuda):
    cfg, model = dense_model(torch.bfloat16)
    work = prompts(cfg.vocab_size)
    with torch.inference_mode():
        a = InferenceEngine(model, cfg, sampling=GREEDY,
                            cache_layout="paged", **ENGINE)
        ids = [a.submit(p, max_new_tokens=8) for p in work]
        first = a.run()
        graphs = (a._prefill.graph, a._decode.graph)
        b = InferenceEngine(model, cfg, sampling=GREEDY,
                            cache_layout="paged", **ENGINE)
        assert b._decode.graph is not a._decode.graph
        assert b._decode.stream.cuda_stream != a._decode.stream.cuda_stream
        ids_b = [b.submit(p, max_new_tokens=8) for p in work]
        second = b.run()
        ids_a = [a.submit(p, max_new_tokens=8) for p in work]
        again = a.run()
    assert [first[i].tokens for i in ids] == [second[i].tokens for i in ids_b]
    assert [first[i].tokens for i in ids] == [again[i].tokens for i in ids_a]
    assert (a._prefill.graph, a._decode.graph) == graphs
    for eng in (a, b):
        assert eng.decode_compile_count == eng.prefill_compile_count == 1


def test_sampled_tokens_do_not_depend_on_the_order(cuda):
    cfg, model = dense_model(torch.bfloat16)
    work = prompts(cfg.vocab_size, n=9)
    sampling = SamplingParams(temperature=0.8, top_p=0.9)
    runs = []
    with torch.inference_mode():
        for order in (1, -1):
            eng = InferenceEngine(model, cfg, sampling=sampling,
                                  cache_layout="paged", **ENGINE)
            reqs = list(enumerate(work))[::order]
            ids = {seed: eng.submit(p, max_new_tokens=8, seed=seed)
                   for seed, p in reqs}
            results = eng.run()
            runs.append({seed: results[i].tokens for seed, i in ids.items()})
            assert eng.decode_compile_count == 1
    assert runs[0] == runs[1]
