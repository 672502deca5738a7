"""PyTorch port, KV-cache bookkeeping: the same random admit / retain /
release / insert / match / evict schedules drive the JAX package's
``PageAllocator``/``RadixPrefixCache`` and the port's in lockstep.
Returned pages, refcounts, free-list order, the radix tree (with its LRU
clocks), eviction results and ``check_conservation`` must be identical
after every operation. Also the cache sizing helpers against the JAX
package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.inference import kv_cache as jkv
from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu_torch.inference import kv_cache as tkv
from scaletorch_tpu_torch.models import llama as tllama

PAGE = 4
NUM_PAGES = 40


def tree_state(node):
    return sorted(
        (chunk, child.page, child.last_used, tree_state(child))
        for chunk, child in node.children.items())


def allocator_state(al):
    return list(al._free), dict(al._ref), al.free_count, al.used_count


def conservation(al):
    try:
        al.check_conservation()
        return "ok"
    except AssertionError as e:
        return str(e)


def make_pair(module):
    al = module.PageAllocator(NUM_PAGES)
    radix = module.RadixPrefixCache(PAGE, al.retain, al.release, al.refcount)
    return al, radix


def run(side, op, arg):
    al, radix = side
    try:
        if op == "alloc":
            return al.alloc(arg)
        if op == "retain":
            return al.retain(arg)
        if op == "release":
            return al.release(arg)
        if op == "insert":
            tokens, pages = arg
            return radix.insert(tokens, pages)
        if op == "match":
            return radix.match(arg)
        if op == "evict":
            return radix.evict(arg)
        if op == "refcount":
            return al.refcount(arg)
    except ValueError as e:
        return ("ValueError", str(e))
    raise AssertionError(op)


@pytest.mark.parametrize("seed", range(6))
def test_random_schedules_match_the_jax_bookkeeping(seed):
    rng = np.random.default_rng(seed)
    jside, tside = make_pair(jkv), make_pair(tkv)
    # a few shared prompt heads so that matches, first-writer-wins inserts
    # and inner-node eviction all happen
    heads = [rng.integers(0, 5, 3 * PAGE).tolist() for _ in range(3)]
    held = []  # slot references taken by the schedule
    for _ in range(300):
        op = rng.choice(["alloc", "retain", "release", "insert", "match",
                         "evict", "refcount", "bad_release"])
        arg = None
        if op == "alloc":
            arg = int(rng.integers(0, 5))
        elif op in ("retain", "release", "refcount"):
            if not held:
                continue
            arg = held[int(rng.integers(len(held)))]
        elif op == "bad_release":
            free = list(tside[0]._free)
            if not free:
                continue
            op, arg = "release", free[int(rng.integers(len(free)))]
        elif op in ("insert", "match"):
            head = heads[int(rng.integers(len(heads)))]
            n = int(rng.integers(1, 4)) * PAGE
            tokens = head[:n] + rng.integers(0, 5, int(rng.integers(0, 6))
                                             ).tolist()
            if op == "insert":
                tokens = tokens[: (len(tokens) // PAGE) * PAGE]
                pages = jside[0].alloc(len(tokens) // PAGE)
                tpages = tside[0].alloc(len(tokens) // PAGE)
                assert pages == tpages
                if pages is None:
                    continue
                held.extend(pages)
                arg = (tokens, pages)
            else:
                arg = tokens
        elif op == "evict":
            arg = int(rng.integers(0, 6))
        got_j, got_t = run(jside, op, arg), run(tside, op, arg)
        assert got_j == got_t, (op, arg)
        if op == "alloc" and got_t:
            held.extend(got_t)
        if op == "retain" and got_t is None:
            held.append(arg)
        if op == "release" and arg in held and got_t is None:
            held.remove(arg)
        assert allocator_state(jside[0]) == allocator_state(tside[0])
        assert tree_state(jside[1].root) == tree_state(tside[1].root)
        assert conservation(jside[0]) == conservation(tside[0]) == "ok"
        assert len(jside[1]) == len(tside[1])
        assert sorted(jside[1].chains()) == sorted(tside[1].chains())


def test_allocator_rejects_like_the_reference():
    for module in (jkv, tkv):
        with pytest.raises(ValueError):
            module.PageAllocator(1)
        al = module.PageAllocator(4)
        with pytest.raises(ValueError):
            al.alloc(-1)
        assert al.alloc(4) is None and al.capacity == 3
    with pytest.raises(ValueError):
        tkv.RadixPrefixCache(0, al.retain, al.release, al.refcount)


CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=16)


@pytest.mark.parametrize("layout,extra", [
    ("dense", {}), ("paged", {"page_size": 4}),
    ("paged", {"page_size": 5, "num_pages": 9})])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_sizing_matches_jax(layout, extra, dtype):
    jcfg = jllama.LlamaConfig(**CFG)
    tcfg = tllama.LlamaConfig(**CFG)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    assert tkv.kv_cache_bytes(tcfg, 3, 30, tdt, layout=layout, **extra) \
        == jkv.kv_cache_bytes(jcfg, 3, 30, jdt, layout=layout, **extra)
    assert tkv.kv_cache_shape(tcfg, 3, 30) == jkv.kv_cache_shape(jcfg, 3, 30)
    assert tkv.paged_kv_cache_shape(tcfg, 9, 4) \
        == jkv.paged_kv_cache_shape(jcfg, 9, 4)


def test_init_caches_on_cpu_and_default_device():
    cfg = tllama.LlamaConfig(**CFG, dtype=torch.float32)
    dense = tkv.init_kv_cache(cfg, 2, 16, device="cpu")
    pool = tkv.init_paged_kv_cache(cfg, 9, 4, dtype=torch.bfloat16,
                                   device="cpu")
    assert dense.k.shape == (2, 2, 2, 16, 16) and dense.k.dtype == torch.float32
    assert pool.v.shape == (2, 9, 2, 4, 16) and pool.v.dtype == torch.bfloat16
    assert not dense.k.any() and not pool.k.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tkv.init_kv_cache(cfg, 2, 16)
