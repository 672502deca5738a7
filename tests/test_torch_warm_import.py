"""PyTorch port, the warm prefix exchange on the CPU: a donor engine
serves a shared-prefix request, exports its radix map and frozen pages,
and a fresh engine imports them.

* The port's donor and recipient and the JAX package's give the same map
  (chains, page counts), the same import result and the same greedy
  tokens (a divergence is accepted only at a top-2 margin below 1e-4 of
  the JAX logits).
* The recipient's first shared-prefix request is a prefix hit with the
  donor's tokens, bit for bit; the donor's refcounts never move across
  an export; the allocator stays conserved after an import, a partial
  import (a missing page keeps the chain's prefix) and a refused one (an
  incompatible pool); one static step each, and the pool keeps its
  storage through the import (the bytes are copied in place). bf16 pages
  go across too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.inference import InferenceEngine as JaxEngine
from scaletorch_tpu.inference import SamplingParams as JaxSampling
from scaletorch_tpu.models import llama as jllama
from scaletorch_tpu_torch.inference import InferenceEngine, SamplingParams
from scaletorch_tpu_torch.models import LlamaConfig, LlamaForCausalLM

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
GREEDY = SamplingParams(temperature=0.0)
SYS = [7, 7, 7, 7, 3, 3, 3, 3]  # two full pages at page_size=4
ENGINE = dict(max_slots=2, max_seq=32, prefill_len=12, cache_layout="paged",
              page_size=4)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig(**KW, dtype=jnp.float32)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, tree


def torch_engine(models, dtype=torch.float32, **kw):
    tcfg = LlamaConfig(**KW, dtype=dtype)
    model = LlamaForCausalLM.from_params(models[2], tcfg, device="cpu")
    return InferenceEngine(model, tcfg, sampling=GREEDY, device="cpu",
                           **{**ENGINE, **kw})


def jax_engine(models, **kw):
    return JaxEngine(models[1], models[0],
                     sampling=JaxSampling(temperature=0.0),
                     **{**ENGINE, **kw})


def warmed(eng):
    eng.submit(SYS + [1], max_new_tokens=4)
    eng.run()
    return eng


def export_all(donor):
    pmap = donor.export_prefix_map()
    pages = [p for chain in pmap["chains"] for p in chain["pages"]]
    _meta, contents = donor.export_prefix_pages(pages)
    chains = [(c["tokens"], c["pages"]) for c in pmap["chains"]]
    return pmap, chains, contents


def import_all(recipient, pmap, chains, contents):
    return recipient.import_prefix_pages(
        chains, contents, dtype=pmap["dtype"],
        page_shape=pmap["page_shape"], page_size=pmap["page_size"])


def pool_pointers(eng):
    return [t.data_ptr() for t in eng.cache]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warmed_recipient_serves_the_donors_tokens(models, dtype):
    donor = warmed(torch_engine(models, dtype))
    pmap, chains, contents = export_all(donor)
    assert [c[0] for c in chains] == [SYS] and len(contents) == 2
    recipient = torch_engine(models, dtype)
    before = pool_pointers(recipient)
    result = import_all(recipient, pmap, chains, contents)
    assert result == {"pages": 2, "chains": [SYS]}
    assert pool_pointers(recipient) == before
    snap = recipient.metrics.snapshot()
    assert snap["warm_pages_total"] == 2 and snap["prefix_pages"] == 2
    recipient.allocator.check_conservation()
    # the pages hold the donor's bytes
    for dp, lp in zip(chains[0][1], recipient.radix.match(SYS)[1]):
        assert torch.equal(recipient.cache.k[:, lp], donor.cache.k[:, dp])
        assert torch.equal(recipient.cache.v[:, lp], donor.cache.v[:, dp])
    rid = recipient.submit(SYS + [2], max_new_tokens=4)
    recipient.step()
    assert recipient.metrics.prefix_hits == 1
    assert recipient.metrics.prefill_tokens_saved == len(SYS)
    results = recipient.run()
    rid_d = donor.submit(SYS + [2], max_new_tokens=4)
    assert results[rid].tokens == donor.run()[rid_d].tokens
    assert results[rid].outcome == "ok" and results[rid].prefix_hit
    for eng in (donor, recipient):
        assert eng.decode_compile_count == eng.prefill_compile_count == 1
        eng.allocator.check_conservation()


def test_exchange_matches_the_reference_engine(models):
    outs = []
    for make in (jax_engine, torch_engine):
        donor = warmed(make(models))
        pmap, chains, contents = export_all(donor)
        refs = {p: donor.allocator.refcount(p) for c in chains
                for p in c[1]}
        donor.export_prefix_pages([p for c in chains for p in c[1]] + [99])
        assert refs == {p: donor.allocator.refcount(p) for p in refs}
        recipient = make(models)
        result = import_all(recipient, pmap, chains, contents)
        rid = recipient.submit(SYS + [5, 9], max_new_tokens=6)
        tokens = recipient.run()[rid].tokens
        outs.append((pmap["page_size"], list(pmap["page_shape"]),
                     [c[0] for c in chains], sorted(len(c[1])
                                                    for c in chains),
                     result, recipient.metrics.prefix_hits, tokens))
    j, t = outs
    assert j[:6] == t[:6]
    if j[6] != t[6]:
        k = next(i for i, (a, b) in enumerate(zip(j[6], t[6])) if a != b)
        logits = np.asarray(jllama.forward(
            models[1], jnp.asarray([SYS + [5, 9] + j[6][:k]], jnp.int32),
            models[0]))[0, -1]
        top = np.sort(logits)[-2:]
        assert top[1] - top[0] < MARGIN


def test_partial_and_refused_imports_stay_conserved(models):
    donor = warmed(torch_engine(models))
    pmap, chains, contents = export_all(donor)
    # the second page's bytes never arrived: the chain keeps its prefix
    partial = {chains[0][1][0]: contents[chains[0][1][0]]}
    recipient = torch_engine(models)
    result = import_all(recipient, pmap, chains, partial)
    assert result == {"pages": 1, "chains": [SYS[:4]]}
    recipient.allocator.check_conservation()
    refused = torch_engine(models)
    result = refused.import_prefix_pages(
        chains, contents, dtype=pmap["dtype"],
        page_shape=pmap["page_shape"], page_size=8)
    assert result == {"pages": 0, "chains": []}
    assert refused.allocator.used_count == 0
    dense = torch_engine(models, cache_layout="dense")
    assert dense.export_prefix_map()["chains"] == []
