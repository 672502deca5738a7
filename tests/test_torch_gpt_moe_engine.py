"""PyTorch port, the ``InferenceEngine`` serving GPT-MoE against the JAX
engine on the same weights and requests (CPU).

A 2-layer GPT-MoE (the JAX draw scaled by 10, so continuations move)
serves five greedy requests on two slots, two of them sharing a
two-page prompt prefix:

  * dense and paged engines: tokens equal to the JAX engine's at the
    dropless capacity factor 4.0, with and without the prefix cache;
  * at the default 1.25 with one ``prefill_len`` and the prefix cache
    off, equal too: each batch row is a routing group over the whole
    static prompt buffer, so the padded tail competes for capacity in
    both packages alike;
  * paged (gather) == dense, token for token, at 1.25 with the prefix
    cache off and at 4.0 with it on;
  * one compile of each step on both sides;
  * ``max_seq`` past the position table (``block_size``) refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.inference import InferenceEngine as JaxEngine
from scaletorch_tpu.inference import SamplingParams as JaxSampling
from scaletorch_tpu.models import gpt_moe as jg
from scaletorch_tpu_torch.inference import InferenceEngine, SamplingParams
from scaletorch_tpu_torch.models import gpt_moe as tg
from tests.test_torch_one_thread import one_torch_thread  # noqa: F401


SHAPE = dict(block_size=32, vocab_size=65, n_layer=2, n_head=4, n_embd=64,
             num_experts=4, top_k=2)
PAGE = 4
ENGINE = dict(max_slots=2, max_seq=32, prefill_len=16, page_size=PAGE)


def tree(cf):
    jcfg = jg.GPTMoEConfig(**SHAPE, capacity_factor=cf)
    params = jg.init_params(jax.random.PRNGKey(3), jcfg)
    params = tg.scale_matrices(params, 10.0)
    return jcfg, params, tg.GPTMoEConfig(**SHAPE, capacity_factor=cf)


def schedule():
    """Five requests: the fourth shares the first's two-page prefix."""
    rng = np.random.default_rng(5)

    def toks(n):
        return rng.integers(0, 65, n).tolist()

    prefix = toks(2 * PAGE)
    return [(prefix + toks(3), 6), (toks(12), 5), (toks(6), 7),
            (prefix + toks(2), 6), (toks(7), 4)]


def serve(eng):
    ids = [eng.submit(p, max_new_tokens=n) for p, n in schedule()]
    results = eng.run()
    assert eng.decode_compile_count == eng.prefill_compile_count == 1
    out = [results[i] for i in ids]
    assert all(r.outcome == "ok" for r in out)
    return [r.tokens for r in out], eng


def port_engine(tcfg, params, layout, prefix_cache):
    return InferenceEngine(jax.tree.map(np.asarray, params), tcfg,
                           sampling=SamplingParams(temperature=0.0),
                           cache_layout=layout, prefix_cache=prefix_cache,
                           device="cpu", **ENGINE)


@pytest.mark.parametrize("cf,prefix_cache", [(4.0, True), (4.0, False),
                                             (1.25, False)])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_matches_the_jax_engine(layout, cf, prefix_cache):
    jcfg, params, tcfg = tree(cf)
    want, je = serve(JaxEngine(params, jcfg,
                               sampling=JaxSampling(temperature=0.0),
                               cache_layout=layout,
                               prefix_cache=prefix_cache, **ENGINE))
    got, te = serve(port_engine(tcfg, params, layout, prefix_cache))
    assert got == want
    assert any(len(set(t)) > 1 for t in got)  # the continuations move
    if layout == "paged":
        assert te.metrics.prefix_hits == je.metrics.prefix_hits
        assert (te.metrics.prefix_hits >= 1) == prefix_cache
        te.allocator.check_conservation()


@pytest.mark.parametrize("cf,prefix_cache", [(4.0, True), (1.25, False)])
def test_paged_equals_dense(cf, prefix_cache):
    _, params, tcfg = tree(cf)
    dense, _ = serve(port_engine(tcfg, params, "dense", False))
    paged, _ = serve(port_engine(tcfg, params, "paged", prefix_cache))
    assert paged == dense


def test_max_seq_past_the_position_table_is_refused():
    _, params, tcfg = tree(4.0)
    with pytest.raises(ValueError, match="block_size"):
        InferenceEngine(jax.tree.map(np.asarray, params), tcfg, max_slots=2,
                        max_seq=SHAPE["block_size"] + 1, device="cpu")


def test_positions_past_the_table_read_its_last_row():
    """A padded prefill row past ``block_size`` reads the table's last
    row, as JAX's clamped gather does (its K/V are never read)."""
    jcfg, params, tcfg = tree(4.0)
    model = tg.GPTMoEForCausalLM.from_params(jax.tree.map(np.asarray, params),
                                             tcfg, device="cpu")
    positions = np.array([[28, 29, 30, 31, 32, 33]], np.int32)
    x = np.array([[1, 2, 3, 4, 5, 6]], np.int32)
    jcache = jg.init_cache(jcfg, 1)
    want, _ = jg.forward_cached(params, jnp.asarray(x), jcfg, jcache,
                                positions=jnp.asarray(positions))
    cache = tg.init_cache(tcfg, 1, device="cpu")
    got, _ = tg.forward_cached(model, torch.from_numpy(x), tcfg, cache,
                               positions=torch.from_numpy(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
