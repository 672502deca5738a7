"""PyTorch port, sampling: greedy is exact (first maximum, like
``jnp.argmax``); the top-k / top-p filters mask what the JAX package's
mask; sampled tokens (a Gumbel-max over noise hashed from (request
seed, position, vocab index), on the logits' device) are deterministic
per (request seed, position), independent of slot placement, and follow
the filtered distribution. JAX's threefry draws cannot be reproduced in
torch, so sampled paths are never compared token by token with the JAX
package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scaletorch_tpu.inference import sampling as jsampling
from scaletorch_tpu_torch.inference import sampling as tsampling
from scaletorch_tpu_torch.inference import InferenceEngine
from scaletorch_tpu_torch.models import LlamaConfig, init_params


def test_greedy_takes_the_first_maximum_like_jax():
    logits = np.array([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0],
                       [-1.0, -2.0, -0.5, -0.5]], np.float32)
    want = np.asarray(jsampling.sample(
        jnp.asarray(logits), None, jsampling.SamplingParams(temperature=0)))
    got = tsampling.sample(torch.from_numpy(logits), [0] * 3, [0] * 3,
                           tsampling.SamplingParams(temperature=0))
    assert got.tolist() == want.tolist() == [1, 0, 2]


@pytest.mark.parametrize("k", [1, 3, 7])
def test_top_k_masks_like_jax(k):
    logits = np.random.default_rng(k).standard_normal((4, 11)).astype(
        np.float32)
    want = np.asarray(jsampling._filter_top_k(jnp.asarray(logits), k))
    got = tsampling._filter_top_k(torch.from_numpy(logits), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_top_p_masks_like_jax(p):
    logits = 2 * np.random.default_rng(7).standard_normal((4, 11)).astype(
        np.float32)
    want = np.asarray(jsampling._filter_top_p(jnp.asarray(logits), p))
    got = tsampling._filter_top_p(torch.from_numpy(logits), p).numpy()
    np.testing.assert_array_equal(got, want)


def test_draws_depend_on_seed_and_position_only():
    params = tsampling.SamplingParams(temperature=1.0)
    logits = torch.from_numpy(
        np.random.default_rng(1).standard_normal((4, 50)).astype(np.float32))
    seeds, positions = [3, 3, 9, 9], [10, 11, 10, 11]
    a = tsampling.sample(logits, seeds, positions, params)
    assert torch.equal(a, tsampling.sample(logits, seeds, positions, params))
    perm = [2, 0, 3, 1]
    b = tsampling.sample(logits[perm], [seeds[i] for i in perm],
                         [positions[i] for i in perm], params)
    assert torch.equal(b, a[perm])
    # the noise is the hash of (seed, position, vocab index): a row moves
    # with its pair and changes with either half of it
    u = tsampling.uniform_noise(torch.tensor([3, 3, 4]),
                                torch.tensor([10, 11, 10]), 50)
    again = tsampling.uniform_noise(torch.tensor([3]), torch.tensor([10]), 50)
    assert torch.equal(u[0], again[0])
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (2, 1.0), (0, 0.6)])
def test_draws_follow_the_filtered_distribution(top_k, top_p):
    params = tsampling.SamplingParams(temperature=0.8, top_k=top_k,
                                      top_p=top_p)
    logits = torch.tensor([1.0, 0.2, -0.3, 0.7, -1.5])
    n = 4000
    draws = tsampling.sample(logits.expand(n, 5), [5] * n, list(range(n)),
                             params)
    freq = torch.bincount(draws, minlength=5).double() / n
    want = tsampling._filtered_probs(logits[None], params)[0].double()
    # 4000 draws: a standard error under 0.008 per token
    assert float((freq - want).abs().max()) < 0.035
    assert torch.all(freq[want == 0] == 0)


def test_sampling_params_validation():
    for bad in (dict(temperature=-1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5)):
        with pytest.raises(ValueError):
            tsampling.SamplingParams(**bad)
    assert tsampling.SamplingParams(temperature=0).greedy


def test_engine_sampled_tokens_do_not_depend_on_slot_placement():
    cfg = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    sampling = tsampling.SamplingParams(temperature=1.0, top_k=20)

    def serve(neighbours):
        eng = InferenceEngine(params, cfg, max_slots=3, max_seq=24,
                              sampling=sampling, cache_layout="paged",
                              page_size=4, device="cpu")
        for p in neighbours:
            eng.submit(p, max_new_tokens=6, seed=1)
        rid = eng.submit([5, 6, 7], max_new_tokens=6, seed=42)
        return eng.run()[rid].tokens

    alone = serve([])
    assert serve([[1, 2], [9, 9, 9]]) == alone
    assert len(alone) == 6
