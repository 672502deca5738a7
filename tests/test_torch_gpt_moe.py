"""PyTorch port, GPT-MoE (``models/gpt_moe.py``) against the JAX package.

The same parameter tree (the JAX ``init_params`` draw, every matrix
scaled by 10 so greedy continuations move; ``models/convert.
gpt_moe_from_jax``) and the same numpy inputs go through both:

  * ``forward``, MoE and dense: logits <= 2e-5 abs, the aux loss <= 1e-6
    relative; one ``_moe_ffn`` on the same hidden states: output <= 2e-5,
    the routed expert indices and slots equal;
  * ``forward`` with noisy routing (one layer: the JAX scan body is traced
    once, so its ``jax.random.normal`` is replaced by the draw
    ``torch.randn(..., generator=torch.Generator().manual_seed(s))`` that
    the port makes from the same seeded generator);
  * the loss of the minGPT example (NLL + aux) and every gradient:
    <= 1e-5; three of the example's training steps (clip, AdamW,
    warmup-cosine) against its optax chain: every parameter <= 1e-5;
  * ``forward_cached`` through ``teacher_forced_decode`` (dense and
    paged) within the reference's ``ATOL`` 2e-5, and against the full
    forward;
  * greedy ``generate`` and ``generate_recompute``: token for token
    against JAX's and (at a dropless capacity factor) each other;
  * ``estimate_mfu``: equal;
  * the reference's ``TestGPTMoE`` checks (shapes, noise changes the
    logits, the dense variant, greedy determinism, seeded sampling
    reproducible and in range).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scaletorch_tpu.inference import decode as jdecode
from scaletorch_tpu.models import gpt_moe as jg
from scaletorch_tpu.parallel import expert_parallel as jep
from scaletorch_tpu_torch.examples.mingpt import train_mingpt
from scaletorch_tpu_torch.inference import decode as tdecode
from scaletorch_tpu_torch.models import gpt_moe as tg
from scaletorch_tpu_torch.models.convert import (
    flatten_params,
    gpt_moe_from_jax,
    params_from_numpy,
)
from scaletorch_tpu_torch.parallel import expert_parallel as tep
from scaletorch_tpu_torch.trainer.optimizer import AdamW

LOGITS_ATOL = 2e-5
AUX_RTOL = 1e-6
GRAD_ATOL = 1e-5
ATOL = 2e-5  # tests/inference/test_decode_parity.py's
SCALE = 10.0  # on every matrix of the init draw (tg.scale_matrices)

SHAPE = dict(block_size=32, vocab_size=65, n_layer=2, n_head=4, n_embd=64,
             num_experts=4, top_k=2)


def configs(**kw):
    kw = {**SHAPE, **kw}
    return jg.GPTMoEConfig(**kw), tg.GPTMoEConfig(**kw)


def setup(jcfg, tcfg, seed=0):
    """(JAX params, port model) on one tree."""
    params = jg.init_params(jax.random.PRNGKey(seed), jcfg)
    params = tg.scale_matrices(params, SCALE)
    tree = jax.tree.map(np.asarray, params)
    return params, gpt_moe_from_jax(tree, tcfg, device="cpu")


def ids(seed, b=2, s=16, v=65):
    return np.random.default_rng(seed).integers(0, v, (b, s)).astype(np.int32)


@pytest.mark.parametrize("use_moe", [True, False])
def test_forward_matches_the_jax_forward(use_moe):
    jcfg, tcfg = configs(use_moe=use_moe, capacity_factor=1.25)
    params, model = setup(jcfg, tcfg)
    x = ids(1)
    want, want_aux = jg.forward(params, jnp.asarray(x), jcfg, return_aux=True)
    with torch.no_grad():
        got, got_aux = tg.forward(model, torch.from_numpy(x), tcfg,
                                  return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(float(got_aux), float(want_aux),
                               rtol=AUX_RTOL, atol=0)
    if use_moe:
        assert float(got_aux) > 0


def test_moe_ffn_routes_the_same_rows():
    """One MoE layer on the same hidden states: output, aux loss, and the
    routing decisions (expert and slot of every (token, choice))."""
    jcfg, tcfg = configs(capacity_factor=1.25)
    params, model = setup(jcfg, tcfg)
    h = np.random.default_rng(2).standard_normal((3, 16, 64)).astype(
        np.float32)
    jlayer = {k: v[0] for k, v in params["layers"].items()}
    tlayer = {k: v[0] for k, v in model.tree()["layers"].items()}
    want, want_aux = jg._moe_ffn(jnp.asarray(h), jlayer, jcfg, None, None)
    with torch.no_grad():
        got, got_aux = tg._moe_ffn(torch.from_numpy(h), tlayer, tcfg, None,
                                   None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(float(got_aux), float(want_aux),
                               rtol=AUX_RTOL)
    cap = tep.expert_capacity(16, 4, 2, 1.25)
    logits = h @ np.asarray(jlayer["router"])
    jstate, _ = jax.vmap(lambda lg: jep.route_tokens(
        lg, 2, cap, mode="index"))(jnp.asarray(logits))
    tstate, _ = tep.route_tokens(torch.from_numpy(logits), 2, cap,
                                 mode="index")
    for key in ("expert_idx", "slot"):
        np.testing.assert_array_equal(tstate[key].numpy(),
                                      np.asarray(jstate[key]))
    # the row-level capacity drops something at 1.25 on 16 tokens
    assert (tstate["slot"] >= cap).any()


def noise_draws(monkeypatch, seed, shape):
    """The port's draw from a generator seeded with ``seed``, handed to
    the JAX forward in place of ``jax.random.normal``."""
    draw = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.asarray(draw.numpy()))


def test_noisy_forward_matches_on_the_same_draw(monkeypatch):
    jcfg, tcfg = configs(n_layer=1, capacity_factor=1.25)
    params, model = setup(jcfg, tcfg)
    x = ids(3)
    noise_draws(monkeypatch, 7, (2, 16, 4))
    want, want_aux = jg.forward(params, jnp.asarray(x), jcfg,
                                noise_key=jax.random.PRNGKey(0),
                                return_aux=True)
    with torch.no_grad():
        got, got_aux = tg.forward(
            model, torch.from_numpy(x), tcfg,
            generator=torch.Generator().manual_seed(7), return_aux=True)
        plain = tg.forward(model, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_allclose(float(got_aux), float(want_aux),
                               rtol=AUX_RTOL)
    assert not np.allclose(got.numpy(), plain.numpy())


def example_loss_jax(params, x, y, cfg, key):
    logits, aux = jg.forward(params, x, cfg, noise_key=key, return_aux=True)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.take_along_axis(logp, y[..., None], axis=-1).mean() + aux


@pytest.mark.parametrize("case", ["moe", "moe_noisy", "dense"])
def test_loss_and_gradients_match(case, monkeypatch):
    noisy = case == "moe_noisy"
    jcfg, tcfg = configs(use_moe=case != "dense", capacity_factor=1.25,
                         n_layer=1 if noisy else 2)
    params, model = setup(jcfg, tcfg)
    x, y = ids(4), ids(5)
    key = None
    if noisy:
        noise_draws(monkeypatch, 11, (2, 16, 4))
        key = jax.random.PRNGKey(0)
    want_loss, want_grads = jax.value_and_grad(example_loss_jax)(
        params, jnp.asarray(x), jnp.asarray(y), jcfg, key)

    for leaf in model.parameters():
        leaf.requires_grad_(True)
    gen = torch.Generator().manual_seed(11) if noisy else None
    loss, _ = train_mingpt.loss_fn(model, torch.from_numpy(x),
                                   torch.from_numpy(y), tcfg, gen)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-6)
    names = [n for n, _ in model.named_parameters()]
    # without noise the noise projection gets no gradient: JAX's is 0
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        model.parameters(),
        torch.autograd.grad(loss, list(model.parameters()),
                            allow_unused=True))]
    flat_want = {f"layers.{k}": v for k, v in want_grads["layers"].items()}
    flat_want.update((k, v) for k, v in want_grads.items() if k != "layers")
    assert set(names) == set(flat_want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(flat_want[name]),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


def mingpt_tx(lr, warmup, steps):
    """The JAX minGPT example's optimizer, as its main builds it."""
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup,
                                               max(steps, warmup + 1))
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched))


@pytest.mark.parametrize("case", ["moe", "moe_noisy", "dense"])
def test_three_mingpt_train_steps_match_optax(case, monkeypatch):
    """The port's minGPT ``train_step`` (the clip at global norm 1.0,
    AdamW with optax's decay of 1e-4 on every leaf, the warmup-cosine
    schedule) against the JAX example's step on one one-layer tree: the
    NLL and every parameter after each of 3 steps <= 1e-5. Warmup 1, so
    the first step runs at lr 0, the second at the peak and the third on
    the cosine; the scaled tree's gradients are clipped at every step."""
    lr, warmup, steps = 3e-3, 1, 3
    noisy = case == "moe_noisy"
    jcfg, tcfg = configs(use_moe=case != "dense", capacity_factor=1.25,
                         n_layer=1)
    params = tg.scale_matrices(jg.init_params(jax.random.PRNGKey(0), jcfg),
                               SCALE)
    tx = mingpt_tx(lr, warmup, steps)
    opt_state = tx.init(params)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    opt = AdamW(train_mingpt.warmup_cosine(lr, warmup, steps))
    state = opt.init(tparams)
    train_step, _ = train_mingpt.make_steps(tcfg, opt)
    key = None
    if noisy:  # every step draws the same noise on both sides
        noise_draws(monkeypatch, 11, (2, 16, 4))
        key = jax.random.PRNGKey(0)

    def jax_loss(p, x, y):
        logits, aux = jg.forward(p, x, jcfg, noise_key=key, return_aux=True)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        nll = -jnp.take_along_axis(logp, y[..., None], axis=-1).mean()
        return nll + aux, nll

    jax_step = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))
    for step in range(steps):
        x, y = ids(20 + step), ids(30 + step)
        (_, nll), grads = jax_step(params, jnp.asarray(x), jnp.asarray(y))
        assert float(optax.global_norm(grads)) > 1.0  # the clip acts
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        gen = torch.Generator().manual_seed(11) if noisy else None
        got = train_step(tparams, state, torch.from_numpy(x),
                         torch.from_numpy(y), gen)
        np.testing.assert_allclose(float(got), float(nll), atol=GRAD_ATOL,
                                   rtol=0)
        want = flatten_params(jax.tree.map(np.asarray, params))
        mine = flatten_params(tparams)
        assert set(mine) == set(want)
        for name, leaf in mine.items():
            np.testing.assert_allclose(
                leaf.detach().numpy(), want[name], atol=GRAD_ATOL, rtol=0,
                err_msg=f"{name} after step {step}")
    assert int(state["count"]) == steps


@pytest.mark.parametrize("cf", [4.0, 1.25])
def test_teacher_forced_decode_matches(cf):
    """``forward_cached`` (dense, and paged through the gather path) under
    teacher forcing, against the JAX package's harnesses; at the dropless
    capacity factor also against the full forward."""
    jcfg, tcfg = configs(capacity_factor=cf)
    params, model = setup(jcfg, tcfg)
    x = ids(6, s=12)
    want = np.asarray(jdecode.teacher_forced_decode(
        params, jcfg, jnp.asarray(x), max_seq=32, prefill_len=5))
    want_paged = np.asarray(jdecode.teacher_forced_decode_paged(
        params, jcfg, jnp.asarray(x), page_size=4, max_seq=32,
        prefill_len=5))
    got = tdecode.teacher_forced_decode(model, tcfg, torch.from_numpy(x),
                                        max_seq=32, prefill_len=5)
    got_paged = tdecode.teacher_forced_decode_paged(
        model, tcfg, torch.from_numpy(x), page_size=4, max_seq=32,
        prefill_len=5)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_paged.numpy(), want_paged, atol=ATOL,
                               rtol=0)
    if cf == 4.0:
        with torch.no_grad():
            full = tg.forward(model, torch.from_numpy(x), tcfg).numpy()
        np.testing.assert_allclose(got.numpy(), full, atol=ATOL, rtol=0)


@pytest.mark.parametrize("cf", [4.0, 1.25])
def test_greedy_generation_matches_token_for_token(cf):
    jcfg, tcfg = configs(capacity_factor=cf)
    params, model = setup(jcfg, tcfg)
    prompt = np.array([[1, 2, 3], [9, 8, 7]], np.int32)
    kw = dict(max_new_tokens=12, temperature=0.0)
    want = np.asarray(jg.generate(params, jnp.asarray(prompt), jcfg, **kw))
    want_re = np.asarray(jg.generate_recompute(params, jnp.asarray(prompt),
                                               jcfg, **kw))
    got = tg.generate(model, torch.from_numpy(prompt), tcfg, **kw).numpy()
    got_re = tg.generate_recompute(model, torch.from_numpy(prompt), tcfg,
                                   **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_re, want_re)
    assert got.shape == (2, 15)
    assert len(set(got[0, 3:].tolist())) > 1  # the continuation moves
    if cf == 4.0:  # dropless: the two samplers compute one function
        np.testing.assert_array_equal(got, got_re)


@pytest.mark.parametrize("use_moe", [True, False])
def test_estimate_mfu_equals_the_reference(use_moe):
    jcfg, tcfg = configs(use_moe=use_moe)
    params, model = setup(jcfg, tcfg)
    want = jg.estimate_mfu(jcfg, params, tokens_per_second=1e4,
                           peak_flops=197e12)
    assert tg.estimate_mfu(tcfg, model, 1e4, 197e12) == want
    assert tg.estimate_mfu(tcfg, model.tree(), 1e4, 197e12) == want
    assert 0 < want < 1


# ---- the reference's TestGPTMoE, on the port ---------------------------------
MOE_CFG = tg.GPTMoEConfig(**SHAPE, capacity_factor=4.0)


@pytest.fixture(scope="module")
def zoo():
    model = tg.GPTMoEForCausalLM(MOE_CFG, device="cpu")
    model.init_weights_(torch.Generator().manual_seed(0))
    x = torch.randint(0, 65, (2, 16), generator=torch.Generator()
                      .manual_seed(1))
    return model, x


def test_forward_shapes_and_aux(zoo):
    model, x = zoo
    with torch.no_grad():
        logits, aux = model(x, return_aux=True)
    assert logits.shape == (2, 16, 65)
    assert torch.isfinite(logits).all() and float(aux) > 0


def test_noisy_routing_changes_logits(zoo):
    model, x = zoo
    with torch.no_grad():
        det = model(x)
        noisy = model(x, generator=torch.Generator().manual_seed(2))
        again = model(x)
    assert not torch.allclose(det, noisy)
    assert torch.equal(det, again)


def test_dense_variant():
    cfg = tg.GPTMoEConfig(**{**SHAPE, "use_moe": False})
    params = tg.GPTMoE(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    assert "mlp_fc" in params["layers"] and "router" not in params["layers"]
    logits = tg.GPTMoE(cfg)(params, torch.zeros(1, 8, dtype=torch.long))
    assert logits.shape == (1, 8, 65)


def test_generate_greedy_deterministic(zoo):
    model, _ = zoo
    prompt = torch.tensor([[1, 2, 3]])
    out1 = tg.generate(model, prompt, MOE_CFG, max_new_tokens=5,
                       temperature=0.0)
    out2 = tg.generate(model, prompt, MOE_CFG, max_new_tokens=5,
                       temperature=0.0)
    assert out1.shape == (1, 8)
    assert torch.equal(out1, out2) and torch.equal(out1[:, :3], prompt)


def test_generate_sampling_is_seeded_and_in_range(zoo):
    model, _ = zoo
    prompt = torch.tensor([[1, 2, 3]])

    def draw(seed):
        return tg.generate(model, prompt, MOE_CFG, max_new_tokens=8,
                           temperature=1.0,
                           generator=torch.Generator().manual_seed(seed))

    out = draw(7)
    assert out.shape == (1, 11)
    assert ((out >= 0) & (out < 65)).all()
    assert torch.equal(out, draw(7))
    assert torch.equal(out[:, :3], prompt)
