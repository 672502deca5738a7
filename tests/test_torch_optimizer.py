"""PyTorch port, the optimizers and the learning-rate schedules against the
JAX package's: ``AdamW`` with the cosine schedule against ``optax.adamw``
(through each package's ``create_optimizer``) over 5 steps; Adam, SGD,
LAMB and Adafactor against the reference's (optax's, and the sharded
Adafactor its ``Trainer`` runs) over 5 steps and a rejected one, in fp32
and with bf16 parameters and state; every registered schedule against
its optax counterpart; and ``guarded_update`` with a non-finite
gradient.

Tolerances: fp32 parameters and state atol 1e-7 / rtol 1e-5 (the port
takes the learning rate and the bias corrections in double precision,
optax in fp32); bf16 ``BF16_ULPS`` (below); schedules rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scaletorch_tpu.trainer import lr_scheduler as jsched
from scaletorch_tpu.trainer import optimizer as joptim
from scaletorch_tpu.trainer.train_step import guarded_update as jguarded
from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
from scaletorch_tpu_torch.models import convert as tconvert
from scaletorch_tpu_torch.trainer import lr_scheduler as tsched
from scaletorch_tpu_torch.trainer import optimizer as toptim

SHAPES = {"embed": (6, 4), "layers": {"w": (2, 4, 3), "norm": (2, 3)},
          "norm": (4,)}


def cfg(**kw):
    base = dict(learning_rate=1e-2, weight_decay=0.1, adam_beta1=0.9,
                adam_beta2=0.95, adam_epsilon=1e-8, total_train_steps=5,
                warmup_steps=2, lr_scheduler_type="cosine",
                min_lr_ratio=0.1)
    return ScaleTorchTPUArguments(**{**base, **kw})


def tree(fn, shapes=SHAPES):
    return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in shapes.items()}


def to_torch(t):
    return {k: to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in t.items()}


def assert_tree_close(t, j):
    for key in j:
        if isinstance(j[key], dict):
            assert_tree_close(t[key], j[key])
        else:
            np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]),
                                       atol=1e-7, rtol=1e-5, err_msg=key)


def grads_for(step):
    rng = np.random.default_rng(100 + step)
    return tree(lambda s: rng.standard_normal(s).astype(np.float32))


def test_adamw_matches_optax_over_five_steps():
    c = cfg()
    rng = np.random.default_rng(0)
    params_np = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    jtx, _ = joptim.create_optimizer(c, include_clip=False)
    ttx, _ = toptim.create_optimizer(c)
    jp = jax.tree.map(jnp.asarray, params_np)
    jstate = jtx.init(jp)
    tp = to_torch(params_np)
    tstate = ttx.init(tp)
    assert tstate["count"].dtype == torch.int64
    for step in range(5):
        g = grads_for(step)
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tp, tstate = ttx.update(to_torch(g), tstate, tp)
        assert_tree_close(tp, jp)
    adam = jstate[0]  # scale_by_adam's state: count, mu, nu
    assert int(tstate["count"]) == int(adam.count) == 5
    assert_tree_close(tstate["mu"], adam.mu)
    assert_tree_close(tstate["nu"], adam.nu)
    assert tstate["mu"]["embed"].dtype == torch.float32


def test_guarded_update_skips_a_nonfinite_gradient():
    c = cfg()
    rng = np.random.default_rng(1)
    params_np = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    jtx, _ = joptim.create_optimizer(c, include_clip=False)
    ttx, _ = toptim.create_optimizer(c)
    jp = jax.tree.map(jnp.asarray, params_np)
    jstate = jtx.init(jp)
    tp = to_torch(params_np)
    tstate = ttx.init(tp)
    # one good step, so the moments are not zero
    g = grads_for(0)
    jp, jstate, _ = jguarded(jtx, jp, jstate, jax.tree.map(jnp.asarray, g),
                             jnp.bool_(True))
    tp, tstate, skipped = toptim.guarded_update(ttx, tp, tstate, to_torch(g),
                                                torch.tensor(True))
    assert float(skipped) == 0.0
    before = {k: to_torch(toptim.tree_map(lambda t: t.numpy().copy(),
                                          tstate[k])) for k in ("mu", "nu")}
    params_before = to_torch(toptim.tree_map(lambda t: t.numpy().copy(), tp))
    bad = grads_for(1)
    bad["layers"]["w"][0, 0, 0] = np.nan
    ok = bool(np.isfinite(np.sqrt(sum(float((x ** 2).sum()) for x in
                                      jax.tree.leaves(bad)))))
    assert not ok
    jp, jstate, jskipped = jguarded(
        jtx, jp, jstate, jax.tree.map(jnp.asarray, bad), jnp.bool_(ok))
    tp, tstate, skipped = toptim.guarded_update(
        ttx, tp, tstate, to_torch(bad), torch.tensor(ok))
    assert float(skipped) == float(jskipped) == 1.0
    assert int(tstate["count"]) == int(jstate[0].count) == 2
    assert_tree_close(tp, params_before)
    assert_tree_close(tp, jp)
    for key in ("mu", "nu"):
        assert_tree_close(tstate[key], before[key])
    # the next step runs at the advanced count, as the reference's does
    g = grads_for(2)
    jp, jstate, _ = jguarded(jtx, jp, jstate, jax.tree.map(jnp.asarray, g),
                             jnp.bool_(True))
    tp, tstate, _ = toptim.guarded_update(ttx, tp, tstate, to_torch(g),
                                          torch.tensor(True))
    assert_tree_close(tp, jp)


# a leaf with its two largest dims >= 128 takes Adafactor's factored
# branch (min_dim_size_to_factor 128); the rest keep the full moment
BIG = {"embed": (160, 128), "layers": {"w": (2, 128, 144), "norm": (2, 16)},
       "norm": (16,)}
NAMES = ("adam", "sgd", "lamb", "adafactor")
# bf16: the largest gap between the port and the reference, in bf16 ulps
# at the larger of |reference| and the leaf's RMS (so that an entry near
# 0 does not count a tiny absolute gap as many ulps); seen 0 (adam, adamw,
# sgd), 0.5 (adafactor: fp32 statistics rounded once),
# 1 (lamb: a norm summed in another order rounds to the neighbouring
# bf16). The control (the same updates with fp32 state) is 2-5 ulps
# away.
BF16_ULPS = 1


def scaled_ulps(got, want):
    """|got - want| in bf16 ulps of max(|want|, rms(want))."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want), np.sqrt(np.mean(want * want)))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(scale, 1e-30))) - 7)
    return float(np.max(np.abs(got - want) / ulp))


def as_np(t):
    return t.detach().to(torch.float32).numpy()


def reference_tx(c, params):
    """The reference's optimizer as its Trainer builds it: adafactor is
    the sharded one with every spec replicated (one device)."""
    if c.optimizer_name == "adafactor":
        from jax.sharding import PartitionSpec as P

        specs = jax.tree.map(lambda _: P(), params)
        return joptim.create_optimizer(c, include_clip=False,
                                       param_specs=specs, axis_sizes={})[0]
    return joptim.create_optimizer(c, include_clip=False)[0]


def run_pair(name, dtype, fp32_state=False, steps=6, reject=3):
    """5 updates and one rejected step (a NaN gradient, ok false) through
    the reference's ``guarded_update`` and the port's, from one draw.
    Returns the port's (params, state) and the reference's, as numpy."""
    c = cfg(optimizer_name=name, total_train_steps=8)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(0)
    params_np = tree(lambda s: 0.05 * rng.standard_normal(s).astype(
        np.float32), BIG)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params_np)
    jtx = reference_tx(c, jp)
    jstate = jtx.init(jp)
    ttx, _ = toptim.create_optimizer(c)
    tp = toptim.tree_map(lambda t: t.to(tdt), to_torch(params_np))
    tstate = ttx.init(toptim.tree_map(lambda t: t.float(), tp)
                      if fp32_state else tp)
    for step in range(steps):
        g = tree(lambda s: np.random.default_rng(100 + step).standard_normal(
            s).astype(np.float32), BIG)
        ok = step != reject
        if not ok:
            g["layers"]["w"][0, 0, 0] = np.nan
        jp, jstate, jskip = jguarded(
            jtx, jp, jstate, jax.tree.map(lambda a: jnp.asarray(a, jdt), g),
            jnp.bool_(ok))
        tp, tstate, skip = toptim.guarded_update(
            ttx, tp, tstate, toptim.tree_map(lambda t: t.to(tdt),
                                             to_torch(g)), torch.tensor(ok))
        assert float(skip) == float(jskip) == float(not ok)
    want_state = tconvert.opt_state_from_jax(
        jax.tree.map(np.asarray, jstate), "cpu")
    return ((params_np, tp, tstate),
            (jax.tree.map(np.asarray, jp), want_state))


def pairs(got, want, prefix=""):
    for key in want:
        if isinstance(want[key], dict):
            yield from pairs(got[key], want[key], f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", got[key], want[key]


def worst_bf16_gap(got_p, got_s, want_p, want_s):
    gaps = [scaled_ulps(as_np(t), np.asarray(w, np.float32))
            for _, t, w in pairs(got_p, want_p)]
    state = {k: v for k, v in got_s.items() if k != "count"}
    gaps += [scaled_ulps(as_np(t.to(torch.bfloat16)), as_np(w))
             for _, t, w in pairs(state, {k: want_s[k] for k in state})]
    return max(gaps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_its_reference(name, dtype):
    """Adam, SGD and LAMB against optax, Adafactor against the reference's
    ``adafactor_sharded`` (replicated specs), over 5 updates and a
    rejected step: the parameters, every state leaf (carried across with
    ``opt_state_from_jax``) and the count. fp32: atol 1e-7 / rtol 1e-5;
    bf16 (state in bf16, as the reference keeps it): ``BF16_ULPS``."""
    (init, tp, tstate), (jp, jstate) = run_pair(name, dtype)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert int(tstate["count"]) == int(jstate["count"]) == 6
    assert sorted(tstate) == sorted(jstate)
    for key in tstate:
        if key == "count":
            continue
        for leaf_name, t, w in pairs(tstate[key], jstate[key]):
            assert t.dtype == w.dtype == tdt, (key, leaf_name)
            assert tuple(t.shape) == tuple(w.shape), (key, leaf_name)
    if name == "adafactor":  # the big leaves took the factored branch
        assert tuple(tstate["v_row"]["layers"]["w"].shape) == (2, 128, 1)
        assert tuple(tstate["v_col"]["layers"]["w"].shape) == (2, 1, 144)
        assert tuple(tstate["v"]["norm"].shape) == (16,)
    if dtype == "float32":
        assert_tree_close(tp, jp)
        for key in tstate:
            if key != "count":
                assert_tree_close(tstate[key], tconvert.params_to_numpy(
                    jstate[key]))
    else:
        assert worst_bf16_gap(tp, tstate, jp, jstate) <= BF16_ULPS


@pytest.mark.parametrize("name", NAMES + ("adamw",))
def test_bf16_control_with_fp32_state_fails_the_limit(name):
    """The bf16 limit is tight enough to see the state's dtype: the same
    updates with fp32 state land more than ``BF16_ULPS`` away."""
    (_, tp, tstate), (jp, jstate) = run_pair(name, "bfloat16",
                                             fp32_state=True)
    assert tstate["v" if name == "adafactor" else
                  "trace" if name == "sgd" else "mu"]["norm"].dtype == \
        torch.float32
    assert worst_bf16_gap(tp, tstate, jp, jstate) > BF16_ULPS


def test_adafactor_matches_optax_adafactor_without_decay():
    """With ``weight_decay`` 0 the reference's Adafactor is
    ``optax.adafactor``'s update (squeezed statistics): 5 steps, fp32,
    parameters atol 1e-7 / rtol 1e-5."""
    c = cfg(optimizer_name="adafactor", weight_decay=0.0)
    rng = np.random.default_rng(3)
    params_np = tree(lambda s: 0.05 * rng.standard_normal(s).astype(
        np.float32), BIG)
    _, schedule = joptim.create_optimizer(c, include_clip=False)
    jtx = optax.adafactor(schedule)
    jp = jax.tree.map(jnp.asarray, params_np)
    jstate = jtx.init(jp)
    ttx, _ = toptim.create_optimizer(c)
    assert ttx.weight_decay_rate is None
    tp = to_torch(params_np)
    tstate = ttx.init(tp)
    for step in range(5):
        g = tree(lambda s: np.random.default_rng(200 + step)
                 .standard_normal(s).astype(np.float32), BIG)
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate,
                                     jp)
        jp = optax.apply_updates(jp, updates)
        tp, tstate = ttx.update(to_torch(g), tstate, tp)
    assert_tree_close(tp, jp)


def test_factored_dims_follow_the_reference():
    from scaletorch_tpu.trainer.factored import _factored_dims
    from scaletorch_tpu_torch.trainer.factored import factored_dims

    for shape in [(4,), (128, 128), (2, 128, 144), (144, 128, 2),
                  (127, 300), (300, 128), (36, 2560, 9728), (5, 5, 5)]:
        for min_dim in (1, 128):
            assert factored_dims(shape, min_dim) == _factored_dims(
                shape, True, min_dim), shape
        assert factored_dims(shape) == _factored_dims(shape, True, 128)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.create_optimizer(cfg(optimizer_name="adagrad"))
    with pytest.raises(ValueError, match="unknown optimizer"):
        joptim.create_optimizer(cfg(optimizer_name="adagrad"))


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("kind", ["constant", "linear", "cosine",
                                  "polynomial", "step", "onecycle"])
def test_schedule_matches_optax(kind, warmup):
    c = cfg(lr_scheduler_type=kind, warmup_steps=warmup,
            total_train_steps=20, step_size=4, step_gamma=0.5,
            poly_power=2.0)
    jfn = jsched.create_lr_scheduler(c)
    tfn = tsched.create_lr_scheduler(c)
    steps = range(0, 26)
    got = np.array([tfn(s) for s in steps])
    want = np.array([float(jfn(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


def test_warmup_ratio_and_unknown_names():
    c = cfg(warmup_steps=0, warmup_ratio=0.25, total_train_steps=8)
    jfn, tfn = jsched.create_lr_scheduler(c), tsched.create_lr_scheduler(c)
    np.testing.assert_allclose([tfn(s) for s in range(10)],
                               [float(jfn(s)) for s in range(10)],
                               rtol=1e-5)
    bad = dataclasses.replace(c, lr_scheduler_type="nope")
    with pytest.raises(KeyError, match="unknown lr scheduler"):
        tsched.create_lr_scheduler(bad)
