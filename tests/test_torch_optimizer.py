"""PyTorch port, the optimizer and the learning-rate schedules against the
JAX package's optax ones: ``AdamW`` with the cosine schedule against
``optax.adamw`` (through each package's ``create_optimizer``) over 5
steps, every registered schedule against its optax counterpart, and
``guarded_update`` with a non-finite gradient.

Tolerances: parameters and moments atol 1e-7 / rtol 1e-5 (the port takes
the learning rate and the bias corrections in double precision, optax in
fp32); schedules rtol 1e-5.
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


def test_only_adamw_is_ported():
    for name in ("adam", "sgd", "lamb", "adafactor"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            toptim.create_optimizer(cfg(optimizer_name=name))


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
