"""PyTorch port, LeNet-5 (``models/lenet.py``, NCHW) and the MNIST
example's step against the JAX package (NHWC).

  * ``forward`` on the same parameters (``models/convert.lenet_from_jax``:
    HWIO -> OIHW, ``fc1``'s rows from the (H, W, C) flatten to (C, H, W))
    and the same images: logits <= 1e-5;
  * three steps of the example's train step (Adadelta, per-epoch StepLR
    at 2 steps an epoch, so the third step runs at lr · gamma) against the
    JAX example's optax composition: loss each step and the parameters
    after it <= 1e-5;
  * the port's own init: shapes and the fan-in bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scaletorch_tpu.models import lenet as jl
from scaletorch_tpu_torch.examples.mnist import train_mnist
from scaletorch_tpu_torch.models import lenet as tl
from scaletorch_tpu_torch.models.convert import lenet_from_jax
from scaletorch_tpu_torch.trainer.optimizer import Adadelta

TOL = 1e-5


def images(seed, b=8):
    x, y = train_mnist.synthetic_digits(b, seed=seed)
    return x, y  # NHWC float32, int32 labels


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_the_jax_forward(seed):
    params = jl.init_params(jax.random.PRNGKey(seed))
    tparams = lenet_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    x, _ = images(seed + 10)
    want = np.asarray(jl.forward(params, jnp.asarray(x)))
    got = tl.forward(tparams, nchw(x)).numpy()
    assert got.shape == (8, 10)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_three_adadelta_steplr_steps_match_optax():
    lr, gamma, steps_per_epoch = 1.0, 0.7, 2
    params = jl.init_params(jax.random.PRNGKey(0))
    sched = optax.exponential_decay(lr, transition_steps=1, decay_rate=gamma,
                                    staircase=True)
    tx = optax.adadelta(learning_rate=lambda c: sched(c // steps_per_epoch))
    state = tx.init(params)

    def loss_fn(p, x, y):
        logp = jax.nn.log_softmax(jl.forward(p, x))
        return -jnp.take_along_axis(logp, y[:, None], axis=1).mean()

    tparams = lenet_from_jax(jax.tree.map(np.asarray, params), device="cpu",
                             requires_grad=True)
    opt = Adadelta(train_mnist.step_lr(lr, gamma, steps_per_epoch))
    tstate = opt.init(tparams)
    train_step, eval_step = train_mnist.make_steps(opt)
    for step in range(3):
        x, y = images(100 + step, b=16)
        loss, grads = jax.value_and_grad(loss_fn)(params, jnp.asarray(x),
                                                  jnp.asarray(y))
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        got = train_step(tparams, tstate, nchw(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(got), float(loss), atol=TOL)
        want = lenet_from_jax(jax.tree.map(np.asarray, params), device="cpu")
        for name, t in tparams.items():
            np.testing.assert_allclose(t.detach().numpy(),
                                       want[name].numpy(), atol=TOL, rtol=0,
                                       err_msg=f"{name} after step {step}")
    assert int(tstate["count"]) == 3
    x, y = images(7, b=16)
    assert 0 <= int(eval_step(tparams, nchw(x), torch.from_numpy(y))) <= 16


def test_init_shapes_and_bounds():
    params = tl.LeNet().init(torch.Generator().manual_seed(0), device="cpu")
    jparams = jl.init_params(jax.random.PRNGKey(0))
    converted = lenet_from_jax(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    for name, t in params.items():
        assert t.shape == converted[name].shape
    assert float(params["conv1"].abs().max()) <= 1 / 5.0  # fan-in 25
    assert float(params["fc1"].abs().max()) <= 1 / 16.0  # fan-in 256
