"""PyTorch port, ResNet-18/34 (``models/resnet.py``, NCHW) and the ImageNet
example (``examples/imagenet/dist_train.py``) against the JAX package
(NHWC), fp32, width 8, 10 classes:

  * the train-mode logits and the new BatchNorm state, and the eval-mode
    logits (from a non-trivial running state), at 32² and 33² (the
    "SAME" windows pad asymmetrically at even sizes, symmetrically at
    odd ones), against ``scaletorch_tpu.models.resnet.forward`` on the
    same parameters (``convert.resnet_from_jax``), <= 1e-4;
  * ``resnet_from_jax`` and ``resnet_to_jax`` round-trip bit for bit;
  * three steps of the example's train step (SGD with momentum after
    decoupled weight decay, a staircase StepLR that decays after two
    steps) against the JAX example's optax chain: the loss of each step
    and the parameters and BN state after the third, <= 1e-4;
  * the example over two gloo ranks (sync-BN, each rank half of every
    global batch) against one process: every step's loss, the final
    parameters and BN state after four steps (<= 1e-4: the two summation
    orders drift ~3x a step from ~7e-7 after the first), the validation
    numbers; the loss falls over two epochs;
  * ``--checkpoint-dir`` writes ``model_best.pkl`` in the JAX layout, at
    the best epoch's top-1.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scaletorch_tpu.models import resnet as jr
from scaletorch_tpu_torch.examples.imagenet import dist_train
from scaletorch_tpu_torch.models import resnet as tr
from scaletorch_tpu_torch.models.convert import resnet_from_jax, resnet_to_jax
from tests.test_torch_one_thread import one_torch_thread  # noqa: F401
from tests.torch_dist_harness import run_ranks


TOL = 1e-4
WIDTH, CLASSES = 8, 10
EXAMPLE = ["--device", "cpu", "--image-size", "32", "--num-classes", "10",
           "--width", "8", "--epochs", "2", "--train-samples", "64",
           "--val-samples", "32", "-b", "16", "--print-freq", "100"]
# two epochs of two steps: at lr 0.1 two summation orders drift apart by
# ~3x a step from ~7e-7 after the first, so four steps stay within TOL
DP_EXAMPLE = [a if a != "64" else "32" for a in EXAMPLE]


def cfgs(depth, size):
    return (jr.ResNetConfig(depth=depth, num_classes=CLASSES, width=WIDTH,
                            image_size=size),
            tr.ResNetConfig(depth=depth, num_classes=CLASSES, width=WIDTH,
                            image_size=size))


def images(size, n=4, seed=0):
    x, y = dist_train.synthetic_images(n, CLASSES, size, seed=seed)
    return x, y  # NHWC float32, int32 labels


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def close(a, b, tol=TOL):
    jax.tree.map(lambda u, v: np.testing.assert_allclose(
        np.asarray(u), np.asarray(v), atol=tol, rtol=0), a, b)


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("depth", [18, 34])
def test_forward_and_bn_state_match_the_jax_forward(depth, size):
    jcfg, tcfg = cfgs(depth, size)
    params, state = jr.init_params(jax.random.key(depth), jcfg)
    tp, ts = resnet_from_jax(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, state), device="cpu")
    x, _ = images(size)
    want, new_state = jax.jit(lambda p, s, x: jr.forward(p, s, x, jcfg))(
        params, state, jnp.asarray(x))
    got, got_state = tr.forward(tp, ts, nchw(x), tcfg, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)
    close(resnet_to_jax(tp, got_state)[1], new_state)
    # eval mode reads the running statistics the train step left
    want = jax.jit(lambda p, s, x: jr.forward(p, s, x, jcfg, train=False))(
        params, new_state, jnp.asarray(x))[0]
    got = tr.forward(tp, got_state, nchw(x), tcfg, train=False)[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)


def test_same_padding_is_xlas():
    # 7x7/2 on 224 pads (2, 3); 3x3/2 on an even size (0, 1), odd (1, 1)
    assert tr.same_pads(224, 7, 2) == (2, 3)
    assert tr.same_pads(112, 3, 2) == (0, 1)
    assert tr.same_pads(33, 3, 2) == (1, 1)
    assert tr.same_pads(56, 3, 1) == (1, 1)


@pytest.mark.parametrize("depth", [18, 34])
def test_the_jax_tree_round_trips(depth):
    jcfg, tcfg = cfgs(depth, 32)
    params, state = jax.tree.map(np.asarray, jr.init_params(
        jax.random.key(1), jcfg))
    back = resnet_to_jax(*resnet_from_jax(params, state, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure((params, state))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), back,
                 (params, state))
    # the port's own draw has the reference's leaves and shapes
    mine = resnet_to_jax(*tr.init_params(torch.Generator().manual_seed(0),
                                         tcfg, device="cpu"))
    assert jax.tree.map(np.shape, mine) == jax.tree.map(np.shape,
                                                        (params, state))
    assert tcfg.num_params() == jcfg.num_params()


def test_three_sgd_steps_match_the_jax_examples_chain():
    jcfg, tcfg = cfgs(18, 32)
    lr, momentum, wd, steps_per_epoch, step_epochs = 0.1, 0.9, 1e-4, 1, 2
    params, state = jr.init_params(jax.random.key(0), jcfg)
    schedule = optax.exponential_decay(
        lr, transition_steps=step_epochs * steps_per_epoch, decay_rate=0.1,
        staircase=True)
    tx = optax.chain(optax.add_decayed_weights(wd),
                     optax.sgd(schedule, momentum=momentum))
    opt_state = tx.init(params)

    @jax.jit
    def jstep(params, state, opt_state, x, y):
        def loss_fn(p, s):
            logits, new_s = jr.forward(p, s, x, jcfg, train=True)
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits.astype(jnp.float32), y).mean()
            return ce, new_s

        (loss, new_s), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, state)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_s, opt_state, loss

    tp, ts = resnet_from_jax(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, state), device="cpu",
                             requires_grad=True)
    args = dist_train.parse_args(["--lr", str(lr), "--wd", str(wd),
                                  "--lr-step-epochs", str(step_epochs)])
    optimizer = dist_train.make_optimizer(args, steps_per_epoch)
    t_state = optimizer.init(tp)
    train_step, _ = dist_train.make_steps(tcfg, optimizer, wd, 8)
    for i in range(3):
        x, y = images(32, n=8, seed=20 + i)
        params, state, opt_state, loss = jstep(params, state, opt_state,
                                               jnp.asarray(x), jnp.asarray(y))
        got, ts, _, _ = train_step(tp, ts, t_state, nchw(x),
                                   torch.from_numpy(y))
        assert abs(float(got) - float(loss)) <= TOL
    close(resnet_to_jax(tp, ts), (params, state))


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    out = dist_train.run(EXAMPLE + ["--checkpoint-dir", str(ckpt)])
    return out, ckpt


def test_two_gloo_ranks_train_what_one_process_trains(tmp_path):
    one = dist_train.run(DP_EXAMPLE)
    ranks = run_ranks(tmp_path, 2, "imagenet_example", {"argv": DP_EXAMPLE},
                      timeout=120.0)
    want = resnet_to_jax(one["params"], one["bn_state"])
    for r in ranks:
        assert r["world"] == 2
        np.testing.assert_allclose(r["losses"], one["losses"], atol=TOL,
                                   rtol=0)
        close(r["trees"], want)
        for a, b in zip(r["val"], one["val"]):
            assert a["samples"] == b["samples"]
            assert abs(a["acc1"] - b["acc1"]) <= 100.0 / b["samples"]


def test_the_loss_falls(world1):
    one, _ = world1
    assert one["epoch_losses"][-1] < one["epoch_losses"][0]
    assert all(np.isfinite(one["losses"]))


def test_the_best_checkpoint_is_written_in_the_jax_layout(world1):
    one, ckpt = world1
    with open(ckpt / "model_best.pkl", "rb") as f:
        saved = pickle.load(f)
    best = max(v["acc1"] for v in one["val"])
    assert saved["acc1"] == best
    assert saved["epoch"] == max(i for i, v in enumerate(one["val"])
                                 if v["acc1"] == best)
    jcfg, _ = cfgs(18, 32)
    ref = jr.init_params(jax.random.key(0), jcfg)
    assert jax.tree.structure((saved["params"], saved["bn_state"])) == \
        jax.tree.structure(ref)
