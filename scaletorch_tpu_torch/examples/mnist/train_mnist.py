#!/usr/bin/env python
"""MNIST / LeNet-5 training example on the GPU.

Counterpart of examples/mnist/train_mnist.py with its flags and defaults:
LeNet-5 trained with Adadelta (optax's: rho 0.9, eps 1e-6) under a
per-epoch StepLR (``lr · gamma ** (count // steps_per_epoch)``), a test
accuracy after each epoch, and the last loss returned by ``main``.

Data: the standard idx files under ``--data_dir`` when present
(``train-images-idx3-ubyte[.gz]`` etc.); otherwise a deterministic
synthetic digit set (one fixed pattern per class plus pixel noise), so the
example needs no download. The images go to the device once, in NCHW.

It runs on the CUDA card unless ``--device cpu`` is passed, on one
device: ``--data_parallel`` above 1 and ``--fsdp`` raise (the examples
over the mesh are ROADMAP item 9c).

Usage:
    python -m scaletorch_tpu_torch.examples.mnist.train_mnist --epochs 2
    python -m scaletorch_tpu_torch.examples.mnist.train_mnist \
        --data_dir ~/mnist
"""

from __future__ import annotations

import argparse
import gzip
import os
import struct
import time
from typing import Any, Dict

import numpy as np
import torch

MESH_ITEM = ("is not ported: the examples over the mesh are ROADMAP item "
             "9c")


def load_idx_images(path: str) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad magic {magic} in {path}")
        return np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)


def load_idx_labels(path: str) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad magic {magic} in {path}")
        return np.frombuffer(f.read(), np.uint8)


def _find(data_dir: str, stem: str):
    for suffix in ("", ".gz"):
        p = os.path.join(data_dir, stem + suffix)
        if os.path.exists(p):
            return p
    return None


def load_mnist(data_dir):
    """(train_x, train_y, test_x, test_y): float32 [N, 28, 28, 1] in [0, 1]
    (the reference's layout) and int32 labels."""
    if data_dir:
        stems = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
                 "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
        paths = [_find(data_dir, s) for s in stems]
        if all(paths):
            tx, ex = load_idx_images(paths[0]), load_idx_images(paths[2])
            ty, ey = load_idx_labels(paths[1]), load_idx_labels(paths[3])

            def norm(a):
                return (a.astype(np.float32) / 255.0)[..., None]

            return norm(tx), ty.astype(np.int32), norm(ex), ey.astype(np.int32)
        missing = [s for s, p in zip(stems, paths) if p is None]
        print(f"missing MNIST idx files under {data_dir} "
              f"({', '.join(missing)}); using synthetic digits")
    return synthetic_digits(12000) + synthetic_digits(2000, seed=1)


def synthetic_digits(n: int, seed: int = 0):
    """One FIXED random 28x28 pattern per class (shared by every split)
    plus per-sample pixel noise: a learnable 10-class stand-in."""
    protos = np.random.default_rng(1234).uniform(
        0.0, 1.0, (10, 28, 28)).astype(np.float32)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n).astype(np.int32)
    x = protos[y] + rng.normal(0.0, 0.4, (n, 28, 28)).astype(np.float32)
    return np.clip(x, 0.0, 1.0)[..., None], y


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default=None)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1.0)
    ap.add_argument("--gamma", type=float, default=0.7,
                    help="StepLR decay per epoch")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard parameters over dp (not ported: raises)")
    ap.add_argument("--data_parallel", type=int, default=0,
                    help="dp degree; 0 or 1 = this one device")
    ap.add_argument("--log_interval", type=int, default=20)
    ap.add_argument("--limit_steps", type=int, default=0,
                    help="stop after N steps per epoch (CI)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def step_lr(lr: float, gamma: float, steps_per_epoch: int):
    """optax.exponential_decay(lr, 1, gamma, staircase=True) at
    ``count // steps_per_epoch``: the reference's per-epoch StepLR."""
    from scaletorch_tpu_torch.trainer.lr_scheduler import exponential_decay

    sched = exponential_decay(lr, transition_steps=1, decay_rate=gamma,
                              staircase=True)
    return lambda count: sched(count // steps_per_epoch)


def make_steps(optimizer):
    """(train_step, eval_step): the NLL of LeNet's logits, one Adadelta
    update in place; the eval counts correct predictions."""
    from scaletorch_tpu_torch.models import lenet
    from scaletorch_tpu_torch.trainer.optimizer import tree_map

    def loss_fn(params, x, y):
        logits = lenet.forward(params, x)
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(1, y.long()[:, None]).mean(), logits

    def train_step(params, state, x, y):
        loss, _ = loss_fn(params, x, y)
        grads = torch.autograd.grad(loss, list(params.values()))
        it = iter(grads)
        optimizer.update(tree_map(lambda _: next(it), params), state, params)
        return loss.detach()

    @torch.no_grad()
    def eval_step(params, x, y):
        _, logits = loss_fn(params, x, y)
        return (logits.argmax(dim=-1) == y).sum()

    return train_step, eval_step


def run(argv=None) -> Dict[str, Any]:
    """Train; returns the last loss, the last test accuracy and the
    training steps/s (the evals left out)."""
    args = parse_args(argv)
    if args.fsdp:
        raise ValueError(f"--fsdp {MESH_ITEM}")
    if args.data_parallel > 1:
        raise ValueError(f"--data_parallel {args.data_parallel} {MESH_ITEM}")

    from scaletorch_tpu_torch.models import lenet
    from scaletorch_tpu_torch.trainer.optimizer import Adadelta
    from scaletorch_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    # one CPU generator: the same initial weights on the CPU and the card
    params = lenet.init_params(torch.Generator().manual_seed(0), device=dev)
    for p in params.values():
        p.requires_grad_(True)

    tx_img, tx_lbl, ev_img, ev_lbl = load_mnist(args.data_dir)

    def upload(img, lbl):  # NHWC numpy -> NCHW on the device, once
        return (torch.from_numpy(img).permute(0, 3, 1, 2).contiguous().to(dev),
                torch.from_numpy(lbl).to(dev))

    train_x, train_y = upload(tx_img, tx_lbl)
    test_x, test_y = upload(ev_img, ev_lbl)
    n = (len(tx_img) // args.batch_size) * args.batch_size
    steps_per_epoch = max(n // args.batch_size, 1)
    optimizer = Adadelta(step_lr(args.lr, args.gamma, steps_per_epoch))
    state = optimizer.init(params)
    train_step, eval_step = make_steps(optimizer)

    rng = np.random.default_rng(0)
    last_loss, acc, train_s, steps_run = float("inf"), 0.0, 0.0, 0
    for epoch in range(args.epochs):
        order = torch.from_numpy(rng.permutation(len(tx_img))[:n]).to(dev)
        t0 = time.perf_counter()
        for step in range(steps_per_epoch):
            idx = order[step * args.batch_size:(step + 1) * args.batch_size]
            loss = train_step(params, state, train_x[idx], train_y[idx])
            steps_run += 1
            if step % args.log_interval == 0:
                print(f"epoch {epoch} step {step}/{steps_per_epoch} "
                      f"loss {float(loss):.4f}")
            if args.limit_steps and step + 1 >= args.limit_steps:
                break
        last_loss = float(loss)  # waits for the device
        train_s += time.perf_counter() - t0

        ne = (len(ev_img) // args.batch_size) * args.batch_size
        correct = 0
        for step in range(ne // args.batch_size):
            sl = slice(step * args.batch_size, (step + 1) * args.batch_size)
            correct += int(eval_step(params, test_x[sl], test_y[sl]))
        acc = correct / max(ne, 1)
        print(f"epoch {epoch}: test acc {correct}/{ne} ({100.0 * acc:.1f}%) "
              f"[{time.perf_counter() - t0:.1f}s, device={dev}]")
    return {"last_loss": last_loss, "test_acc": acc,
            "steps_per_s": steps_run / train_s, "device": str(dev)}


def main(argv=None) -> float:
    return run(argv)["last_loss"]


if __name__ == "__main__":
    main()
