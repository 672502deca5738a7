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

It runs on the CUDA card unless ``--device cpu`` is passed. Under
``torch.distributed.run`` it is data parallel over the world
(``--data_parallel`` 0 means the world): each rank takes its slice of
every global batch, its loss is its rows' share of the global mean, and
the gradients are summed over the ranks. With ``--fsdp`` each leaf whose
leading dim divides over the ranks is held as this rank's slice of it,
all-gathered for the step (``parallel.sequence_parallel.
all_gather_sequence`` over dp), its gradient reduce-scattered by that
gather's backward, and Adadelta (elementwise) updates the slice. The
port's leaves are NCHW / OIHW, so it slices other dims than the
reference's HWIO tree; the numbers are the same.

Usage:
    python -m scaletorch_tpu_torch.examples.mnist.train_mnist --epochs 2
    python -m scaletorch_tpu_torch.examples.mnist.train_mnist \
        --data_dir ~/mnist
    python -m torch.distributed.run --nproc-per-node 2 \
        -m scaletorch_tpu_torch.examples.mnist.train_mnist --fsdp
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
                    help="shard parameters over dp (FSDP/ZeRO-3 role)")
    ap.add_argument("--data_parallel", type=int, default=0,
                    help="dp degree; 0 = the world (every rank)")
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


def fsdp_sharded(params, world: int):
    """The leaves ``--fsdp`` holds as slices: those whose leading dim
    divides over ``world`` (the reference's rule)."""
    return {k for k, p in params.items()
            if world > 1 and p.ndim >= 1 and p.shape[0] % world == 0}


def make_steps(optimizer, share: float = 1.0, group=None,
               sharded=frozenset()):
    """(train_step, eval_step): ``share`` (this rank's rows over the
    global batch) of the NLL of LeNet's logits, its gradient summed over
    ``group``, one Adadelta update in place; the eval counts correct
    predictions. The leaves named in ``sharded`` are this rank's slices
    on dim 0: all-gathered over dp for the forward, their gradient
    reduce-scattered by the gather's backward."""
    from scaletorch_tpu_torch.examples._world import sum_grads_
    from scaletorch_tpu_torch.models import lenet
    from scaletorch_tpu_torch.parallel.sequence_parallel import (
        all_gather_sequence,
    )

    def full(params):
        return {k: all_gather_sequence(p, "dp", 0) if k in sharded else p
                for k, p in params.items()}

    def loss_fn(params, x, y):
        logits = lenet.forward(full(params), x)
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(1, y.long()[:, None]).mean(), logits

    def train_step(params, state, x, y):
        loss, _ = loss_fn(params, x, y)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(
            loss * share, list(params.values()))))
        sum_grads_([g for k, g in grads.items() if k not in sharded], group)
        optimizer.update(grads, state, params)
        return loss.detach() * share

    @torch.no_grad()
    def eval_step(params, x, y):
        _, logits = loss_fn(params, x, y)
        return (logits.argmax(dim=-1) == y).sum()

    return train_step, eval_step


def run(argv=None) -> Dict[str, Any]:
    """Train; returns the last loss, the last test accuracy and the
    training steps/s (the evals left out)."""
    args = parse_args(argv)

    from scaletorch_tpu_torch.examples._world import group_sum, join_world
    from scaletorch_tpu_torch.models import lenet
    from scaletorch_tpu_torch.parallel.mesh import (
        MeshManager,
        using_mesh_manager,
    )
    from scaletorch_tpu_torch.trainer.optimizer import Adadelta

    dev, world, rank, group = join_world(args.device, args.data_parallel)
    if args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} does not split "
                         f"over {world} ranks")
    local = args.batch_size // world
    mesh = MeshManager(dp=world, device_type=dev.type if world > 1 else None)
    # one CPU generator: the same initial weights on the CPU and the card
    params = lenet.init_params(torch.Generator().manual_seed(0), device=dev)
    sharded = fsdp_sharded(params, world) if args.fsdp else set()
    for k in sharded:  # this rank's slice of dim 0
        w = params[k].shape[0] // world
        params[k] = params[k][rank * w:(rank + 1) * w].clone()
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
    train_step, eval_step = make_steps(optimizer, local / args.batch_size,
                                       group, sharded)

    rng = np.random.default_rng(0)
    last_loss, acc, train_s, steps_run = float("inf"), 0.0, 0.0, 0
    losses = []
    with using_mesh_manager(mesh):
        for epoch in range(args.epochs):
            order = torch.from_numpy(
                rng.permutation(len(tx_img))[:n]).to(dev)
            t0 = time.perf_counter()
            for step in range(steps_per_epoch):
                idx = order[step * args.batch_size:
                            (step + 1) * args.batch_size]
                idx = idx[rank * local:(rank + 1) * local]
                losses.append(train_step(params, state, train_x[idx],
                                         train_y[idx]))
                steps_run += 1
                if step % args.log_interval == 0:
                    loss = group_sum([losses[-1]], group, dev)[0]
                    if rank == 0:
                        print(f"epoch {epoch} step {step}/{steps_per_epoch}"
                              f" loss {loss:.4f}")
                if args.limit_steps and step + 1 >= args.limit_steps:
                    break
            last_loss = group_sum([losses[-1]], group, dev)[0]
            train_s += time.perf_counter() - t0

            ne = (len(ev_img) // args.batch_size) * args.batch_size
            correct = 0
            for step in range(ne // args.batch_size):
                sl = slice(step * args.batch_size + rank * local,
                           step * args.batch_size + (rank + 1) * local)
                correct += int(eval_step(params, test_x[sl], test_y[sl]))
            correct = int(group_sum([correct], group, dev)[0])
            acc = correct / max(ne, 1)
            if rank == 0:
                print(f"epoch {epoch}: test acc {correct}/{ne} "
                      f"({100.0 * acc:.1f}%) [{time.perf_counter() - t0:.1f}"
                      f"s, device={dev}, dp={world}, fsdp={args.fsdp}]")
    losses = group_sum(losses, group, dev)
    mesh.destroy()
    return {"last_loss": last_loss, "test_acc": acc, "losses": losses,
            "steps_per_s": steps_run / train_s, "device": str(dev),
            "world": world, "sharded": sorted(sharded),
            "param_numel": sum(p.numel() for p in params.values())}


def main(argv=None) -> float:
    return run(argv)["last_loss"]


if __name__ == "__main__":
    main()
