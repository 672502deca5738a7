#!/usr/bin/env python
"""ImageNet-style ResNet training, data parallel with sync-BN, on the GPU.

Counterpart of examples/imagenet/dist_train.py with its flags and
defaults: resnet18 (or resnet34, ``models/resnet.py``) trained with SGD
and momentum after decoupled weight decay (the reference's optax chain:
``add_decayed_weights(wd)`` then ``sgd(schedule, momentum)``) under a
staircase StepLR (x0.1 every ``--lr-step-epochs`` epochs), top-1/top-5
accuracy on the validation set after each epoch, the best checkpoint
saved (``model_best.pkl``, the reference's file: numpy arrays in the JAX
package's layout, ``models/convert.resnet_to_jax``), and ``main``
returning the best top-1.

Data: an ImageFolder-style directory of per-class ``.npy`` arrays with
``--data``, else the reference's deterministic synthetic stand-in (fixed
class prototypes plus noise, the same seeds, so both examples train on
the same images). The images go to the device once, in NCHW.

It runs on the CUDA card unless ``--device cpu`` is passed. Under a
launcher (``torch.distributed.run``) it joins the process group (NCCL on
cards, gloo on the CPU), or uses the one already joined: each rank takes
its slice of every global batch, the BatchNorm statistics are over the
global batch (sync-BN), the gradients are summed over the ranks (each
rank's loss is its rows' share of the global mean) and the evaluation's
counts too, so the run trains what one device trains.

Usage:
    python -m scaletorch_tpu_torch.examples.imagenet.dist_train \\
        --arch resnet18 --image-size 64 --num-classes 10 --epochs 2
    python -m torch.distributed.run --nproc-per-node 4 \\
        -m scaletorch_tpu_torch.examples.imagenet.dist_train
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import Any, Dict

import numpy as np
import torch


def synthetic_images(n, num_classes, size, seed=0):
    """Fixed per-class prototypes + noise (learnable, hermetic): NHWC
    float32 in [0, 1] and int32 labels, as the reference draws them."""
    protos = np.random.default_rng(4321).uniform(
        0, 1, (num_classes, size, size, 3)).astype(np.float32)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, n).astype(np.int32)
    x = protos[y] + rng.normal(0, 0.35, (n, size, size, 3)).astype(np.float32)
    return np.clip(x, 0, 1), y


def load_folder(data_dir, size):
    """Minimal ImageFolder: data_dir/<class>/*.npy arrays [H, W, 3],
    shuffled with seed 0 before the caller's train/val split."""
    classes = sorted(d for d in os.listdir(data_dir)
                     if os.path.isdir(os.path.join(data_dir, d)))
    xs, ys = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(data_dir, cname)
        for f in sorted(os.listdir(cdir)):
            if f.endswith(".npy"):
                arr = np.load(os.path.join(cdir, f)).astype(np.float32)
                if arr.shape[:2] != (size, size):
                    raise SystemExit(
                        f"{f}: expected {size}x{size}, got {arr.shape[:2]}; "
                        "resize offline (no image libs in this example)")
                xs.append(arr)
                ys.append(ci)
    if not xs:
        raise SystemExit(f"no .npy files under {data_dir}")
    x, y = np.stack(xs), np.asarray(ys, np.int32)
    perm = np.random.default_rng(0).permutation(len(x))
    return x[perm], y[perm], classes


def topk_correct(logits, labels, ks=(1, 5)):
    """Rows whose label is among the k largest logits, for each k (ties
    ordered as the reference's reversed stable argsort orders them)."""
    order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    return [(order[:, :min(k, logits.shape[-1])] == labels[:, None]
             ).any(dim=-1).sum() for k in ks]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="ResNet ImageNet-style training")
    ap.add_argument("--data", default=None, help="ImageFolder-style dir of "
                    "per-class .npy arrays; synthetic when omitted")
    ap.add_argument("-a", "--arch", default="resnet18",
                    choices=["resnet18", "resnet34"])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("-b", "--batch-size", type=int, default=64,
                    help="GLOBAL batch (split over the data-parallel ranks)")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--wd", type=float, default=1e-4)
    ap.add_argument("--lr-step-epochs", type=int, default=30,
                    help="StepLR: decay x0.1 every N epochs (reference)")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--train-samples", type=int, default=2048)
    ap.add_argument("--val-samples", type=int, default=512)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--bn-momentum", type=float, default=0.1,
                    help="running-stat EMA rate; raise for short runs so "
                         "eval-mode BN converges quickly")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--print-freq", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def make_optimizer(args, steps_per_epoch: int):
    """The port's SGD (``optax.sgd``'s trace) under the staircase StepLR;
    the decoupled weight decay is added to the gradients by the step."""
    from scaletorch_tpu_torch.trainer.lr_scheduler import exponential_decay
    from scaletorch_tpu_torch.trainer.optimizer import SGD

    schedule = exponential_decay(
        args.lr, transition_steps=args.lr_step_epochs * steps_per_epoch,
        decay_rate=0.1, staircase=True)
    return SGD(schedule, momentum=args.momentum)


def make_steps(cfg, optimizer, wd: float, global_batch: int, group=None):
    """(train_step, eval_step). The train step runs the forward in train
    mode over this rank's rows (sync-BN over ``group``), takes this
    rank's share of the global mean cross-entropy, sums the gradients
    over ``group``, adds ``wd · p`` and updates in place; it returns the
    global loss, the new BN state and the rank's top-1 / top-5 counts.
    The eval step returns the rows' summed cross-entropy and counts."""
    from scaletorch_tpu_torch.examples._world import sum_grads_
    from scaletorch_tpu_torch.models import resnet
    from scaletorch_tpu_torch.trainer.optimizer import tree_leaves, tree_map

    def ce_sum(logits, labels):
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(1, labels.long()[:, None]).sum()

    def train_step(params, bn_state, opt_state, images, labels):
        logits, new_state = resnet.forward(params, bn_state, images, cfg,
                                           train=True, bn_group=group)
        loss = ce_sum(logits, labels) / global_batch
        leaves = tree_leaves(params)
        grads = sum_grads_(torch.autograd.grad(loss, leaves), group)
        (loss,) = sum_grads_([loss.detach()], group)
        it = iter(grads)
        decayed = tree_map(lambda p: next(it) + wd * p.detach(), params)
        optimizer.update(decayed, opt_state, params)
        t1, t5 = topk_correct(logits.detach(), labels)
        return loss, new_state, t1, t5

    @torch.no_grad()
    def eval_step(params, bn_state, images, labels):
        logits, _ = resnet.forward(params, bn_state, images, cfg,
                                   train=False)
        t1, t5 = topk_correct(logits, labels)
        return ce_sum(logits, labels), t1, t5

    return train_step, eval_step


def run(argv=None) -> Dict[str, Any]:
    """Train; returns the per-step and per-epoch losses, each epoch's
    validation numbers and training seconds, the best top-1, the training
    images/s and ms a step (the evaluations left out), and the final
    parameters and BN state."""
    args = parse_args(argv)
    from scaletorch_tpu_torch.examples._world import group_sum, join_world
    from scaletorch_tpu_torch.models import resnet
    from scaletorch_tpu_torch.models.convert import resnet_to_jax
    from scaletorch_tpu_torch.trainer.optimizer import tree_leaves

    dev, world, rank, group = join_world(args.device)
    if args.data:
        x_all, y_all, classes = load_folder(args.data, args.image_size)
        args.num_classes = len(classes)
        split = int(0.9 * len(x_all))
        tx_, ty_ = x_all[:split], y_all[:split]
        vx_, vy_ = x_all[split:], y_all[split:]
    else:
        tx_, ty_ = synthetic_images(args.train_samples, args.num_classes,
                                    args.image_size)
        vx_, vy_ = synthetic_images(args.val_samples, args.num_classes,
                                    args.image_size, seed=1)

    cfg = resnet.ResNetConfig(
        depth=int(args.arch.replace("resnet", "")),
        num_classes=args.num_classes, width=args.width,
        image_size=args.image_size, bn_momentum=args.bn_momentum)
    # one CPU generator: the same initial weights on the CPU and the card
    params, bn_state = resnet.init_params(torch.Generator().manual_seed(0),
                                          cfg, device=dev)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} must divide over "
                         f"{world} ranks")
    if len(tx_) < args.batch_size:
        raise SystemExit(f"train set ({len(tx_)}) smaller than the global "
                         f"batch ({args.batch_size}); lower --batch-size")
    if rank == 0:
        print(f"=> {args.arch}: {cfg.num_params() / 1e6:.2f}M params, "
              f"{world}-way data parallel, global batch {args.batch_size}")

    def upload(img, lbl):  # NHWC numpy -> NCHW on the device, once
        return (torch.from_numpy(img).to(dev).permute(0, 3, 1, 2)
                .contiguous(), torch.from_numpy(lbl).to(dev))

    train_x, train_y = upload(tx_, ty_)
    val_x, val_y = upload(vx_, vy_)
    steps_per_epoch = max(len(tx_) // args.batch_size, 1)
    optimizer = make_optimizer(args, steps_per_epoch)
    opt_state = optimizer.init(params)
    train_step, eval_step = make_steps(cfg, optimizer, args.wd,
                                       args.batch_size, group)
    local = args.batch_size // world

    best_acc1, losses, epoch_losses, epoch_s, val = 0.0, [], [], [], []
    rng = np.random.default_rng(0)
    for epoch in range(args.epochs):
        order = torch.from_numpy(rng.permutation(len(tx_))).to(dev)
        t0, seen, c1, epoch_loss = time.perf_counter(), 0, 0, []
        for it in range(steps_per_epoch):
            idx = order[it * args.batch_size:(it + 1) * args.batch_size]
            idx = idx[rank * local:(rank + 1) * local]
            loss, bn_state, t1, t5 = train_step(
                params, bn_state, opt_state, train_x[idx], train_y[idx])
            epoch_loss.append(loss)
            seen += args.batch_size
            c1 += t1
            if (it + 1) % args.print_freq == 0 or it == steps_per_epoch - 1:
                c1_all = group_sum([c1], group, dev)[0]
                if rank == 0:
                    ips = seen / (time.perf_counter() - t0)
                    print(f"Epoch [{epoch}][{it + 1}/{steps_per_epoch}] "
                          f"loss {float(loss):.4f} acc@1 "
                          f"{100 * c1_all / seen:.2f}% ({ips:.0f} img/s)")
        epoch_loss = [float(v) for v in epoch_loss]  # waits for the device
        epoch_s.append(time.perf_counter() - t0)
        losses += epoch_loss
        epoch_losses.append(sum(epoch_loss) / len(epoch_loss))

        # validation: top-1/top-5 over the val set, batches trimmed to a
        # multiple of the ranks (each scores its slice)
        usable = (len(vx_) // world) * world
        vtot, v1, v5, vloss, i0 = 0, 0, 0, 0.0, 0
        while i0 < usable:
            n = (min(args.batch_size, usable - i0) // world) * world
            sl = slice(i0 + rank * (n // world), i0 + (rank + 1) * (n // world))
            i0 += n
            ce, t1, t5 = eval_step(params, bn_state, val_x[sl], val_y[sl])
            ce, t1, t5 = group_sum([ce, t1, t5], group, dev)
            vtot, v1, v5, vloss = vtot + n, v1 + t1, v5 + t5, vloss + ce
        acc1, acc5 = 100 * v1 / max(vtot, 1), 100 * v5 / max(vtot, 1)
        val.append({"acc1": acc1, "acc5": acc5,
                    "loss": vloss / max(vtot, 1), "samples": vtot})
        if rank == 0:
            dropped = len(vx_) - usable
            print(f" * Val acc@1 {acc1:.2f}% acc@5 {acc5:.2f}% loss "
                  f"{vloss / max(vtot, 1):.4f} ({vtot} samples"
                  + (f", {dropped} dropped to fit the ranks)" if dropped
                     else ")"))
        if args.checkpoint_dir and acc1 >= best_acc1 and rank == 0:
            os.makedirs(args.checkpoint_dir, exist_ok=True)
            jp, js = resnet_to_jax(params, bn_state)
            with open(os.path.join(args.checkpoint_dir, "model_best.pkl"),
                      "wb") as f:
                pickle.dump({"params": jp, "bn_state": js, "epoch": epoch,
                             "acc1": acc1}, f)
            print(f"=> saved best (acc@1 {acc1:.2f}%)")
        best_acc1 = max(best_acc1, acc1)
    return {"best_acc1": best_acc1, "losses": losses,
            "epoch_losses": epoch_losses, "val": val,
            "epoch_seconds": epoch_s, "steps_per_epoch": steps_per_epoch,
            "images_per_s": len(losses) * args.batch_size / sum(epoch_s),
            "ms_per_step": 1e3 * sum(epoch_s) / len(losses), "world": world,
            "device": str(dev), "params": params, "bn_state": bn_state}


def main(argv=None) -> float:
    return run(argv)["best_acc1"]


if __name__ == "__main__":
    main()
