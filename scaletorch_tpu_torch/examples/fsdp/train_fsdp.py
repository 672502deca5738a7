#!/usr/bin/env python
"""FSDP training example: parameter and optimizer-state sharding.

Counterpart of examples/fsdp/train_fsdp.py with its flags and defaults: a
4-layer Llama (H 128, I 256, 4 heads of 32 over 2 KV heads, vocabulary
512) trains on random token rows (``--rows`` 8 a step, seq 64) over
``parallel.fsdp.setup_fsdp``: every rank of the world holds a 1/N slice
of each leaf (its largest dim that divides N) and of its AdamW state;
the step all-gathers the leaves for the forward and reduce-scatters the
gradients (the reference leaves both to XLA's partitioner; FSDP2's hooks
in PyTorch).

  * ``--mixed-precision``: bf16 parameters and compute;
  * the parameter bytes of the whole model and of one rank are printed;
  * ``--checkpoint-dir``: the shards and the optimizer state are saved at
    the end through the coordinated checkpoint (``utils/checkpoint.py``:
    global tensors over the fsdp axis, written once by DCP); a second run
    with the same directory resumes from the latest step, on any world
    size (the global tensors are read into the new run's slices), and
    the schedule's horizon covers the resumed and the new steps.

It runs on the CUDA card unless ``--device cpu`` is passed; the world is
the fsdp axis:

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m scaletorch_tpu_torch.examples.fsdp.train_fsdp --steps 10
    python -m scaletorch_tpu_torch.examples.fsdp.train_fsdp \\
        --mixed-precision --checkpoint-dir /tmp/fsdp_ckpt
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--rows", type=int, default=8,
                    help="global batch rows (split over the fsdp axis)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mixed-precision", action="store_true",
                    help="bf16 params + bf16 compute")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save/resume dir; a second run resumes from it")
    ap.add_argument("--log_interval", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def model_config(args: argparse.Namespace):
    """The reference example's Llama."""
    from scaletorch_tpu_torch.models.llama import LlamaConfig

    dtype = torch.bfloat16 if args.mixed_precision else torch.float32
    return LlamaConfig(
        vocab_size=512, hidden_size=128, intermediate_size=256,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32, max_position_embeddings=max(64, args.seq),
        dtype=dtype, param_dtype=dtype)


def step_batch(rng: np.random.Generator, vocab: int, rows: int,
               seq: int) -> Dict[str, np.ndarray]:
    """The reference's global batch of a step: [1, rows, seq] inputs and
    their next tokens (and the positions [1, seq] the port's step
    takes)."""
    ids = rng.integers(0, vocab, (1, rows, seq + 1))
    return {"input_ids": ids[:, :, :-1].astype(np.int32),
            "target_ids": ids[:, :, 1:].astype(np.int32),
            "position_ids": np.arange(seq, dtype=np.int32)[None]}


def run(argv=None, params_host: Optional[Dict[str, Any]] = None
        ) -> Dict[str, Any]:
    """Train (from ``params_host``, a full tree in the reference layout,
    when given; else the port's own draw from seed 0); returns the
    losses and gradient norms, the step range, the parameter bytes, the
    world, and this rank's shards."""
    args = parse_args(argv)
    from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
    from scaletorch_tpu_torch.data.dataloader import device_batch
    from scaletorch_tpu_torch.examples._world import join_world
    from scaletorch_tpu_torch.models import llama
    from scaletorch_tpu_torch.models.convert import flatten_params
    from scaletorch_tpu_torch.parallel.fsdp import MESH_AXIS, setup_fsdp
    from scaletorch_tpu_torch.parallel.spmd import local_batch
    from scaletorch_tpu_torch.trainer.optimizer import (
        create_optimizer,
        tree_leaves,
    )
    from scaletorch_tpu_torch.utils.checkpoint import CheckpointManager

    dev, world, rank, _ = join_world(args.device)
    cfg = model_config(args)
    # the latest step before the optimizer: a restored AdamW count is
    # cumulative, so the schedule's horizon covers resumed + new steps
    start_step = 0
    if args.checkpoint_dir:
        start_step = CheckpointManager(args.checkpoint_dir).latest_step() or 0
    targs = ScaleTorchTPUArguments(
        total_train_steps=start_step + args.steps, learning_rate=args.lr,
        warmup_steps=2, max_grad_norm=1.0)
    opt, _ = create_optimizer(targs)
    if params_host is None:
        params_host = llama.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu")
    step_fn, params, opt_state, mesh = setup_fsdp(
        cfg, params_host, opt, device=dev, dtype=cfg.param_dtype,
        max_grad_norm=targs.max_grad_norm)
    if args.rows % world:
        raise SystemExit(f"--rows {args.rows} must divide over {world} "
                         f"ranks")

    ckpt = None
    if args.checkpoint_dir:
        from scaletorch_tpu_torch.parallel.fsdp import fsdp_param_specs
        from scaletorch_tpu_torch.resilience_distributed import DecisionBus

        specs = flatten_params(fsdp_param_specs(params_host, world))
        ckpt = CheckpointManager(
            args.checkpoint_dir,
            decision_bus=(DecisionBus.default(mesh.host_group())
                          if world > 1 else None),
            mesh=mesh, group=mesh.checkpoint_group(),
            split_dims={k: ({} if d is None else {MESH_AXIS: d})
                        for k, d in specs.items()})
        if start_step:
            restored = ckpt.load_latest(params, opt_state)
            start_step = restored["step"]
            if rank == 0:
                print(f"resumed from step {start_step} in "
                      f"{args.checkpoint_dir}")

    total = sum(int(np.prod(np.shape(p))) for p in tree_leaves(params_host))
    total *= cfg.param_dtype.itemsize
    local = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    if rank == 0:
        print(f"ranks={world} param_bytes total={total / 1e6:.1f}MB "
              f"per-rank={local / 1e6:.1f}MB "
              f"(x{total / max(local, 1):.1f} saving)")

    rng = np.random.default_rng(start_step)
    losses, norms = [], []
    for step in range(start_step, start_step + args.steps):
        batch = step_batch(rng, cfg.vocab_size, args.rows, args.seq)
        params, opt_state, m = step_fn(
            params, opt_state, device_batch(local_batch(batch, mesh), dev))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if (step + 1) % args.log_interval == 0 and rank == 0:
            print(f"step {step + 1:>4} | loss {losses[-1]:.4f} "
                  f"| gnorm {norms[-1]:.3f}")
    if ckpt is not None:
        ckpt.save(start_step + args.steps, params, opt_state)
        ckpt.close()
        if rank == 0:
            print(f"saved step {start_step + args.steps} to "
                  f"{args.checkpoint_dir}")
    mesh.destroy()
    return {"losses": losses, "grad_norms": norms, "start_step": start_step,
            "param_bytes": total, "rank_param_bytes": local, "world": world,
            "params": params}


def main(argv=None) -> float:
    return run(argv)["losses"][-1]


if __name__ == "__main__":
    main()
