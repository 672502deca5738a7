#!/usr/bin/env python
"""Long-context training example: context parallelism over cp.

Counterpart of examples/longctx/train_longctx.py with its flags and
defaults: a 2-layer Llama (H 64, 4 heads and 4 KV heads of 16, vocabulary
256) trains at ``--seq`` 2048 with the sequence split over ``--cp`` 4
ranks and dp = world // cp, attention through

  * ``--strategy ring``: ring attention, K/V blocks passed around the cp
    ring (``--layout zigzag``, the default, gives every rank equal causal
    work; ``contiguous`` keeps each rank's slice whole);
  * ``--strategy ulysses``: an all-to-all that gives each rank whole
    sequences of cp-th of the heads (cp must divide the KV heads).

The loss equals one device's attention (the layouts' numerics are held
to the reference by the CP tests); cp buys memory and parallel attention
work. Like the reference, it drives the ``Trainer``'s step function by
hand over the loader's batches (``_device_batch`` cuts this rank's
part). On the card the attention runs K1-K3 at head_dim 16: zigzag ring
blocks of [1, 4, 256 or 512, 16] at the defaults, under Ulysses
[1, 1, 2048, 16] a rank. It runs on the CUDA card unless ``--device cpu``
is passed; ``--cp`` must divide the world:

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m scaletorch_tpu_torch.examples.longctx.train_longctx --cp 4
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m scaletorch_tpu_torch.examples.longctx.train_longctx \\
        --cp 2 --strategy ulysses
"""

from __future__ import annotations

import argparse
from typing import Any, Dict


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cp", type=int, default=4)
    ap.add_argument("--dp", type=int, default=0,
                    help="0 = fill the remaining ranks")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--strategy", choices=["ring", "ulysses"], default="ring")
    ap.add_argument("--layout", choices=["zigzag", "contiguous"],
                    default="zigzag", help="ring sequence layout")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_args(args: argparse.Namespace, world: int):
    """The reference example's ``ScaleTorchTPUArguments`` for ``world``
    ranks."""
    from scaletorch_tpu_torch.config import ScaleTorchTPUArguments

    return ScaleTorchTPUArguments(
        model_type="llama", hidden_size=64, intermediate_size=128,
        # 4 KV heads, so the default cp 4 works for ulysses too
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        vocab_size=256, sequence_length=args.seq,
        max_position_embeddings=2 * args.seq,
        context_parallel_size=args.cp,
        data_parallel_size=args.dp or max(world // args.cp, 1),
        cp_layout=args.layout, attention_backend=args.strategy,
        # a batch of 1 per dp rank: a rank's work stays fixed as the mesh
        # grows
        micro_batch_size=1, synthetic_data=True,
        total_train_steps=args.steps, dtype="float32",
        log_frequency=max(args.steps // 4, 1))


def run(argv=None) -> Dict[str, Any]:
    """Train; returns the losses, each step's metrics, the tokens seen,
    the world and the config."""
    from scaletorch_tpu_torch.examples._world import join_world, train

    args = parse_args(argv)
    world = join_world(args.device)[1]
    cfg = build_args(args, world)
    batches = {}

    def describe(trainer):
        batches["it"] = iter(trainer.loader)
        print(f"ranks={world} cp={args.cp} dp={cfg.data_parallel_size} "
              f"seq={args.seq} strategy={args.strategy}"
              + (f" layout={args.layout}" if args.strategy == "ring"
                 else ""))

    def step(trainer):
        batch = trainer._device_batch(next(batches["it"]))
        trainer.params, trainer.opt_state, m = trainer.step_fn(
            trainer.params, trainer.opt_state, batch)
        return m

    out = train(cfg, args.device, args.steps, step=step, describe=describe)
    tokens = args.steps * out["tokens_per_step"]
    print(f"trained {args.steps} steps ({tokens} tokens at seq {args.seq}):"
          f" loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}")
    return {**out, "tokens": tokens, "cfg": cfg}


def main(argv=None) -> float:
    return run(argv)["losses"][-1]


if __name__ == "__main__":
    main()
