#!/usr/bin/env python
"""Mixture-of-Experts training example: expert parallelism over ep.

Counterpart of examples/moe/train_moe.py with its flags and defaults: a
Qwen3-MoE (H 64, 4 layers, 4 heads of 16 over 2 KV heads, 8 experts of
I 64, top-2, capacity factor 2.0, vocabulary 256, seq 256) trains through
the port's ``Trainer`` with its experts split over the ``ep`` axis and
dp = world // ep (``--dp`` 0), tokens moved by ``--dispatch``
(``auto|einsum|index``), and the interleaved dense/sparse layouts of
``--sparse-step`` and ``--dense-layers``. It prints the sparse layers,
then the first and last loss and the last step's dropped fraction of
routed tokens.

On the card the attention runs K1-K3 (head_dim 16) and, with
``SCALETORCH_TPU_GROUPED_MLP_KERNEL=1``, the experts K5-K7 (H 64, I 64).
It runs on the CUDA card unless ``--device cpu`` is passed; ``--ep`` must
divide the world (``python -m torch.distributed.run --nproc-per-node N``):

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m scaletorch_tpu_torch.examples.moe.train_moe --ep 2
    python -m scaletorch_tpu_torch.examples.moe.train_moe --ep 1 \\
        --sparse-step 2 --dispatch index

The port always updates parameters in place, so ``donate_params`` stays
at its default (the reference turns it off for its demo).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ep", type=int, default=2)
    ap.add_argument("--dp", type=int, default=0,
                    help="0 = fill the remaining ranks")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--dispatch", choices=["auto", "einsum", "index"],
                    default="auto")
    ap.add_argument("--sparse-step", type=int, default=1,
                    help="layer i is sparse iff (i+1) %% this == 0")
    ap.add_argument("--dense-layers", type=int, nargs="*", default=[],
                    help="layer indices forced dense (mlp_only_layers)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_args(args: argparse.Namespace, world: int):
    """The reference example's ``ScaleTorchTPUArguments`` for ``world``
    ranks."""
    from scaletorch_tpu_torch.config import ScaleTorchTPUArguments

    dp = args.dp or max(world // args.ep, 1)
    return ScaleTorchTPUArguments(
        model_type="qwen3_moe", hidden_size=64, intermediate_size=128,
        moe_intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        num_experts=args.experts, num_experts_per_tok=2,
        # an untrained router is unbalanced: the default 1.25 would drop
        # about a third of the tokens at init
        moe_capacity_factor=2.0, moe_dispatch=args.dispatch,
        decoder_sparse_step=args.sparse_step,
        mlp_only_layers=args.dense_layers or None,
        vocab_size=256, sequence_length=args.seq,
        max_position_embeddings=2 * args.seq,
        expert_parallel_size=args.ep, data_parallel_size=dp,
        micro_batch_size=1, synthetic_data=True,
        total_train_steps=args.steps, dtype="float32",
        learning_rate=1e-3, warmup_steps=0,
        log_frequency=max(args.steps // 4, 1))


def run(argv=None) -> Dict[str, Any]:
    """Train; returns the losses, each step's metrics, the last dropped
    fraction, the world and the config."""
    from scaletorch_tpu_torch.examples._world import join_world, train

    args = parse_args(argv)
    world = join_world(args.device)[1]
    cfg = build_args(args, world)

    def describe(trainer):
        layout = trainer.model_cfg.sparse_layout()
        print(f"ranks={world} ep={args.ep} dp={cfg.data_parallel_size} "
              f"experts={args.experts} "
              f"dispatch={trainer.model_cfg.resolved_moe_dispatch()} "
              f"sparse_layers={[i for i, s in enumerate(layout) if s]}")

    out = train(cfg, args.device, args.steps, describe=describe)
    drop = out["metrics"][-1]["moe_dropped_fraction"]
    print(f"trained {args.steps} steps: loss {out['losses'][0]:.4f} -> "
          f"{out['losses'][-1]:.4f} (final dropped_fraction {drop:.2%})")
    return {**out, "dropped_fraction": drop, "cfg": cfg}


def main(argv=None) -> float:
    return run(argv)["losses"][-1]


if __name__ == "__main__":
    main()
