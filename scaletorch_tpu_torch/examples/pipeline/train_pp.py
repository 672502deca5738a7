#!/usr/bin/env python
"""Pipeline-parallel training example: the three schedules side by side.

Counterpart of examples/pipeline/train_pp.py with its flags and defaults:
a Llama (H 64, 4 heads of 16 over 2 KV heads, vocabulary 256, seq 128,
``pp * max(vpp, 2)`` layers) trains over a pp-split layer stack under
``--engine``:

  * ``afab``: one forward and backward pipeline over all M microbatches,
    bubble (pp-1)/(M+pp-1);
  * ``interleaved``: ``--vpp`` virtual stages a rank on a circular ring,
    the bubble cut about vpp times;
  * ``memory_chunked`` (alias ``1f1b``): 1F1B's O(pp) boundary memory.

It prints the schedule's tick accounting before training
(``parallel.pipeline_parallel.interleaved_tick_schedule`` for
interleaved), then the first and last loss. dp = world // pp. On the
card the attention runs K1-K3 at head_dim 16. It runs on the CUDA card
unless ``--device cpu`` is passed; ``--pp`` must divide the world:

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m scaletorch_tpu_torch.examples.pipeline.train_pp \\
        --engine interleaved --vpp 2
"""

from __future__ import annotations

import argparse
from typing import Any, Dict


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="interleaved",
                    choices=["afab", "interleaved", "memory_chunked", "1f1b"])
    ap.add_argument("--pp", type=int, default=2)
    ap.add_argument("--vpp", type=int, default=2,
                    help="virtual stages per rank (interleaved only)")
    ap.add_argument("--accum", type=int, default=4,
                    help="microbatches per step (the pipeline's M)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def schedule_line(engine: str, pp: int, vpp: int, m: int) -> str:
    """The reference's line of tick accounting for the schedule."""
    from scaletorch_tpu_torch.parallel.pipeline_parallel import (
        interleaved_tick_schedule,
    )

    if engine == "interleaved":
        acct = interleaved_tick_schedule(m, pp, vpp)
        return (f"interleaved pp={pp} vpp={vpp} M={m}: "
                f"{acct['ticks']} chunk-ticks, bubble "
                f"{acct['bubble_fraction']:.1%} (afab: "
                f"{acct['afab_bubble_fraction']:.1%}), predicted step time "
                f"{acct['relative_step_time']:.3f}x afab's")
    return (f"{engine} pp={pp} M={m}: {m + pp - 1} stage-ticks fwd, bubble "
            f"{(pp - 1) / (m + pp - 1):.1%}")


def build_args(args: argparse.Namespace, world: int):
    """The reference example's ``ScaleTorchTPUArguments`` for ``world``
    ranks."""
    from scaletorch_tpu_torch.config import ScaleTorchTPUArguments

    vpp = args.vpp if args.engine == "interleaved" else 1
    return ScaleTorchTPUArguments(
        model_type="llama", hidden_size=64, intermediate_size=128,
        num_hidden_layers=args.pp * max(vpp, 2),  # divides pp * vpp
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        vocab_size=256, sequence_length=args.seq,
        max_position_embeddings=2 * args.seq,
        pipeline_parallel_size=args.pp,
        data_parallel_size=max(world // args.pp, 1),
        pp_engine=args.engine, pp_virtual_stages=vpp,
        micro_batch_size=1, gradient_accumulation_steps=args.accum,
        synthetic_data=True, total_train_steps=args.steps, dtype="float32",
        learning_rate=1e-3, warmup_steps=0,
        log_frequency=max(args.steps // 4, 1))


def run(argv=None) -> Dict[str, Any]:
    """Train; returns the losses, each step's metrics, the schedule's
    line, the world and the config."""
    from scaletorch_tpu_torch.examples._world import join_world, train

    args = parse_args(argv)
    world = join_world(args.device)[1]
    cfg = build_args(args, world)
    line = schedule_line(args.engine, args.pp, cfg.pp_virtual_stages,
                         args.accum)
    print(line)
    out = train(cfg, args.device, args.steps)
    print(f"trained {args.steps} steps ({cfg.pp_engine}): loss "
          f"{out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}")
    return {**out, "schedule": line, "cfg": cfg}


def main(argv=None) -> float:
    return run(argv)["losses"][-1]


if __name__ == "__main__":
    main()
