"""The examples' world: join it, sum over it, train a Trainer over it.

Under ``torch.distributed.run`` (or in a process that already joined a
group) every rank of the world takes part, one card each (gloo ranks
with ``--device cpu``); alone, the world is this one device. In the
data-parallel examples every rank is a replica: ``--data_parallel 0``
means the world; another value must equal it, as the reference's
``jax.devices()[:dp]`` mesh must fit the host. The Trainer-driven
examples (moe, pipeline, longctx) build their config for the world, so
the world is joined before the config is built: dp is whatever the
world leaves over the example's own axes (the reference's
``len(jax.devices()) // cp``, for example).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def join_world(device: Optional[str], data_parallel: int = 0
               ) -> Tuple[torch.device, int, int, Optional[object]]:
    """(this rank's device, world size, rank, the world's group or None
    alone). Raises when ``data_parallel`` is neither 0 nor the world."""
    from scaletorch_tpu_torch import dist as stdist
    from scaletorch_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    stdist.init_distributed("auto", device=dev)
    world, rank = stdist.process_count(), stdist.process_index()
    if data_parallel not in (0, world):
        raise ValueError(
            f"--data_parallel {data_parallel} must be 0 (the world) or the "
            f"world size {world}: launch N ranks with python -m "
            f"torch.distributed.run --nproc-per-node N")
    if dev.type == "cuda":
        dev = torch.device("cuda", stdist.local_rank())
    return dev, world, rank, (dist.group.WORLD if world > 1 else None)


def sum_grads_(grads: Iterable[torch.Tensor], group) -> List[torch.Tensor]:
    """Each gradient summed over ``group`` in place (nothing alone)."""
    grads = list(grads)
    if group is not None:
        for g in grads:
            dist.all_reduce(g, group=group)
    return grads


def group_sum(values, group, device) -> List[float]:
    """Floats summed over ``group`` (in float64)."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=device)
    if group is not None:
        dist.all_reduce(t, group=group)
    return t.tolist()


def train(cfg, device: Optional[str], steps: int,
          step: Optional[Callable] = None,
          describe: Optional[Callable] = None) -> Dict[str, Any]:
    """``steps`` steps of ``Trainer(cfg)``; ``step(trainer)`` runs one
    and returns its metrics (default ``trainer.step()``); ``describe``
    prints the run's line once the trainer is built. Returns the losses,
    each step's metrics as floats, the world and the trainer's model
    config. The trainer's process groups are destroyed at the end."""
    from scaletorch_tpu_torch.trainer.trainer import Trainer

    trainer = Trainer(cfg, device=device)
    try:
        if describe is not None:
            describe(trainer)
        records = []
        for _ in range(steps):
            m = step(trainer) if step is not None else trainer.step()
            records.append({k: float(np.asarray(v.detach().cpu()))
                            for k, v in m.items()
                            if hasattr(v, "detach") and v.numel() == 1})
        return {"losses": [r["loss"] for r in records], "metrics": records,
                "world": trainer.world, "model_cfg": trainer.model_cfg,
                "tokens_per_step": trainer.loader.tokens_per_step}
    finally:
        trainer.close()
        trainer.mm.destroy()  # its process groups (and NCCL's buffers)
