#!/usr/bin/env python
"""Device-mesh walkthrough: the six demos of examples/device_mesh, with
PyTorch's own primitives and the port's parallel layers.

Where the reference composes ``NamedSharding`` placements and
``jax.shard_map`` programs, these build the same strategies from
``torch.distributed.device_mesh.init_device_mesh``, DTensor placements
(``Shard`` / ``Replicate``, ``redistribute``) and the port's explicit
collectives:

  * ``demo_mesh_api``: a 2-D mesh ("replicate", "shard");
  * ``demo_dtensor_placements``: Shard(0), Replicate() and a
    redistribution to Shard(1);
  * ``demo_tensor_parallel``: a Megatron MLP, W1 column-split and W2
    row-split (``parallel.tensor_parallel.column_parallel_linear`` /
    ``row_parallel_linear``: one all-reduce), equal to one device's;
  * ``demo_sequence_parallel``: sequence shards all-gathered in and
    reduce-scattered out (``parallel.sequence_parallel``), round-tripping
    the sequence;
  * ``demo_fsdp_dp``: HSDP, a weight sharded inside each replica group and
    replicated across the groups;
  * ``demo_fsdp_tp``: FSDP x TP, storage over "fsdp", compute over "tp".

The reference needs 8 devices for its (2, 4) meshes; here the 2-D meshes
are (2, world / 2) for any even world of at least 4 ranks (fewer raise),
and the tp and sp demos run over the whole world. Each demo asserts what
the reference asserts (and the placements' local shapes). It runs on the
CUDA cards (NCCL) unless ``--device cpu`` is passed (gloo):

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m scaletorch_tpu_torch.examples.device_mesh.mesh_demos
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import torch
import torch.distributed as dist


def destroy(mesh) -> None:
    """Destroy the process groups of ``mesh``'s dims: a later mesh over the
    same ranks registers groups of the same names."""
    for dim in range(mesh.ndim):
        dist.destroy_process_group(mesh.get_group(dim))


def demo_mesh_api(device_type: str):
    """A 2-D mesh of named axes (the reference's device_mesh_api and
    manual process groups: axis names instead of group handles)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    mesh = init_device_mesh(device_type, (2, world // 2),
                            mesh_dim_names=("replicate", "shard"))
    assert mesh.shape == (2, world // 2)
    if dist.get_rank() == 0:
        axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(f"[mesh-api] mesh axes {axes} (2 replicate x {world // 2} "
              f"shard)")
    return mesh


def demo_dtensor_placements(mesh) -> Dict[str, Any]:
    """Shard / Replicate placements and a redistribution (reference
    dtensor_demo)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    n = mesh.shape[1]
    x = torch.arange(16.0 * n * n, device=mesh.device_type).reshape(
        4 * n, 4 * n)
    sharded = distribute_tensor(x, mesh, [Replicate(), Shard(0)])
    replicated = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    resharded = replicated.redistribute(mesh, [Replicate(), Shard(1)])
    shapes = {"shard0": tuple(sharded.to_local().shape),
              "replicate": tuple(replicated.to_local().shape),
              "shard1": tuple(resharded.to_local().shape)}
    assert shapes == {"shard0": (4, 4 * n), "replicate": (4 * n, 4 * n),
                      "shard1": (4 * n, 4)}
    assert torch.equal(resharded.full_tensor(), x)
    if dist.get_rank() == 0:
        print(f"[dtensor] Shard(0): per-rank {shapes['shard0']}; "
              f"Replicate(): per-rank {shapes['replicate']}; "
              f"redistribute -> Shard(1): per-rank {shapes['shard1']}")
    return shapes


def demo_tensor_parallel(device: torch.device) -> bool:
    """Megatron TP MLP: W1 column-split, W2 row-split, one all-reduce
    (reference tensor_parallel_demo) through the port's layers."""
    from scaletorch_tpu_torch.parallel.tensor_parallel import (
        column_parallel_linear,
        row_parallel_linear,
    )

    world, rank = dist.get_world_size(), dist.get_rank()
    h, f = 32, 16 * world
    x = torch.ones(2, 8, h, device=device)
    w1 = 0.02 * torch.arange(h * f, dtype=torch.float32,
                             device=device).reshape(h, f) / (h * f)
    w2 = w1.T / 10.0
    cols = slice(rank * f // world, (rank + 1) * f // world)
    hidden = column_parallel_linear(x, w1[:, cols], axis="tp")  # no comm
    out = row_parallel_linear(hidden, w2[cols], axis="tp")     # one sum
    ok = bool(torch.allclose(out, (x @ w1) @ w2, atol=1e-5))
    assert ok, "tensor-parallel MLP diverged from single-device reference"
    if rank == 0:
        print(f"[tp] col+row parallel MLP matches single-device: {ok} "
              f"(one all-reduce total)")
    return ok


def demo_sequence_parallel(device: torch.device) -> bool:
    """SP: each rank holds a sequence shard; all-gather in, reduce-scatter
    out (reference sequence_parallel_demo)."""
    from scaletorch_tpu_torch.parallel.sequence_parallel import (
        all_gather_sequence,
        reduce_scatter_sequence,
    )

    world, rank = dist.get_world_size(), dist.get_rank()
    x = torch.arange(world * 16 * 8, dtype=torch.float32,
                     device=device).reshape(1, world * 16, 8)
    x_shard = x[:, rank * 16:(rank + 1) * 16]
    w = torch.eye(8, device=device) * 2.0
    full = all_gather_sequence(x_shard, "tp")                  # [1, S, 8]
    # a row-parallel product leaves each rank a partial sum; w / world
    # stands in for it, and the reduce-scatter sums and re-shards
    y = reduce_scatter_sequence(full @ (w / world), "tp")      # [1, 16, 8]
    ok = bool(torch.allclose(y, x_shard * 2.0, atol=1e-5))
    assert ok, "sequence-parallel round-trip diverged"
    if rank == 0:
        print(f"[sp] gather->compute->reduce-scatter round-trips the "
              f"sequence: {ok} (per-rank seq {x.shape[1] // world})")
    return ok


def demo_fsdp_dp(device_type: str) -> tuple:
    """HSDP: sharded inside each replica group, replicated across them
    (reference fsdp_dp_demo)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    world = dist.get_world_size()
    mesh = init_device_mesh(device_type, (2, world // 2),
                            mesh_dim_names=("dp_replicate", "dp_shard"))
    w = torch.zeros(1024, 64, device=device_type)
    shard = tuple(distribute_tensor(w, mesh, [Replicate(), Shard(0)])
                  .to_local().shape)
    assert shard == (1024 // (world // 2), 64)
    destroy(mesh)
    if dist.get_rank() == 0:
        print(f"[hsdp] param {tuple(w.shape)} -> per-rank {shard}: sharded "
              f"{world // 2}-way inside each replica group, replicated "
              f"across the 2 groups")
    return shard


def demo_fsdp_tp(device_type: str) -> tuple:
    """FSDP x TP (reference fsdp_tp_demo): storage over "fsdp", compute
    over "tp"."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    world = dist.get_world_size()
    mesh = init_device_mesh(device_type, (2, world // 2),
                            mesh_dim_names=("fsdp", "tp"))
    w_col = torch.zeros(64, 512, device=device_type)  # column-parallel
    shard = tuple(distribute_tensor(w_col, mesh, [Shard(0), Shard(1)])
                  .to_local().shape)
    assert shard == (32, 512 // (world // 2))
    destroy(mesh)
    if dist.get_rank() == 0:
        print(f"[fsdp+tp] weight {tuple(w_col.shape)} -> per-rank {shard}:"
              f" tp splits the compute dim, fsdp the storage of each tp "
              f"shard (all-gathered over fsdp for the step)")
    return shard


def run(argv=None) -> Dict[str, Any]:
    """Every demo; returns what each found."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from scaletorch_tpu_torch.examples._world import join_world
    from scaletorch_tpu_torch.parallel.mesh import (
        MeshManager,
        using_mesh_manager,
    )

    dev, world, _, _ = join_world(args.device)
    if world < 4 or world % 2:
        raise SystemExit(
            f"these demos need an even world of at least 4 ranks, have "
            f"{world}: python -m torch.distributed.run --nproc-per-node 4 "
            f"-m scaletorch_tpu_torch.examples.device_mesh.mesh_demos")
    out = {}
    mesh = demo_mesh_api(dev.type)
    out["placements"] = demo_dtensor_placements(mesh)
    destroy(mesh)
    tp = MeshManager(tp=world, device_type=dev.type)
    with using_mesh_manager(tp):
        out["tp"] = demo_tensor_parallel(dev)
        out["sp"] = demo_sequence_parallel(dev)
    out["hsdp"] = demo_fsdp_dp(dev.type)
    out["fsdp_tp"] = demo_fsdp_tp(dev.type)
    tp.destroy()
    if dist.get_rank() == 0:
        print("all device-mesh demos passed")
    return out


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
