"""Multi-process bootstrap of the port (counterpart of
scaletorch_tpu/dist.py).

One process drives one card. ``init_distributed`` finds how the process
was started and joins the default ``torch.distributed`` process group:
NCCL on the card (after ``torch.cuda.set_device(local_rank)``), gloo
only when the caller asks for the CPU by name. The launcher discovery
is the reference's (``infer_launcher``): torchrun-style variables
(``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``, or the
``JAX_COORDINATOR_ADDRESS`` family the JAX package also reads), SLURM,
Open MPI, or a single process.

The reference's ``put_global`` has no counterpart: every rank holds
plain local shards (``models/convert.shard_numpy_params``,
``parallel/spmd.local_batch``), so there is no global array to
assemble. The object collectives move picklables over the default
group (``torch.distributed.all_gather_object``).
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from scaletorch_tpu_torch.utils.device import DeviceLike, resolve_device
from scaletorch_tpu_torch.utils.logger import get_logger

# the reference's names and order (scaletorch_tpu/env.py,
# ENV_LAUNCHER_RANK_VARS; dist.py _COORD_VARS/_NPROC_VARS)
_COORD_VARS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
_NPROC_VARS = ("JAX_NUM_PROCESSES", "NUM_PROCESSES", "WORLD_SIZE")
_PID_VARS = ("JAX_PROCESS_ID", "PROCESS_ID", "RANK")
_LOCAL_RANK_VARS = ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK")
DEFAULT_PORT = "29500"
DEFAULT_TIMEOUT_S = 600.0

# whether this module created the default group (shutdown_distributed
# destroys only a group it made)
_owned = False


def _first_env(names: Sequence[str]) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return v
    return None


def infer_launcher() -> str:
    """'env' (a coordinator address in the environment, torchrun's
    included), 'slurm', 'mpi' or 'none' (one process). A bare
    ``WORLD_SIZE`` without an address stays 'none'."""
    if _first_env(_COORD_VARS) or os.environ.get("MASTER_ADDR"):
        return "env"
    if "SLURM_NTASKS" in os.environ and int(os.environ["SLURM_NTASKS"]) > 1:
        return "slurm"
    if "OMPI_COMM_WORLD_SIZE" in os.environ:
        return "mpi"
    return "none"


def _env_coordinator() -> Optional[str]:
    addr = _first_env(_COORD_VARS)
    if addr:
        return addr
    host = os.environ.get("MASTER_ADDR")
    if host:
        return f"{host}:{os.environ.get('MASTER_PORT', DEFAULT_PORT)}"
    return None


def _slurm_first_host() -> Optional[str]:
    """The first host of ``SLURM_STEP_NODELIST`` / ``SLURM_NODELIST``
    ("node[03-05,9],gpu1" -> "node03")."""
    nodes = _first_env(("SLURM_STEP_NODELIST", "SLURM_NODELIST"))
    if not nodes:
        return None
    m = re.match(r"([^,\[]+)(?:\[([^\]]+)\])?", nodes)
    if m is None:
        return None
    prefix, ranges = m.group(1), m.group(2)
    if not ranges:
        return prefix
    return prefix + re.split(r"[-,]", ranges)[0]


def local_rank() -> int:
    """This process's index on its host (torchrun's ``LOCAL_RANK``,
    SLURM's ``SLURM_LOCALID``, Open MPI's local rank), else 0."""
    v = _first_env(_LOCAL_RANK_VARS)
    return int(v) if v is not None else 0


def _rendezvous(launcher: str, coordinator_address: Optional[str],
                num_processes: Optional[int],
                process_id: Optional[int]):
    """(init_method, world, rank) for ``launcher``."""
    if launcher == "env":
        addr = coordinator_address or _env_coordinator()
        nproc = (num_processes if num_processes is not None
                 else _first_env(_NPROC_VARS))
        pid = process_id if process_id is not None else _first_env(_PID_VARS)
    elif launcher == "slurm":
        host = _slurm_first_host()
        addr = coordinator_address or _env_coordinator() or (
            f"{host}:{DEFAULT_PORT}" if host else None)
        nproc = num_processes or os.environ.get("SLURM_NTASKS")
        pid = (process_id if process_id is not None
               else os.environ.get("SLURM_PROCID"))
    else:  # mpi
        addr = coordinator_address or _env_coordinator()
        nproc = num_processes or os.environ.get("OMPI_COMM_WORLD_SIZE")
        pid = (process_id if process_id is not None
               else os.environ.get("OMPI_COMM_WORLD_RANK"))
    if addr is None or nproc is None or pid is None:
        raise ValueError(
            f"{launcher} launcher needs coordinator_address, num_processes "
            "and process_id (flags, or MASTER_ADDR[:MASTER_PORT]/WORLD_SIZE/"
            "RANK as torchrun sets them, or JAX_COORDINATOR_ADDRESS/"
            "JAX_NUM_PROCESSES/JAX_PROCESS_ID)")
    # a full URL (file://..., tcp://...) is used as it is
    init_method = addr if "://" in addr else f"tcp://{addr}"
    return init_method, int(nproc), int(pid)


def init_distributed(
    launcher: str = "auto",
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: DeviceLike = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the default process group. Idempotent; True when more than
    one process takes part.

    ``launcher='auto'`` infers it from the environment; 'none' (and an
    'auto' that finds nothing) stays single-process without error.
    ``device`` None means the card: NCCL, after
    ``torch.cuda.set_device(local_rank())``; 'cpu' means gloo.
    ``coordinator_address`` is host:port or a URL (``file://`` for a
    FileStore rendezvous). ``timeout_s`` bounds the rendezvous and every
    collective."""
    global _owned
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if launcher == "auto":
        launcher = infer_launcher()
    if launcher == "none":
        return False
    if launcher not in ("env", "slurm", "mpi"):
        raise ValueError(
            f"launcher must be auto|env|slurm|mpi|none, got {launcher!r}")
    dev = resolve_device(device)
    init_method, world, rank = _rendezvous(
        launcher, coordinator_address, num_processes, process_id)
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank())
        backend = "nccl"
        kwargs["device_id"] = torch.device("cuda", local_rank())
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    _owned = True
    get_logger().info(
        f"distributed runtime up: launcher={launcher} backend={backend} "
        f"process {rank}/{world} local_rank={local_rank()}")
    return world > 1


def shutdown_distributed() -> None:
    """Destroy the default group if ``init_distributed`` created it."""
    global _owned
    if _owned and dist.is_initialized():
        dist.destroy_process_group()
    _owned = False


def is_distributed() -> bool:
    return process_count() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point; a no-op for one
    process. ``name`` is kept for the reference's signature."""
    del name
    if process_count() > 1:
        dist.barrier()


def all_gather_object(obj: Any) -> List[Any]:
    """``[obj_0, ..., obj_{P-1}]`` on every process, in process order."""
    if process_count() == 1:
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def gather_object(obj: Any, dst: int = 0) -> Optional[List[Any]]:
    """The picklables of every process on ``dst``; None elsewhere. The
    transport is an all-gather, as in the reference."""
    out = all_gather_object(obj)
    return out if process_index() == dst else None


def broadcast_object_list(objs: list, src: int = 0) -> list:
    """Replace every element with ``src``'s version, in place."""
    if process_count() == 1:
        return list(objs)
    mine = list(objs) if process_index() == src else None
    chosen = all_gather_object(mine)[src]
    if len(chosen) != len(objs):
        raise ValueError(
            f"broadcast_object_list: src={src} holds {len(chosen)} objects, "
            f"this process expected {len(objs)}")
    objs[:] = chosen
    return objs
