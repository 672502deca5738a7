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
group or a gloo group given as ``group`` (``torch.distributed.
all_gather_object``).

An elastic gloo run (``leave_process_group``, ``join_process_group``)
leaves a membership epoch's groups without a collective (a peer may be
dead) and joins the next epoch's group at its own ``file://``
rendezvous. An NCCL group is never left in place
(``can_reform_in_process``): NCCL's error handling keeps its default, so
a collective that outlasts the group's timeout (a lost peer) ends the
process, and the launcher restarts the fleet.
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
# destroys only a group it made), and the timeout it was made with (the
# mesh's own groups take it too)
_owned = False
_timeout_s = DEFAULT_TIMEOUT_S


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


def restart_count() -> int:
    """How many times the launcher restarted this rank (torchrun's and
    ``launch.py``'s ``TORCHELASTIC_RESTART_COUNT``), else 0."""
    return int(os.environ.get("TORCHELASTIC_RESTART_COUNT", "0") or 0)


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


def launch_identity(launcher: str = "auto",
                    coordinator_address: Optional[str] = None,
                    num_processes: Optional[int] = None,
                    process_id: Optional[int] = None):
    """``(rank, world)`` as the launcher started this process, before
    any group exists; ``(0, 1)`` for a single process."""
    if launcher == "auto":
        launcher = infer_launcher()
    if launcher == "none":
        return 0, 1
    _, world, rank = _rendezvous(launcher, coordinator_address,
                                 num_processes, process_id)
    return rank, world


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
    _set_timeout(timeout_s)
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


def leave_process_group() -> None:
    """Destroy the default gloo group and every subgroup without a
    collective (a peer may be dead). An NCCL group cannot be left so
    (``can_reform_in_process``)."""
    global _owned
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        raise RuntimeError("leave_process_group: an NCCL group is not left "
                           "in place (dist.can_reform_in_process)")
    dist.destroy_process_group()
    _owned = False


def join_process_group(init_method: str, world: int, rank: int, *,
                       device: DeviceLike = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Form a new default group (after ``leave_process_group``) at
    ``init_method`` (``file://`` of one membership epoch), NCCL on the
    card and gloo on the CPU, every wait bounded by ``timeout_s``."""
    global _owned
    if dist.is_initialized():
        raise RuntimeError("join_process_group: leave the current group "
                           "first")
    _set_timeout(timeout_s)
    dev = resolve_device(device)
    kwargs = {}
    if dev.type == "cuda":
        backend = "nccl"
        kwargs["device_id"] = torch.device("cuda", local_rank())
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    _owned = True
    get_logger().info(f"process group formed at {init_method}: "
                      f"process {rank}/{world} backend={backend}")


def _set_timeout(timeout_s: float) -> None:
    global _timeout_s
    _timeout_s = float(timeout_s)


def group_timeout() -> datetime.timedelta:
    """The default group's timeout, for every group made beside it
    (``new_group`` would otherwise take the backend's default, 30 min for
    gloo, and a lost peer would surface that late)."""
    return datetime.timedelta(seconds=_timeout_s)


def store_barrier(name: str, timeout_s: float) -> None:
    """Every process of the default group reaches ``name``, waited for
    on the group's store up to ``timeout_s`` (not the group's timeout: a
    rank admitted by a grow builds its model between the rendezvous and
    the restore the members start at once)."""
    store = dist.distributed_c10d._get_default_store()
    store.set(f"{name}/{dist.get_rank()}", "1")
    store.wait([f"{name}/{r}" for r in range(dist.get_world_size())],
               datetime.timedelta(seconds=timeout_s))


def can_reform_in_process(backend: Optional[str] = None) -> bool:
    """Whether a process can leave a group whose peer died and form the
    next membership epoch's group in place. Gloo can. NCCL could not on
    four H100s (torch 2.11.0+cu128): with the communicator-abort error
    handling, an all-reduce with a SIGKILLed peer never returned within
    300 s, and the survivors' abort of their NCCL groups ended them with
    SIGSEGV. An elastic NCCL run therefore takes the reference's
    fallback, a fleet restart from the newest checkpoint: a survivor
    that learns of the loss on the gloo decision bus exits 43
    (``ElasticRemeshError``), and one blocked in an NCCL collective is
    ended by NCCL's watchdog at the group's timeout (the elastic
    deadline). ``backend``: the one a group would have (default: the
    current group's)."""
    if backend is None:
        backend = dist.get_backend() if dist.is_initialized() else "gloo"
    return backend != "nccl"


def is_distributed() -> bool:
    return process_count() > 1


def process_index(group: Any = None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def process_count(group: Any = None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point; a no-op for one
    process. ``name`` is kept for the reference's signature."""
    del name
    if process_count() > 1:
        dist.barrier()


def all_gather_object(obj: Any, group: Any = None) -> List[Any]:
    """``[obj_0, ..., obj_{P-1}]`` on every process of ``group`` (the
    default group when None), in process order."""
    n = process_count(group)
    if n == 1:
        return [obj]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def gather_object(obj: Any, dst: int = 0) -> Optional[List[Any]]:
    """The picklables of every process on ``dst``; None elsewhere. The
    transport is an all-gather, as in the reference."""
    out = all_gather_object(obj)
    return out if process_index() == dst else None


def broadcast_object_list(objs: list, src: int = 0,
                          group: Any = None) -> list:
    """Replace every element with ``src``'s version (an index into
    ``group``), in place."""
    if process_count(group) == 1:
        return list(objs)
    mine = list(objs) if process_index(group) == src else None
    chosen = all_gather_object(mine, group=group)[src]
    if len(chosen) != len(objs):
        raise ValueError(
            f"broadcast_object_list: src={src} holds {len(chosen)} objects, "
            f"this process expected {len(objs)}")
    objs[:] = chosen
    return objs
