"""The 5-axis device mesh of the port (counterpart of
scaletorch_tpu/parallel/mesh.py).

A ``MeshManager`` holds the axis sizes of the ``("dp", "pp", "cp", "ep",
"tp")`` grid, the rank arithmetic (tp varies fastest, then ep, cp, pp,
dp: the reference's decomposition) and, when a process group is up, the
``torch.distributed.device_mesh.DeviceMesh`` over it
(``init_device_mesh``, whose ranks are ``arange(world).view(shape)``, the
same row-major order). Each axis's process group comes from the mesh;
the fused data group ``("dp", "cp")`` (the gradient mean), at ep > 1 the
batch group ``("dp", "cp", "ep")`` (the mean of every leaf but the expert
shards) and, at ep > 1 and tp > 1, the expert group ``("ep", "tp")`` (the
serving MoE's combine) are made once with ``new_group`` over the same
rank sets.
``destroy`` frees the groups' communicators.

Unlike the reference's rank-agnostic manager, a rank lives in one
process here: ``rank`` and ``axis_rank`` give this process's place, and
the ring and stage neighbours are given both as coordinates (the
reference's pure helpers) and as global ranks (``cp_ring_peers``, what
``torch.distributed`` point-to-point calls take).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from scaletorch_tpu_torch import dist as stdist

# tp is fastest-varying (the reference's view(dp, pp, cp, ep, tp))
MESH_AXES: Tuple[str, ...] = ("dp", "pp", "cp", "ep", "tp")
# the gradient all-reduce group (the reference's cp_dp_group)
DATA_AXES: Tuple[str, ...] = ("dp", "cp")
# the ranks that see distinct data: the batch rows also shard over ep
BATCH_AXES: Tuple[str, ...] = ("dp", "cp", "ep")
# every expert slice of a token when the experts split over ep and their
# intermediate dim over tp (the serving MoE's one all-reduce a layer)
EXPERT_AXES: Tuple[str, ...] = ("ep", "tp")


@dataclasses.dataclass(frozen=True)
class MeshCoords:
    """Coordinates of one rank in the 5-axis grid."""

    dp: int
    pp: int
    cp: int
    ep: int
    tp: int

    def as_tuple(self) -> Tuple[int, int, int, int, int]:
        return (self.dp, self.pp, self.cp, self.ep, self.tp)


class MeshManager:
    """Axis sizes, grid arithmetic and, with ``device_type`` and a live
    default process group, the ``DeviceMesh`` and its groups.

    Without ``device_type`` (or without a process group, which a mesh of
    one rank does not need) it is the grid arithmetic alone: ``mesh`` is
    None, this process is rank 0 and no group exists."""

    def __init__(self, tp: int = 1, cp: int = 1, pp: int = 1, dp: int = 1,
                 ep: int = 1, *, device_type: Optional[str] = None) -> None:
        for name, size in (("tp", tp), ("cp", cp), ("pp", pp), ("dp", dp),
                           ("ep", ep)):
            if size < 1:
                raise ValueError(f"{name} size must be >= 1, got {size}")
        self.tp, self.cp, self.pp, self.dp, self.ep = tp, cp, pp, dp, ep
        self._mesh = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        self.rank = 0
        if device_type is None or not dist.is_initialized():
            if device_type is not None and self.world_size != 1:
                raise ValueError(
                    f"a mesh of {self.world_size} ranks needs a process "
                    "group: call dist.init_distributed first")
            return
        world = dist.get_world_size()
        if world != self.world_size:
            raise ValueError(
                f"mesh dims dp*pp*cp*ep*tp = {self.dp}*{self.pp}*{self.cp}*"
                f"{self.ep}*{self.tp} = {self.world_size} != world size "
                f"{world}")
        from torch.distributed.device_mesh import init_device_mesh

        self.rank = dist.get_rank()
        self._mesh = init_device_mesh(device_type, self.shape,
                                      mesh_dim_names=MESH_AXES)
        for axis in MESH_AXES:
            self._groups[(axis,)] = self._mesh.get_group(axis)
        # every rank makes every fused group, in one order; at ep 1 the
        # batch group is the data group, and the expert group is one axis's
        # group unless both ep and tp split
        fused = (DATA_AXES, BATCH_AXES) if self.ep > 1 else (DATA_AXES,)
        if self.ep > 1 and self.tp > 1:
            fused += (EXPERT_AXES,)
        for axes in fused:
            for ranks in self.axis_rank_sets(axes):
                group = dist.new_group(ranks, timeout=stdist.group_timeout())
                if self.rank in ranks:
                    self._groups[axes] = group
        self._groups.setdefault(BATCH_AXES, self._groups[DATA_AXES])
        self._groups.setdefault(
            EXPERT_AXES, self._groups[("ep",) if self.ep > 1 else ("tp",)])

    def destroy(self) -> None:
        """Destroy this manager's process groups (each holds a
        communicator and its buffers on the card); the manager is the
        grid arithmetic alone afterwards. The default group stays."""
        if self._mesh is None:
            return
        default = dist.distributed_c10d._get_default_group()
        for group in {id(g): g for g in self._groups.values()}.values():
            if group is not None and group is not default:
                dist.destroy_process_group(group)
        self._groups.clear()
        self._mesh = None

    def forget(self) -> None:
        """Drop this manager's groups without a collective, after
        ``dist.leave_process_group`` tore every group down (an elastic
        membership change); the manager is the grid arithmetic alone
        afterwards."""
        self._groups.clear()
        self._mesh = None

    def checkpoint_group(self):
        """A gloo group over every rank of the mesh that only the
        checkpoint's writer thread uses (its collectives must not cross
        the host group's decisions on the main thread); made once, on the
        first call, which every rank makes in one order. None without a
        process group."""
        if self._mesh is None:
            return None
        if ("checkpoint",) not in self._groups:
            self._groups[("checkpoint",)] = dist.new_group(
                backend="gloo", timeout=stdist.group_timeout())
        return self._groups[("checkpoint",)]

    def host_group(self):
        """A gloo group over every rank of the mesh, for decisions made on
        the host and shared (the default group when it is gloo; made once,
        on the first call, which every rank makes in one order). None
        without a process group."""
        if self._mesh is None:
            return None
        if ("host",) not in self._groups:
            self._groups[("host",)] = (
                dist.group.WORLD if dist.get_backend() == "gloo"
                else dist.new_group(backend="gloo",
                                    timeout=stdist.group_timeout()))
        return self._groups[("host",)]

    # ---- sizes --------------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int, int, int, int]:
        return (self.dp, self.pp, self.cp, self.ep, self.tp)

    @property
    def world_size(self) -> int:
        return math.prod(self.shape)

    @property
    def mesh(self):
        """The ``DeviceMesh``, or None without a process group."""
        return self._mesh

    def axis_size(self, axis: str) -> int:
        return dict(zip(MESH_AXES, self.shape))[axis]

    # ---- rank decomposition -------------------------------------------------
    def coords(self, rank: int) -> MeshCoords:
        """Decompose a global rank; tp fastest, then ep, cp, pp, dp."""
        if not 0 <= rank < self.world_size:
            raise ValueError(f"rank {rank} out of range [0, {self.world_size})")
        tp_rank = rank % self.tp
        ep_rank = (rank // self.tp) % self.ep
        cp_rank = (rank // (self.tp * self.ep)) % self.cp
        pp_rank = (rank // (self.tp * self.ep * self.cp)) % self.pp
        dp_rank = rank // (self.tp * self.ep * self.cp * self.pp)
        return MeshCoords(dp=dp_rank, pp=pp_rank, cp=cp_rank, ep=ep_rank,
                          tp=tp_rank)

    def rank_of(self, coords: MeshCoords) -> int:
        c = coords
        return (((((c.dp * self.pp) + c.pp) * self.cp + c.cp) * self.ep
                 + c.ep) * self.tp + c.tp)

    @property
    def my_coords(self) -> MeshCoords:
        return self.coords(self.rank)

    def axis_rank(self, axis: str) -> int:
        """This process's coordinate along ``axis``."""
        return getattr(self.my_coords, axis)

    def axis_rank_sets(self, axes: Sequence[str]) -> list:
        """The rank sets of the groups over ``axes`` (each set varies
        ``axes`` and fixes the others), in rank order of their first
        member; every rank lies in exactly one."""
        sets: Dict[MeshCoords, list] = {}
        for rank in range(self.world_size):
            key = dataclasses.replace(self.coords(rank),
                                      **{axis: 0 for axis in axes})
            sets.setdefault(key, []).append(rank)
        return list(sets.values())

    def group(self, axes) -> Optional[object]:
        """The process group over one axis name or the fused
        ``DATA_AXES`` / ``BATCH_AXES`` / ``EXPERT_AXES``; None without a
        process group."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        if self._mesh is None:
            return None
        return self._groups[key]

    # ---- ring / stage neighbours ---------------------------------------------
    # cp ring: rank r sends K/V to (r+1) % cp and receives from (r-1) % cp
    def cp_send_rank(self, cp_rank: int) -> int:
        return (cp_rank + 1) % self.cp

    def cp_recv_rank(self, cp_rank: int) -> int:
        return (cp_rank - 1) % self.cp

    def cp_ring_permutation(self) -> list:
        """(source, dest) pairs along the cp axis."""
        return [(i, (i + 1) % self.cp) for i in range(self.cp)]

    def cp_ring_peers(self) -> Tuple[int, int]:
        """(global rank this process sends to, global rank it receives
        from) on its cp ring."""
        c = self.my_coords
        send = dataclasses.replace(c, cp=self.cp_send_rank(c.cp))
        recv = dataclasses.replace(c, cp=self.cp_recv_rank(c.cp))
        return self.rank_of(send), self.rank_of(recv)

    # pp chain: stage s feeds s+1, no wraparound
    def pp_next_rank(self, pp_rank: int) -> Optional[int]:
        return pp_rank + 1 if pp_rank < self.pp - 1 else None

    def pp_prev_rank(self, pp_rank: int) -> Optional[int]:
        return pp_rank - 1 if pp_rank > 0 else None

    def pp_is_first_stage(self, pp_rank: int) -> bool:
        return pp_rank == 0

    def pp_is_last_stage(self, pp_rank: int) -> bool:
        return pp_rank == self.pp - 1

    def pp_fwd_permutation(self) -> list:
        return [(i, i + 1) for i in range(self.pp - 1)]

    def pp_bwd_permutation(self) -> list:
        return [(i + 1, i) for i in range(self.pp - 1)]

    def pp_ring_peers(self) -> Tuple[int, int]:
        """(global rank of the next stage, of the previous one) of this
        process, wrapping around (the interleaved pipeline's ring; the
        chain never uses the wrap)."""
        c = self.my_coords
        nxt = dataclasses.replace(c, pp=(c.pp + 1) % self.pp)
        prev = dataclasses.replace(c, pp=(c.pp - 1) % self.pp)
        return self.rank_of(nxt), self.rank_of(prev)

    def __repr__(self) -> str:
        return (f"MeshManager(dp={self.dp}, pp={self.pp}, cp={self.cp}, "
                f"ep={self.ep}, tp={self.tp}, world={self.world_size})")


# ---- the process-wide manager (the reference's mesh_manager proxy) ----------
_instance: Optional[MeshManager] = None


class _MeshManagerProxy:
    """Resolves to the manager ``setup_mesh_manager`` made; ``bool`` says
    whether there is one."""

    def __getattr__(self, name: str):
        if _instance is None:
            raise RuntimeError(
                "MeshManager not initialised; call setup_mesh_manager(...) "
                "first")
        return getattr(_instance, name)

    def __bool__(self) -> bool:
        return _instance is not None

    def __repr__(self) -> str:
        return repr(_instance) if _instance is not None else (
            "MeshManager(<unset>)")


mesh_manager = _MeshManagerProxy()


def setup_mesh_manager(tp: int = 1, cp: int = 1, pp: int = 1, dp: int = 1,
                       ep: int = 1, *, device_type: Optional[str] = None
                       ) -> MeshManager:
    global _instance
    _instance = MeshManager(tp=tp, cp=cp, pp=pp, dp=dp, ep=ep,
                            device_type=device_type)
    return _instance


def reset_mesh_manager() -> None:
    global _instance
    _instance = None


@contextlib.contextmanager
def using_mesh_manager(mm: MeshManager):
    """``mm`` is the current manager inside the block (the train step
    installs its own for its forward, backward and recomputation), and the
    previous one after it."""
    global _instance
    previous = _instance
    _instance = mm
    try:
        yield mm
    finally:
        _instance = previous


def current_mesh_manager() -> MeshManager:
    """The manager ``setup_mesh_manager`` made (raises without one)."""
    if _instance is None:
        raise RuntimeError(
            "MeshManager not initialised; call setup_mesh_manager(...) first")
    return _instance


def axis_group(axis: Optional[str]):
    """The process group of mesh axis ``axis`` (or of the fused
    ``DATA_AXES``) of the current manager; None for ``axis`` None and for
    a manager without a process group (one rank)."""
    if axis is None:
        return None
    if _instance is None:
        raise RuntimeError(
            f"axis={axis!r} needs a mesh: call "
            "parallel.mesh.setup_mesh_manager(...) first")
    return _instance.group(axis)


# ---- collectives shared by the parallel layers and the train step ------------
def group_size(group) -> int:
    """The ranks of ``group``; 1 for None (one device)."""
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in place when ``x`` is contiguous;
    ``x`` itself on one rank."""
    if group_size(group) > 1:
        x = x.contiguous()
        dist.all_reduce(x, group=group)
    return x


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order;
    ``x`` itself on one rank."""
    world = group_size(group)
    if world == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


# ---- elastic remesh (resilience_distributed.ElasticCoordinator) ----------------
class MeshShrinkError(ValueError):
    """The requested host-count change cannot be absorbed by the dp axis:
    the loud abort to the fleet-restart fallback (the trainer turns it
    into ``ElasticRemeshError``)."""


def elastic_mesh_kwargs(kwargs: dict, *, hosts_before: int,
                        hosts_after: int) -> dict:
    """Axis sizes for a fleet that changed its process count: dp shrinks
    (or grows), tp/pp/cp/ep stay. Every process carries ``dp / hosts``
    whole data-parallel replicas; a geometry where dp does not divide by
    the process count (tp/pp/cp/ep span processes) raises
    ``MeshShrinkError``."""
    if hosts_before < 1 or hosts_after < 1:
        raise MeshShrinkError(
            f"host counts must be >= 1, got {hosts_before} -> {hosts_after}")
    dp = int(kwargs.get("dp", 1))
    if dp % hosts_before != 0:
        raise MeshShrinkError(
            f"elastic remesh needs dp divisible by the host count so every "
            f"host holds whole dp replicas (dp={dp}, hosts={hosts_before}): "
            "tp/pp/cp/ep would span hosts and cannot shrink — falling back "
            "to a fleet restart"
        )
    per_host = dp // hosts_before
    out = dict(kwargs)
    out["dp"] = per_host * hosts_after
    return out
