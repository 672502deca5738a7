"""The collective recorder: what an audit entry sends between ranks.

PyTorch counterpart of the reference's ``analysis/hlo.py``, which read
the collectives out of compiled HLO text. The port has no compiled
program to read: its collectives are ``c10d`` dispatcher ops issued on
a ``DeviceMesh`` group (``torch.distributed.all_reduce`` and the rest,
or the functional collectives). ``CollectiveRecorder`` is a
``TorchDispatchMode`` that sees each of them as it is issued and logs
one ``Collective`` per op: the op in the reference's HLO spelling
(``all-reduce``, ``all-gather``, ``all-to-all``, ``reduce-scatter``,
``collective-permute``, ``broadcast``), the payload dtype, the mesh
axis of its group (``axis_names`` maps a group to the axis it spans),
the payload elements and bytes, the result bytes, the group size and
the ring-model wire bytes:

    all-reduce:              2 * bytes * (g-1)/g
    all-gather/all-to-all:       bytes * (g-1)/g   (of the result)
    reduce-scatter:              bytes * (g-1)     (result is 1/g)
    broadcast:                   bytes * (g-1)/g
    collective-permute:          bytes             (one hop)

as the reference's ``collective_wire_bytes`` reckons them. Groups of one
member move nothing and are not recorded.

``microbatch`` is set by the audit while an entry's microbatch loop
runs (``entry_audit.py``); a record made before the loop's last
microbatch began is ``in_loop``. Under the ``fake`` process group
(one process standing for a whole world) a collective's receive buffers
hold whatever the fake backend leaves there; the audited paths never
branch on them, and ``tests/test_torch_analysis_deep.py`` holds the
fake world's record to a real gloo world's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# c10d op -> (the reference's op name, index of the input payload,
# index of the result)
_C10D_OPS = {
    "allreduce_": ("all-reduce", 0, 0),
    "allreduce_coalesced_": ("all-reduce", 0, 0),
    "allgather_": ("all-gather", 1, 0),
    "_allgather_base_": ("all-gather", 1, 0),
    "allgather_coalesced_": ("all-gather", 1, 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
    "alltoall_": ("all-to-all", 1, 0),
    "alltoall_base_": ("all-to-all", 1, 0),
    "reduce_scatter_": ("reduce-scatter", 1, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
    "broadcast_": ("broadcast", 0, 0),
    "send": ("collective-permute", 0, 0),
    "recv_": ("collective-permute", 0, 0),
}
_FUNCTIONAL_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}
# torch dtype -> the reference's HLO dtype names (the comm budget's keys)
HLO_DTYPE = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
             "float64": "f64", "int8": "s8", "uint8": "u8", "int32": "s32",
             "int64": "s64", "bool": "pred"}


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective an entry issued."""

    op: str             # all-reduce | all-gather | all-to-all | ...
    dtype: str          # payload dtype (torch name: float32, int8, ...)
    axis: str           # mesh axis of the group ("dp", "dp,cp"; "world")
    elems: int          # max(payload, result) elements
    bytes: int          # max(payload, result) bytes
    result_bytes: int   # bytes of the result
    group_size: int
    wire_bytes: float   # ring-model estimate (module docstring)
    in_loop: bool       # issued before the last microbatch began

    @property
    def axes(self) -> tuple:
        return tuple(self.axis.split(",")) if self.axis else ()

    @property
    def hlo_dtype(self) -> str:
        return HLO_DTYPE.get(self.dtype, self.dtype)


def wire_bytes(op: str, result_bytes: int, group: int) -> float:
    """Ring/bidirectional-exchange wire bytes of one collective."""
    if op == "collective-permute":
        return float(result_bytes)
    return {
        "all-reduce": 2.0 * result_bytes * (group - 1) / group,
        "all-gather": result_bytes * (group - 1) / group,
        "all-to-all": result_bytes * (group - 1) / group,
        "broadcast": result_bytes * (group - 1) / group,
        "reduce-scatter": float(result_bytes) * (group - 1),
    }[op]


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _size(ts: Iterable[torch.Tensor]):
    elems = nbytes = 0
    for t in ts:
        elems += t.numel()
        nbytes += t.numel() * t.element_size()
    return elems, nbytes


def mesh_axis_names(mm) -> Dict[str, str]:
    """group name -> the axes it spans ("dp", "dp,cp"), for every group
    of a ``parallel/mesh.MeshManager`` (the first axes tuple that names a
    group wins: a fused group that IS one axis's group keeps that axis's
    name)."""
    names: Dict[str, str] = {}
    for axes, group in getattr(mm, "_groups", {}).items():
        if group is not None:
            names.setdefault(group.group_name, ",".join(axes))
    return names


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective dispatched while it is active (see the
    module docstring). ``axis_names`` maps a process group's name to its
    mesh axes; the default group reads as "world"."""

    def __init__(self, axis_names: Optional[Dict[str, str]] = None) -> None:
        super().__init__()
        self.axis_names = dict(axis_names or {})
        self.records: List[Collective] = []
        self.microbatch: Optional[int] = None
        self.microbatches: Optional[int] = None

    def _group(self, func, args, kwargs):
        from torch.distributed import ProcessGroup

        if func.namespace == "_c10d_functional":
            name = next((a for a in list(args) + list(kwargs.values())
                         if isinstance(a, str)), "")
            from torch.distributed.distributed_c10d import (
                _resolve_process_group,
            )

            try:
                pg = _resolve_process_group(name)
            except Exception:  # an unknown name: size unknown
                return name, 0
            return name, pg.size()
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:
                    pg = ProcessGroup.unbox(a)
                except RuntimeError:
                    continue  # a ReduceOp
                return pg.group_name, pg.size()
        return "", 0

    def _axis(self, group_name: str) -> str:
        from torch.distributed import distributed_c10d as c10d

        if group_name in self.axis_names:
            return self.axis_names[group_name]
        default = c10d._get_default_group() if c10d.is_initialized() \
            else None
        if default is not None and group_name == default.group_name:
            return "world"
        return f"group:{group_name}"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        if func.namespace == "c10d" and name in _C10D_OPS:
            op, i_in, i_out = _C10D_OPS[name]
            payload = _tensors(args[i_in]) if len(args) > i_in else []
            result = _tensors(args[i_out]) if len(args) > i_out else []
        elif func.namespace == "_c10d_functional" and \
                name in _FUNCTIONAL_OPS:
            op = _FUNCTIONAL_OPS[name]
            payload, result = _tensors(args[0]), _tensors(out)
        else:
            return out
        group_name, group = self._group(func, args, kwargs)
        if group == 1 or not payload:
            return out
        p_elems, p_bytes = _size(payload)
        r_elems, r_bytes = _size(result or payload)
        in_loop = (self.microbatch is not None
                   and self.microbatches is not None
                   and self.microbatch < self.microbatches - 1)
        self.records.append(Collective(
            op=op, dtype=str(payload[0].dtype).replace("torch.", ""),
            axis=self._axis(group_name), elems=max(p_elems, r_elems),
            bytes=max(p_bytes, r_bytes), result_bytes=r_bytes,
            group_size=group,
            wire_bytes=wire_bytes(op, r_bytes, max(group, 1)),
            in_loop=in_loop))
        return out

