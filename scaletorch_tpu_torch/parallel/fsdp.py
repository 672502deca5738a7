"""FSDP: parameter and optimizer-state sharding over the data axis
(counterpart of scaletorch_tpu/parallel/fsdp.py).

Every rank stores 1/N of each sharded parameter and of its optimizer
state (ZeRO-3 and ZeRO-1), gathers a layer's full parameters just in
time for its compute (and again for its recomputation under gradient
checkpointing), and reduce-scatters the gradients back to the owning
shard. The result is the replicated step's.

The reference gets this schedule from XLA's SPMD partitioner once the
leaves are placed sharded. Here the train step is functional over a
parameter tree (``trainer/train_step.py``), not over ``nn.Module``s, so
FSDP2's ``fully_shard`` (which also always splits dim 0) does not fit;
instead:

  * each leaf is split on the reference's dim, its LARGEST dim divisible
    by N (``fsdp_param_specs``; replicated when none is), and a rank
    keeps its slice (``shard_params_fsdp``, or ``fsdp_local_slice`` as
    ``llama.init_params`` draws the leaves);
  * ``FsdpGather`` turns shards into full leaves through an autograd
    all-gather whose backward is the reduce-scatter
    (``sequence_parallel.all_gather_sequence`` on the data group): the
    leaves outside the layer stack (and a stacked leaf split on its layer
    dim) once per forward, each layer's weights inside that layer's
    function where ``llama.decoder_stack`` unbinds them, so a
    checkpointed layer gathers again when it is recomputed;
  * ``FsdpReductions`` (the step's ``MeshHooks``) takes the data mean:
    the loss over the ranks, a sharded leaf's reduce-scattered sum over
    N, a replicated leaf's all-reduced mean; the global norm counts each
    shard once, so every rank takes the same clip and non-finite branch;
  * the optimizer updates the local shards (AdamW and its kin work leaf
    by leaf; Adafactor is given the split dims, ``trainer/factored.py``).

The fsdp axis is the data axis: ``make_fsdp_mesh`` is a ``MeshManager``
with ``dp`` = N, and each rank takes its rows of the global batch
(``spmd.local_batch``). Dense Llama/Qwen3 models, as the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from scaletorch_tpu_torch.parallel.mesh import (
    MeshManager,
    all_reduce_,
    using_mesh_manager,
)
from scaletorch_tpu_torch.trainer.optimizer import tree_leaves
from scaletorch_tpu_torch.trainer.train_step import (
    MeshHooks,
    global_grad_norm,
    make_train_step,
)

Tensor = torch.Tensor
AXIS = "fsdp"
# the mesh axis that carries fsdp: the data axis
MESH_AXIS = "dp"


def _spec_for(shape: Tuple[int, ...], n: int) -> Optional[int]:
    """The largest dim of ``shape`` divisible by ``n`` (ties: the first),
    None when no dim qualifies or ``n`` is 1 (the reference's rule)."""
    if n == 1 or not shape:
        return None
    for i in sorted(range(len(shape)), key=lambda d: shape[d], reverse=True):
        if shape[i] >= n and shape[i] % n == 0:
            return i
    return None


def fsdp_param_specs(params: Dict[str, Any], fsdp_size: int,
                     axis: str = AXIS) -> Dict[str, Any]:
    """The dim of each leaf split over the fsdp axis (None: replicated),
    in the tree's nesting: its largest dim divisible by ``fsdp_size``.
    Leaves are anything with a ``shape`` (tensors, numpy arrays). The
    reference's ``PartitionSpec`` has ``axis`` at this index."""
    del axis  # one axis; named for the reference's signature
    return {k: (fsdp_param_specs(v, fsdp_size) if isinstance(v, dict)
                else _spec_for(tuple(v.shape), fsdp_size))
            for k, v in params.items()}


def make_fsdp_mesh(n_devices: Optional[int] = None, axis: str = AXIS, *,
                   device_type: Optional[str] = "cuda") -> MeshManager:
    """The 1-D fsdp mesh: a ``MeshManager`` with ``dp`` = N, every rank a
    process (N defaults to the world size; it must equal it)."""
    del axis
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"an fsdp mesh of {n} needs {n} processes, have "
                         f"{world}")
    return MeshManager(dp=n, device_type=device_type)


def _slice(t: Any, dim: Optional[int], n: int, i: int) -> Any:
    if dim is None or n == 1:
        return t
    width = t.shape[dim] // n
    index = [slice(None)] * t.ndim
    index[dim] = slice(i * width, (i + 1) * width)
    return t[tuple(index)]


def fsdp_local_slice(specs: Dict[str, Any], mesh: MeshManager
                     ) -> Callable[[str, Tensor], Tensor]:
    """``fn(flat_name, leaf) -> this rank's slice`` (a tensor of its own)
    for ``llama.init_params``' ``local_slice``: each rank draws the same
    full leaf, one at a time, and keeps its part."""
    from scaletorch_tpu_torch.models.convert import flatten_params

    flat = flatten_params(specs)
    n, i = mesh.axis_size(MESH_AXIS), mesh.axis_rank(MESH_AXIS)

    def fn(name: str, leaf: Tensor) -> Tensor:
        part = _slice(leaf, flat[name], n, i)
        return part if part is leaf else part.contiguous().clone()

    return fn


def shard_params_fsdp(mesh: MeshManager, params: Dict[str, Any],
                      specs: Dict[str, Any], *,
                      device: Optional[torch.device] = None,
                      dtype: Optional[torch.dtype] = None,
                      requires_grad: bool = True) -> Dict[str, Any]:
    """This rank's slice of every leaf of ``params`` (numpy arrays or
    tensors, the full tree) as tensors of their own on ``device`` (the
    leaves' own by default), in ``dtype`` (kept by default), with
    ``requires_grad``: the training parameters of ``make_fsdp_train_step``."""
    n, i = mesh.axis_size(MESH_AXIS), mesh.axis_rank(MESH_AXIS)

    def one(leaf, dim):
        t = (leaf if isinstance(leaf, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(leaf)))
        part = _slice(t.detach(), dim, n, i)
        part = part.to(device=device or part.device,
                       dtype=dtype or part.dtype).contiguous().clone()
        return part.requires_grad_(requires_grad)

    return {k: (shard_params_fsdp(mesh, v, specs[k], device=device,
                                  dtype=dtype, requires_grad=requires_grad)
                if isinstance(v, dict) else one(v, specs[k]))
            for k, v in params.items()}


class FsdpGather:
    """Shards -> full leaves, differentiably (all-gather forward,
    reduce-scatter backward on the data group of the current mesh
    manager). ``outer`` gathers what the whole forward uses at once;
    ``layer`` gathers one layer's weights inside that layer's function."""

    def __init__(self, specs: Dict[str, Any], n: int) -> None:
        self.specs, self.n = specs, n

    def _gather(self, t: Tensor, dim: Optional[int]) -> Tensor:
        if dim is None or self.n == 1:
            return t
        from scaletorch_tpu_torch.parallel.sequence_parallel import (
            all_gather_sequence,
        )

        return all_gather_sequence(t, MESH_AXIS, dim)

    def outer(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Every leaf outside the layer stack gathered, and a stacked leaf
        split on its layer dim (it cannot be cut per layer); the other
        stacked leaves stay shards, for ``layer``."""
        layers = {k: (self._gather(v, 0) if self.specs["layers"][k] == 0
                      else v) for k, v in params["layers"].items()}
        out = {k: self._gather(v, self.specs[k]) for k, v in params.items()
               if k != "layers"}
        return {**out, "layers": layers}

    def layer(self, weights: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """One layer's weights (its slices of the stacked leaves), each
        leaf split on dim d > 0 of the stack gathered on dim d - 1."""
        out = {}
        for k, w in weights.items():
            dim = self.specs["layers"][k]
            out[k] = w if dim in (None, 0) else self._gather(w, dim - 1)
        return out


class FsdpReductions(MeshHooks):
    """The step's reductions over the fsdp (data) axis of ``mesh`` (the
    module docstring); nothing at N = 1."""

    def __init__(self, mesh: MeshManager, specs: Dict[str, Any]) -> None:
        from scaletorch_tpu_torch.models.convert import flatten_params

        self.mm = mesh
        self.n = mesh.axis_size(MESH_AXIS)
        self.group = mesh.group(MESH_AXIS) if self.n > 1 else None
        self.sharded = [d is not None for d in flatten_params(specs).values()]
        self.param_gather = FsdpGather(specs, self.n)

    def scope(self):
        return using_mesh_manager(self.mm)

    def reduce(self, params, loss: Tensor, grads: List[Tensor]
               ) -> Tuple[Tensor, List[Tensor]]:
        if self.n == 1:
            return loss, grads
        grads = list(grads)
        rest = [i for i, s in enumerate(self.sharded) if not s]
        if rest:
            flat = all_reduce_(torch.cat([grads[i].reshape(-1)
                                          for i in rest]), self.group)
            for i, part in zip(rest, flat.split(
                    [grads[i].numel() for i in rest])):
                grads[i] = part.view_as(grads[i])
        for g in grads:  # the sharded ones: the reduce-scatter's sums
            g.div_(self.n)
        loss = all_reduce_(loss.reshape(1).clone(), self.group)[0] / self.n
        return loss, grads

    def grad_norm(self, params, grads: List[Tensor]) -> Tensor:
        if self.n == 1:
            return global_grad_norm(grads)
        sq = [torch.linalg.vector_norm(g.float()).square() for g in grads]
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        shard = sum((s for s, k in zip(sq, self.sharded) if k), zero)
        whole = sum((s for s, k in zip(sq, self.sharded) if not k), zero)
        shard = all_reduce_(shard.reshape(1).clone(), self.group)[0]
        return torch.sqrt(shard + whole)

    def loss_sum(self, total: Tensor) -> Tuple[Tensor, int]:
        return all_reduce_(total.reshape(1), self.group)[0], self.n


def make_fsdp_train_step(cfg, optimizer, mesh: MeshManager, *,
                         specs: Dict[str, Any],
                         attention_backend: str = "sdpa",
                         gradient_checkpointing: bool = False,
                         remat_policy: str = "nothing_saveable",
                         max_grad_norm: float = 0.0,
                         axis: str = AXIS) -> Callable:
    """``step(params, opt_state, local_batch) -> (params, opt_state,
    metrics)`` on this rank's shards (``specs``: ``fsdp_param_specs``),
    updated in place. ``local_batch`` is this rank's rows of the global
    batch (``spmd.local_batch`` on ``mesh``). The step is
    ``make_train_step``'s with ``FsdpReductions``; at N = 1 it is the
    one-device step, bit for bit. ``max_grad_norm`` clips by the global
    norm (the reference chains its clip into the optimizer)."""
    del axis
    if hasattr(cfg, "num_experts"):
        raise NotImplementedError(
            "FSDP shards a dense Llama/Qwen3 model, as the reference's")
    return make_train_step(
        cfg, optimizer, attention_backend=attention_backend,
        gradient_checkpointing=gradient_checkpointing,
        remat_policy=remat_policy, max_grad_norm=max_grad_norm,
        mesh=FsdpReductions(mesh, specs))


def setup_fsdp(cfg, params_host: Dict[str, Any], optimizer, *,
               n_devices: Optional[int] = None, axis: str = AXIS,
               device: Optional[torch.device] = None,
               dtype: Optional[torch.dtype] = None,
               **step_kwargs) -> Tuple[Callable, Dict[str, Any],
                                       Dict[str, Any], MeshManager]:
    """One-call wiring: (step_fn, this rank's parameter shards, its
    optimizer state, the mesh). ``params_host`` is the full tree (numpy
    or tensors); each rank keeps its slices on ``device`` in ``dtype``
    (default: as given), and the optimizer state is made from the shards
    alone, so no rank holds a full copy of it (ZeRO-1 on ZeRO-3). An
    Adafactor is given the split dims, so its statistics are the whole
    leaves'."""
    dev = torch.device(device) if device is not None else None
    mesh = make_fsdp_mesh(n_devices, axis, device_type=(
        dev.type if dev is not None else "cuda"))
    specs = fsdp_param_specs(params_host, mesh.axis_size(MESH_AXIS), axis)
    params = shard_params_fsdp(mesh, params_host, specs, device=dev,
                               dtype=dtype)
    from scaletorch_tpu_torch.trainer.factored import Adafactor

    if isinstance(optimizer, Adafactor):
        from scaletorch_tpu_torch.models.convert import flatten_params

        optimizer.shard_dims = {name: ({} if d is None else {MESH_AXIS: d})
                                for name, d in flatten_params(specs).items()}
        optimizer.mesh = mesh
    opt_state = optimizer.init(params)
    step_fn = make_fsdp_train_step(cfg, optimizer, mesh, specs=specs,
                                   **step_kwargs)
    return step_fn, params, opt_state, mesh


def local_numel(tree: Dict[str, Any]) -> int:
    """Elements a rank stores for ``tree`` (parameters or a state)."""
    return sum(t.numel() for t in tree_leaves(tree))
