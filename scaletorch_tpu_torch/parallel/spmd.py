"""The training step over the device mesh (counterpart of
scaletorch_tpu/parallel/spmd.make_spmd_train_step / make_spmd_eval_step).

Each rank runs the same program on its local shards, with the
reference's per-rank semantics of ``shard_map``:

  * **Batch.** The host batch is global, ``[accum, dp*ep*micro, seq]``
    (every rank draws the same one from the seeded loader); a rank keeps
    the rows of its dp coordinate and the sequence slice of its cp
    coordinate (``local_batch``, the reference's ``batch_specs``), after
    the zigzag permutation for the zigzag ring. ``position_ids`` ride
    along, so RoPE and the loss are layout-transparent.
  * **Model.** The decoder runs its tensor-parallel path
    (``models/llama.py`` with ``tp_axis``; SP with
    ``sequence_parallel``) with the attention backend the trainer chose
    (``ring_zigzag``/``ring_contiguous``/``ulysses`` under cp, the
    flash kernels K1-K3 inside each); the loss is the vocab-parallel
    chunked CE, so full logits never exist.
  * **Accumulation.** Microbatches accumulate locally in fp32, then ONE
    flat gradient mean over the data group ``("dp", "cp")`` runs per step
    (fp32, or bf16 on the wire over ``grad_allreduce_axis`` with the
    other data axis reduced in fp32 first).
  * **tp.** A replicated leaf whose gradient is a partial over tp
    (``tensor_parallel.llama_grad_partial_over_tp``: the q/k norms, and
    every norm under SP) is summed over tp; a tp-sharded leaf is its
    shard's, and a replicated leaf that met replicated data is already
    whole on every rank.
  * **Norm, clip, guard, update.** The global norm counts each sharded
    leaf's square-sum once through an all-reduce over tp and each
    replicated leaf once without; loss and norm are reduced first, so
    every rank takes the same clip and the same nonfinite branch, and
    the port's optimizer updates the local shards in place.

The step body is ``trainer/train_step.make_train_step``'s; this module
supplies ``local_batch`` and the reductions (``MeshReductions``), which
do nothing at world 1, so there the step is the single-device one, bit
for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from scaletorch_tpu_torch.parallel.mesh import (
    DATA_AXES,
    MeshManager,
    all_reduce_,
    using_mesh_manager,
)
from scaletorch_tpu_torch.parallel.tensor_parallel import (
    llama_grad_partial_over_tp,
    llama_param_specs,
)
from scaletorch_tpu_torch.parallel.zigzag import zigzag_batch
from scaletorch_tpu_torch.trainer.optimizer import Optimizer
from scaletorch_tpu_torch.trainer.train_step import (
    MeshHooks,
    global_grad_norm,
    make_eval_step,
    make_grad_fn,
    make_train_step,
)

Tensor = torch.Tensor


def local_batch(batch: Dict[str, np.ndarray], mm: MeshManager, *,
                zigzag: bool = False) -> Dict[str, np.ndarray]:
    """This rank's part of the host-global step batch: ``input_ids``/
    ``target_ids`` ``[accum, dp*ep*micro, seq]`` -> the rows of its (dp,
    ep) coordinate (dp major) and the sequence slice of its cp
    coordinate; ``position_ids`` ``[accum, seq]`` -> the slice. With
    ``zigzag`` the sequence is permuted first (``zigzag_batch``)."""
    if zigzag:
        batch = zigzag_batch(batch, mm.cp)
    c = mm.my_coords
    out = {}
    for name, arr in batch.items():
        seq = arr.shape[-1]
        if seq % mm.cp:
            raise ValueError(f"{name}: sequence {seq} does not split over "
                             f"cp={mm.cp}")
        width = seq // mm.cp
        arr = arr[..., c.cp * width:(c.cp + 1) * width]
        if arr.ndim == 3:
            shards = mm.dp * mm.ep
            if arr.shape[1] % shards:
                raise ValueError(f"{name}: {arr.shape[1]} rows do not split "
                                 f"over dp*ep={shards}")
            rows = arr.shape[1] // shards
            r0 = (c.dp * mm.ep + c.ep) * rows
            arr = arr[:, r0:r0 + rows]
        out[name] = np.ascontiguousarray(arr)
    return out


def _check(mm: MeshManager, cfg, gradient_checkpointing: bool,
           remat_policy: str, grad_allreduce_dtype: str,
           grad_allreduce_axis: str) -> None:
    from scaletorch_tpu_torch.models.qwen3_moe import Qwen3MoEConfig

    if mm.pp > 1 or mm.ep > 1 or isinstance(cfg, Qwen3MoEConfig):
        raise NotImplementedError(
            "pipeline and expert parallelism and MoE over the mesh are "
            "ROADMAP Queue 1 item 6b")
    if grad_allreduce_dtype not in ("fp32", "bf16"):
        raise NotImplementedError(
            f"grad_allreduce_dtype={grad_allreduce_dtype!r}: the int8 "
            "all-reduce is ROADMAP Queue 1 item 6b")
    if grad_allreduce_axis not in DATA_AXES:
        raise ValueError(
            f"grad_allreduce_axis must be one of {DATA_AXES}, got "
            f"{grad_allreduce_axis!r}")
    if (mm.cp > 1 and gradient_checkpointing
            and remat_policy != "nothing_saveable"):
        raise NotImplementedError(
            f"remat_policy={remat_policy!r} under context parallelism: a "
            "selective policy would save some of the ring's ops and "
            "recompute others; use nothing_saveable (the whole layer, its "
            "exchanges re-issued in order)")


def _resolve_backend(attention_backend, cp_layout: str):
    # the ring's layout is the step's, named by its registry entry
    if attention_backend == "ring":
        return f"ring_{cp_layout}"
    return attention_backend


def per_leaf(params, spec: Dict[str, object]) -> List[object]:
    """``spec``'s entry for each leaf of ``params``, in ``tree_leaves``
    order (matched by key, whatever order the dicts were built in)."""
    out: List[object] = []
    for key, value in params.items():
        out.extend(per_leaf(value, spec[key]) if isinstance(value, dict)
                   else [spec[key]])
    return out


class MeshReductions(MeshHooks):
    """The step's reductions over ``mm``: the data mean of the loss and
    of the gradients (one flat buffer), the tp sum of the leaves whose gradient
    is partial over tp, and the global norm with each tp-sharded leaf
    counted once. Each does nothing at world 1."""

    def __init__(self, mm: MeshManager, cfg, *,
                 sequence_parallel: bool = False,
                 grad_allreduce_dtype: str = "fp32",
                 grad_allreduce_axis: str = "dp") -> None:
        self.mm, self.cfg = mm, cfg
        self.tp_axis = "tp" if mm.tp > 1 else None
        if sequence_parallel and self.tp_axis is None:
            raise ValueError("sequence_parallel requires tp > 1")
        self.sequence_parallel = sequence_parallel
        self.n_data = mm.dp * mm.cp
        self.data_group = mm.group(DATA_AXES) if self.n_data > 1 else None
        self.wire_axis = grad_allreduce_axis
        self.wire_bf16 = (grad_allreduce_dtype == "bf16"
                          and mm.axis_size(grad_allreduce_axis) > 1)

    def scope(self):
        # the mesh's axis names resolve to mm's groups in the forward and
        # in its recomputation inside the backward
        return using_mesh_manager(self.mm)

    def _data_mean_(self, flat: Tensor) -> Tensor:
        if not self.wire_bf16:
            all_reduce_(flat, self.data_group)
        else:
            other = "cp" if self.wire_axis == "dp" else "dp"
            all_reduce_(flat, self.mm.group(other))
            wire = flat.to(torch.bfloat16)
            all_reduce_(wire, self.mm.group(self.wire_axis))
            flat.copy_(wire)
        return flat.div_(self.n_data)

    def reduce(self, params, loss: Tensor, grads: List[Tensor]
               ) -> Tuple[Tensor, List[Tensor]]:
        if self.n_data > 1:
            flat = self._data_mean_(torch.cat([g.reshape(-1) for g in grads]))
            grads = [part.view_as(g) for part, g in zip(
                flat.split([g.numel() for g in grads]), grads)]
            loss = all_reduce_(loss.reshape(1).clone(),
                               self.data_group)[0] / self.n_data
        if self.tp_axis is not None:
            partial = per_leaf(params, llama_grad_partial_over_tp(
                self.cfg, self.sequence_parallel))
            idx = [i for i, p in enumerate(partial) if p]
            if idx:
                sums = all_reduce_(
                    torch.cat([grads[i].reshape(-1) for i in idx]),
                    self.mm.group("tp"))
                for i, part in zip(idx, sums.split(
                        [grads[i].numel() for i in idx])):
                    grads[i] = part.view_as(grads[i])
        return loss, grads

    def grad_norm(self, params, grads: List[Tensor]) -> Tensor:
        """sqrt of the whole model's sum of squares: tp-sharded leaves
        summed over tp, replicated ones once."""
        if self.tp_axis is None:
            return global_grad_norm(grads)
        sharded_flags = [d is not None for d in
                         per_leaf(params, llama_param_specs(self.cfg))]
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        sharded, replicated = zero.clone(), zero.clone()
        for g, is_sharded in zip(grads, sharded_flags):
            sq = torch.sum(torch.square(g.float()))
            if is_sharded:
                sharded = sharded + sq
            else:
                replicated = replicated + sq
        all_reduce_(sharded, self.mm.group("tp"))
        return torch.sqrt(sharded + replicated)

    def loss_sum(self, total: Tensor) -> Tuple[Tensor, int]:
        return all_reduce_(total.reshape(1), self.data_group)[0], self.n_data


def make_spmd_grad_fn(mm: MeshManager, cfg, *, attention_backend,
                      gradient_checkpointing: bool = False,
                      remat_policy: str = "nothing_saveable",
                      sequence_parallel: bool = False,
                      cp_layout: str = "contiguous",
                      grad_allreduce_dtype: str = "fp32",
                      grad_allreduce_axis: str = "dp") -> Callable:
    """grads(params, local_batch) -> (loss, fp32 gradients in
    ``tree_leaves`` order): the loss meaned over the data group and each
    gradient the whole model's (its shard's for a tp-sharded leaf),
    meaned over the data group and summed over tp where partial. The
    first half of the step; the parity checks read it."""
    _check(mm, cfg, gradient_checkpointing, remat_policy,
           grad_allreduce_dtype, grad_allreduce_axis)
    grads_fn = make_grad_fn(
        cfg, attention_backend=_resolve_backend(attention_backend, cp_layout),
        gradient_checkpointing=gradient_checkpointing,
        remat_policy=remat_policy,
        mesh=MeshReductions(mm, cfg, sequence_parallel=sequence_parallel,
                            grad_allreduce_dtype=grad_allreduce_dtype,
                            grad_allreduce_axis=grad_allreduce_axis))

    def grads_only(params, batch: Dict[str, Tensor]
                   ) -> Tuple[Tensor, List[Tensor]]:
        loss, _, grads = grads_fn(params, batch)
        return loss, grads

    return grads_only


def make_spmd_train_step(
    mm: MeshManager,
    cfg,
    optimizer: Optimizer,
    *,
    attention_backend="sdpa",
    gradient_checkpointing: bool = False,
    remat_policy: str = "nothing_saveable",
    sequence_parallel: bool = False,
    max_grad_norm: float = 0.0,
    cp_layout: str = "contiguous",
    grad_allreduce_dtype: str = "fp32",
    grad_allreduce_axis: str = "dp",
) -> Callable:
    """``step(params, opt_state, local_batch) -> (params, opt_state,
    metrics)`` on this rank's shards, updated in place. ``local_batch``
    holds this rank's part (``local_batch``) on the parameters' device.
    ``optimizer`` is one of the port's (``trainer/optimizer.py``); the
    step clips by the global norm itself. At world 1 this is
    ``make_train_step``'s step, bit for bit."""
    if mm.world_size > 1:
        _check(mm, cfg, gradient_checkpointing, remat_policy,
               grad_allreduce_dtype, grad_allreduce_axis)
    return make_train_step(
        cfg, optimizer,
        attention_backend=_resolve_backend(attention_backend, cp_layout),
        gradient_checkpointing=gradient_checkpointing,
        remat_policy=remat_policy, max_grad_norm=max_grad_norm,
        mesh=MeshReductions(mm, cfg, sequence_parallel=sequence_parallel,
                            grad_allreduce_dtype=grad_allreduce_dtype,
                            grad_allreduce_axis=grad_allreduce_axis))


def make_spmd_eval_step(mm: MeshManager, cfg, *, attention_backend="sdpa",
                        sequence_parallel: bool = False,
                        cp_layout: str = "contiguous") -> Callable:
    """``eval_step(params, local_batch) -> loss``: the train step's loss
    under ``torch.no_grad()``, averaged over the accumulation axis and
    the data group. At world 1 ``make_eval_step``'s."""
    return make_eval_step(
        cfg, attention_backend=_resolve_backend(attention_backend, cp_layout),
        mesh=MeshReductions(mm, cfg, sequence_parallel=sequence_parallel))
