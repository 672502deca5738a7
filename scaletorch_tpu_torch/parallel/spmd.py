"""The training step over the device mesh (counterpart of
scaletorch_tpu/parallel/spmd.make_spmd_train_step / make_spmd_eval_step).

Each rank runs the same program on its local shards, with the
reference's per-rank semantics of ``shard_map``:

  * **Batch.** The host batch is global, ``[accum, dp*ep*micro, seq]``
    (every rank draws the same one from the seeded loader); a rank keeps
    the rows of its (dp, ep) coordinate and the sequence slice of its cp
    coordinate (``local_batch``, the reference's ``batch_specs``), after
    the zigzag permutation for the zigzag ring; every pp stage gets the
    same rows. ``position_ids`` ride along, so RoPE and the loss are
    layout-transparent.
  * **Model.** The decoder runs its tensor-parallel path
    (``models/llama.py`` with ``tp_axis``; SP with ``sequence_parallel``)
    with the attention backend the trainer chose
    (``ring_zigzag``/``ring_contiguous``/``ulysses`` under cp, the flash
    kernels K1-K3 inside each); a Qwen3-MoE exchanges its slots over ep
    (``parallel/expert_parallel.py``; K5-K7 on the exchanged slabs); the
    loss is the vocab-parallel chunked CE, so full logits never exist.
  * **Pipeline.** With pp > 1 the accumulation axis is the microbatch axis
    of a pipeline pass (``parallel/pipeline_parallel.py``: ``afab``,
    ``memory_chunked`` or ``interleaved``); each stage holds its layers
    (after the uneven padding or the interleave order) and every leaf
    outside the layer stack whole.
  * **Accumulation.** Microbatches accumulate locally in fp32, then the
    gradients are reduced once per step, per leaf as the reference does:
    the mean over the data axes ``(dp, cp, ep)`` of every leaf but the
    expert shards, which take the mean over ``(dp, cp)`` and a 1/ep scale
    (their backward all-to-all already summed every ep rank's
    contribution); the sum over tp of a replicated leaf whose gradient is
    partial over tp (``tensor_parallel.llama_grad_partial_over_tp``); the
    sum over pp of a leaf outside the layer stack (only its stages
    produced a gradient: the embedding on the first, the norm and the
    head, or the tied embedding, on the last). With a ``bf16`` or
    ``int8`` ``grad_allreduce_dtype`` the mean over
    ``grad_allreduce_axis`` runs LAST, in that wire format, on gradients
    already meaned over the other data axes and summed over tp and pp
    (``ops/quantized_collectives.py``: one fused int8 pair per group of
    leaves sharded alike).
  * **Norm, clip, guard, update.** The global norm counts each leaf's
    square-sum once: summed over the tp, pp and ep axes the leaf is
    sharded over; loss and norm are reduced first, so every rank takes
    the same clip and the same nonfinite branch, and the port's
    optimizer updates the local shards in place.

The step body is ``trainer/train_step.make_train_step``'s; this module
supplies ``local_batch``, the pipeline pass and the reductions
(``MeshReductions``), which do nothing at world 1, so there the step is
the single-device one, bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from scaletorch_tpu_torch.ops.quantized_collectives import (
    GRAD_ALLREDUCE_DTYPES,
    quantized_pmean_tree,
)
from scaletorch_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    DATA_AXES,
    MeshManager,
    all_reduce_,
    using_mesh_manager,
)
from scaletorch_tpu_torch.parallel.tensor_parallel import (
    llama_grad_partial_over_tp,
    shard_dims,
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
MODEL_AXES = ("tp", "pp", "ep")


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


def resolve_pp_engine(pp_engine: str) -> str:
    """The schedule's name, ``1f1b`` read as ``memory_chunked`` (the
    reference's alias)."""
    from scaletorch_tpu_torch.parallel.pipeline_parallel import PP_ENGINES

    engine = "memory_chunked" if pp_engine == "1f1b" else pp_engine
    if engine not in PP_ENGINES:
        raise ValueError(
            "pp_engine must be 'afab', 'interleaved' or 'memory_chunked' "
            f"(alias '1f1b'), got {pp_engine!r}")
    return engine


def _check(mm: MeshManager, cfg, grad_allreduce_dtype: str,
           grad_allreduce_axis: str, pp_engine: str, pp_vpp: int) -> None:
    from scaletorch_tpu_torch.parallel.expert_parallel import (
        validate_ep_divisibility,
    )
    from scaletorch_tpu_torch.parallel.pipeline_parallel import (
        validate_interleaved_divisibility,
    )

    if grad_allreduce_dtype not in GRAD_ALLREDUCE_DTYPES:
        raise ValueError(
            f"grad_allreduce_dtype must be one of {GRAD_ALLREDUCE_DTYPES}, "
            f"got {grad_allreduce_dtype!r}")
    if grad_allreduce_axis not in DATA_AXES:
        raise ValueError(
            f"grad_allreduce_axis must be one of {DATA_AXES}, got "
            f"{grad_allreduce_axis!r}")
    if mm.ep > 1 and hasattr(cfg, "num_experts"):
        validate_ep_divisibility(cfg, mm.ep)
    if mm.pp > 1 and resolve_pp_engine(pp_engine) == "interleaved":
        validate_interleaved_divisibility(cfg.num_hidden_layers, mm.pp,
                                          pp_vpp)


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


def leaf_shard_axes(params, cfg, mm: MeshManager) -> List[Tuple[str, ...]]:
    """Per leaf (``tree_leaves`` order): the model axes of size > 1 it is
    split over, among tp, pp and ep (``tensor_parallel.shard_dims``)."""
    from scaletorch_tpu_torch.models.convert import flatten_params

    dims = shard_dims(cfg)
    names = list(flatten_params(params))
    return [tuple(a for a in MODEL_AXES
                  if a in dims[n] and mm.axis_size(a) > 1) for n in names]


class MeshReductions(MeshHooks):
    """The step's reductions over ``mm`` (the module docstring): the data
    mean of the loss, the statistics and the gradients (one flat buffer
    a class of leaves), the tp and pp sums, the wire-format mean over
    ``grad_allreduce_axis``, and the global norm with each shard counted
    once. Each does nothing at world 1."""

    def __init__(self, mm: MeshManager, cfg, *,
                 sequence_parallel: bool = False,
                 grad_allreduce_dtype: str = "fp32",
                 grad_allreduce_axis: str = "dp",
                 grad_allreduce_block_size: int = 256) -> None:
        self.mm, self.cfg = mm, cfg
        self.tp_axis = "tp" if mm.tp > 1 else None
        self.ep_axis = "ep" if mm.ep > 1 else None
        if sequence_parallel and self.tp_axis is None:
            raise ValueError("sequence_parallel requires tp > 1")
        self.sequence_parallel = sequence_parallel
        self.n_batch = mm.dp * mm.cp * mm.ep
        self.batch_group = (mm.group(BATCH_AXES) if self.n_batch > 1
                            else None)
        # quantizing an axis of one rank would pay two roundings to move
        # nothing: the fp32 path then
        self.wire = (grad_allreduce_dtype
                     if mm.axis_size(grad_allreduce_axis) > 1 else "fp32")
        self.wire_axis = grad_allreduce_axis
        self.block_size = grad_allreduce_block_size
        self._info = None

    def scope(self):
        # the mesh's axis names resolve to mm's groups in the forward and
        # in its recomputation inside the backward
        return using_mesh_manager(self.mm)

    def _leaves(self, params):
        """(shard axes, partial over tp) per leaf, computed once."""
        if self._info is None:
            axes = leaf_shard_axes(params, self.cfg, self.mm)
            partial = ([bool(p) for p in per_leaf(
                params, llama_grad_partial_over_tp(
                    self.cfg, self.sequence_parallel))]
                       if self.tp_axis else [False] * len(axes))
            self._info = (axes, partial)
        return self._info

    def _mean_(self, grads: List[Tensor], idx: List[int],
               axes: Tuple[str, ...]) -> None:
        """grads[i] for i in ``idx`` meaned over ``axes`` (one flat
        buffer; the fused group when there is one)."""
        axes = tuple(a for a in axes if self.mm.axis_size(a) > 1)
        if not idx or not axes:
            return
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        if axes in (DATA_AXES, BATCH_AXES):
            all_reduce_(flat, self.mm.group(axes))
        else:  # a single axis, or (dp|cp, ep) with one of dp, cp on the wire
            for a in axes:
                all_reduce_(flat, self.mm.group(a))
        flat.div_(math.prod(self.mm.axis_size(a) for a in axes))
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            grads[i] = part.view_as(grads[i])

    def _sum_(self, grads: List[Tensor], idx: List[int], axis: str) -> None:
        if not idx:
            return
        sums = all_reduce_(torch.cat([grads[i].reshape(-1) for i in idx]),
                           self.mm.group(axis))
        for i, part in zip(idx, sums.split([grads[i].numel() for i in idx])):
            grads[i] = part.view_as(grads[i])

    def reduce(self, params, loss: Tensor, grads: List[Tensor]
               ) -> Tuple[Tensor, List[Tensor]]:
        mm = self.mm
        if mm.world_size == 1:
            return loss, grads
        axes, partial = self._leaves(params)
        grads = list(grads)
        q = self.wire_axis if self.wire != "fp32" else None
        expert = [i for i, a in enumerate(axes) if "ep" in a]
        rest = [i for i, a in enumerate(axes) if "ep" not in a]
        self._mean_(grads, rest, tuple(a for a in BATCH_AXES if a != q))
        self._mean_(grads, expert, tuple(a for a in DATA_AXES if a != q))
        for i in expert:  # the step's own fp32 tensors: in place
            grads[i].div_(mm.ep)
        if self.tp_axis is not None:
            self._sum_(grads, [i for i, p in enumerate(partial) if p], "tp")
        if mm.pp > 1:
            self._sum_(grads, [i for i, a in enumerate(axes)
                               if "pp" not in a], "pp")
        if q is not None:
            by_sig: Dict[Tuple[str, ...], List[int]] = {}
            for i, a in enumerate(axes):
                by_sig.setdefault(tuple(sorted(a)), []).append(i)
            for idx in by_sig.values():
                red = quantized_pmean_tree(
                    [grads[i] for i in idx], mm.group(q), dtype=self.wire,
                    block_size=self.block_size)
                for i, g in zip(idx, red):
                    grads[i] = g
        if self.batch_group is not None:
            loss = all_reduce_(loss.reshape(1).clone(),
                               self.batch_group)[0] / self.n_batch
        return loss, grads

    def reduce_stats(self, stats: Dict[str, Tensor]) -> Dict[str, Tensor]:
        if not stats or self.batch_group is None:
            return stats
        keys = list(stats)
        vals = all_reduce_(torch.stack([stats[k].float() for k in keys]),
                           self.batch_group) / self.n_batch
        return dict(zip(keys, vals.unbind(0)))

    def grad_norm(self, params, grads: List[Tensor]) -> Tensor:
        """sqrt of the whole model's sum of squares: each leaf's square-sum
        summed over the model axes it is split over, once."""
        axes, _ = self._leaves(params) if self.mm.world_size > 1 else (
            None, None)
        if not axes or not any(axes):
            return global_grad_norm(grads)
        groups: Dict[Tuple[str, ...], Tensor] = {}
        for g, a in zip(grads, axes):
            # no temporary of the leaf's size (an expert leaf of a large
            # MoE is ~10 GB in fp32)
            sq = torch.linalg.vector_norm(g.float()).square()
            groups[a] = groups[a] + sq if a in groups else sq
        sigs = list(groups)
        sums = torch.stack([groups[s] for s in sigs])
        for axis in MODEL_AXES:
            rows = [i for i, s in enumerate(sigs) if axis in s]
            if rows:
                part = all_reduce_(sums[rows].clone(), self.mm.group(axis))
                sums = sums.index_copy(0, torch.tensor(
                    rows, device=sums.device), part)
        return torch.sqrt(sums.sum())

    def loss_sum(self, total: Tensor) -> Tuple[Tensor, int]:
        return all_reduce_(total.reshape(1), self.batch_group)[0], self.n_batch


def _pipeline_fns(mm: MeshManager, cfg, *, attention_backend,
                  gradient_checkpointing: bool, remat_policy: str,
                  sequence_parallel: bool, vpp: int):
    from scaletorch_tpu_torch.parallel import pipeline_parallel as ppl

    make = (ppl.make_moe_pipeline_fns if hasattr(cfg, "num_experts")
            else ppl.make_llama_pipeline_fns)
    return make(mm, cfg, attention_backend=attention_backend,
                gradient_checkpointing=gradient_checkpointing,
                remat_policy=remat_policy,
                sequence_parallel=sequence_parallel, vpp=vpp)


def _pipeline_grad_fn(mm: MeshManager, cfg, *, attention_backend,
                      gradient_checkpointing: bool, remat_policy: str,
                      sequence_parallel: bool, pp_engine: str,
                      pp_vpp: int) -> Optional[Callable]:
    """The pipeline pass of a pp > 1 step (None at pp 1)."""
    if mm.pp == 1:
        return None
    from scaletorch_tpu_torch.parallel.pipeline_parallel import (
        make_pipeline_grad_fn,
    )

    engine = resolve_pp_engine(pp_engine)
    vpp = pp_vpp if engine == "interleaved" else 1
    fns = _pipeline_fns(mm, cfg, attention_backend=attention_backend,
                        gradient_checkpointing=gradient_checkpointing,
                        remat_policy=remat_policy,
                        sequence_parallel=sequence_parallel, vpp=vpp)
    return make_pipeline_grad_fn(mm, fns, engine=engine, vpp=vpp)


def make_spmd_grad_fn(mm: MeshManager, cfg, *, attention_backend,
                      gradient_checkpointing: bool = False,
                      remat_policy: str = "nothing_saveable",
                      sequence_parallel: bool = False,
                      cp_layout: str = "contiguous",
                      pp_engine: str = "afab",
                      pp_vpp: int = 1,
                      grad_allreduce_dtype: str = "fp32",
                      grad_allreduce_axis: str = "dp",
                      grad_allreduce_block_size: int = 256) -> Callable:
    """grads(params, local_batch) -> (loss, fp32 gradients in
    ``tree_leaves`` order): the loss meaned over the data ranks and each
    gradient the whole model's (its shard's for a split leaf), reduced
    as the step reduces it. The first half of the step; the parity checks
    read it (and ``make_spmd_grad_fn(...).stats`` after a call, the
    routing statistics)."""
    _check(mm, cfg, grad_allreduce_dtype, grad_allreduce_axis, pp_engine,
           pp_vpp)
    backend = _resolve_backend(attention_backend, cp_layout)
    grads_fn = make_grad_fn(
        cfg, attention_backend=backend,
        gradient_checkpointing=gradient_checkpointing,
        remat_policy=remat_policy,
        mesh=MeshReductions(mm, cfg, sequence_parallel=sequence_parallel,
                            grad_allreduce_dtype=grad_allreduce_dtype,
                            grad_allreduce_axis=grad_allreduce_axis,
                            grad_allreduce_block_size=(
                                grad_allreduce_block_size)),
        pipeline=_pipeline_grad_fn(
            mm, cfg, attention_backend=backend,
            gradient_checkpointing=gradient_checkpointing,
            remat_policy=remat_policy, sequence_parallel=sequence_parallel,
            pp_engine=pp_engine, pp_vpp=pp_vpp))

    def grads_only(params, batch: Dict[str, Tensor]
                   ) -> Tuple[Tensor, List[Tensor]]:
        loss, stats, grads = grads_fn(params, batch)
        grads_only.stats = stats
        return loss, grads

    grads_only.stats = {}
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
    pp_engine: str = "afab",
    pp_vpp: int = 1,
    grad_allreduce_dtype: str = "fp32",
    grad_allreduce_axis: str = "dp",
    grad_allreduce_block_size: int = 256,
) -> Callable:
    """``step(params, opt_state, local_batch) -> (params, opt_state,
    metrics)`` on this rank's shards, updated in place. ``local_batch``
    holds this rank's part (``local_batch``) on the parameters' device;
    under pp its accumulation axis is the microbatch axis of
    ``pp_engine``'s pass (``pp_vpp`` virtual stages for
    ``interleaved``, whose layer shards arrive in interleaved order).
    ``optimizer`` is one of the port's (``trainer/optimizer.py``); the
    step clips by the global norm itself. At world 1 this is
    ``make_train_step``'s step, bit for bit."""
    if mm.world_size > 1:
        _check(mm, cfg, grad_allreduce_dtype, grad_allreduce_axis,
               pp_engine, pp_vpp)
    backend = _resolve_backend(attention_backend, cp_layout)
    return make_train_step(
        cfg, optimizer, attention_backend=backend,
        gradient_checkpointing=gradient_checkpointing,
        remat_policy=remat_policy, max_grad_norm=max_grad_norm,
        mesh=MeshReductions(mm, cfg, sequence_parallel=sequence_parallel,
                            grad_allreduce_dtype=grad_allreduce_dtype,
                            grad_allreduce_axis=grad_allreduce_axis,
                            grad_allreduce_block_size=(
                                grad_allreduce_block_size)),
        pipeline=_pipeline_grad_fn(
            mm, cfg, attention_backend=backend,
            gradient_checkpointing=gradient_checkpointing,
            remat_policy=remat_policy, sequence_parallel=sequence_parallel,
            pp_engine=pp_engine, pp_vpp=pp_vpp))


def make_spmd_eval_step(mm: MeshManager, cfg, *, attention_backend="sdpa",
                        sequence_parallel: bool = False,
                        cp_layout: str = "contiguous",
                        pp_engine: str = "afab",
                        pp_vpp: int = 1) -> Callable:
    """``eval_step(params, local_batch) -> loss``: the train step's loss
    under ``torch.no_grad()``, averaged over the accumulation axis and
    the data ranks; under pp one pipeline pass (``interleaved`` when the
    train step is, since the layer shards are in its order; afab
    otherwise: ``memory_chunked`` only bounds the train step's memory).
    At world 1 ``make_eval_step``'s."""
    backend = _resolve_backend(attention_backend, cp_layout)
    pipeline = None
    if mm.pp > 1:
        from scaletorch_tpu_torch.parallel.pipeline_parallel import (
            make_pipeline_eval_fn,
        )

        vpp = (pp_vpp if resolve_pp_engine(pp_engine) == "interleaved"
               else 1)
        pipeline = make_pipeline_eval_fn(mm, _pipeline_fns(
            mm, cfg, attention_backend=backend, gradient_checkpointing=False,
            remat_policy="nothing_saveable",
            sequence_parallel=sequence_parallel, vpp=vpp), vpp=vpp)
    return make_eval_step(
        cfg, attention_backend=backend,
        mesh=MeshReductions(mm, cfg, sequence_parallel=sequence_parallel),
        pipeline=pipeline)


def audit_entry(grad_allreduce_dtype: str = "int8", donate: bool = True
                ) -> Dict[str, object]:
    """Audit entry (``analysis/entry_audit.py``): the spmd train step on
    the (dp2, cp2, tp2) mesh with the int8 gradient all-reduce on the dp
    edge, seq 128, 2 x 2 microbatch rows (the reference's), attention
    over cp by the contiguous ring (K1-K3 on its blocks). See
    ``trainer/train_step.audit_train_contract`` for the pinned contract;
    ``grad_allreduce_dtype`` / ``donate`` inject its regressions."""
    from scaletorch_tpu_torch.trainer.train_step import audit_train_contract

    def make_step(mm, cfg, optimizer):
        return make_spmd_train_step(
            mm, cfg, optimizer, attention_backend="ring", max_grad_norm=1.0,
            grad_allreduce_dtype=grad_allreduce_dtype,
            grad_allreduce_axis="dp")

    # the in-place floor is the rank's tp half of it
    return audit_train_contract(
        "spmd_train_step", "scaletorch_tpu_torch/parallel/spmd.py",
        {"dp": 2, "cp": 2, "tp": 2}, (2, 2, 128), make_step, donate=donate)
