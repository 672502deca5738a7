"""Adafactor as the reference's ``Trainer`` runs it (counterpart of
scaletorch_tpu/trainer/factored.py's ``adafactor_sharded``), on one
device or over the local shards of a device mesh.

This is not ``optax.adafactor``'s chain: v_row and v_col keep the
reduced dims as size 1 (the keepdims layout), every state leaf is in the
parameter's dtype, and the weight decay is added after the learning rate
(``scaled + weight_decay_rate * p``, optax's semantics: at the default
``weight_decay`` 0.01 it takes 1% of each weight a step). Per leaf, in
fp32:

  * the two largest dims (both >= ``min_dim_size_to_factor``) are
    factored: row and column means of ``g^2 + 1e-30`` decayed by
    ``1 - t^-0.8``; other leaves keep the full second moment;
  * the update is clipped by its block RMS at 1.0, scaled by the
    learning rate and by the parameter's RMS (floored at 1e-3);
  * a stacked ``[L, ...]`` leaf is one block: its RMS and its factored
    means run over the whole leaf, as the reference's do.

The state is ``{"count", "v_row", "v_col", "v"}`` with a leaf of each
tree per parameter (size-1 placeholders where a leaf does not use it).

Over a mesh (``shard_dims`` and ``mesh`` given: ``tensor_parallel.
shard_dims``' split dim of each leaf per axis, and the ``MeshManager``)
each rank holds its shard of a leaf, and every statistic is the whole
leaf's, as the reference's ``_mean_over_dim`` / ``_global_mean_sq``
make it: the factored dims are chosen from the GLOBAL shape, and each
local mean that runs over a split dim (the row and column means, the
mean of ``v_row`` over its remaining dim, the update's and the
parameter's mean squares) is summed over that dim's axis group and
divided by its size. Shards are equal (a stacked leaf is padded for an
uneven pp split, and its padding counts as the reference's does), so
the mean of the local means is exact. With every axis of size 1 nothing
is exchanged and the update is the one-device one, bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from scaletorch_tpu_torch.parallel.mesh import all_reduce_
from scaletorch_tpu_torch.trainer.optimizer import (
    Optimizer,
    Tree,
    commit,
    tree_leaves,
)

Tensor = torch.Tensor


# the reference Trainer's settings (optax.adafactor's defaults)
DECAY_RATE = 0.8
MIN_DIM_SIZE_TO_FACTOR = 128
EPSILON = 1e-30
CLIPPING_THRESHOLD = 1.0
MIN_PARAMETER_SCALE = 1e-3


def factored_dims(shape: Tuple[int, ...],
                  min_dim: int = MIN_DIM_SIZE_TO_FACTOR
                  ) -> Optional[Tuple[int, int]]:
    """(d1, d0) = (second-largest, largest) dims, both >= ``min_dim``,
    else None (the reference's ``_factored_dims``, numpy's argsort)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class _Split:
    """One leaf's split over the mesh: the axes of size > 1 that cut each
    of its dims, and its global shape."""

    def __init__(self, shape: Tuple[int, ...], dims: Dict[str, int],
                 mesh) -> None:
        self.by_dim: Dict[int, List[str]] = {}
        if mesh is not None:
            for axis, dim in dims.items():
                if mesh.axis_size(axis) > 1:
                    self.by_dim.setdefault(dim, []).append(axis)
        self.mesh = mesh
        self.shape = tuple(
            s * math.prod(mesh.axis_size(a) for a in self.by_dim.get(i, ()))
            for i, s in enumerate(shape))

    def _mean(self, m: Tensor, axes: List[str]) -> Tensor:
        """A local mean ``m`` made the mean over ``axes``' groups too."""
        if not axes:
            return m
        m = m.contiguous()
        for axis in axes:
            all_reduce_(m, self.mesh.group(axis))
        return m / math.prod(self.mesh.axis_size(a) for a in axes)

    def mean_over(self, x: Tensor, dim: int) -> Tensor:
        """The GLOBAL mean over ``dim``, keepdims (``_mean_over_dim``)."""
        return self._mean(x.mean(dim, True), self.by_dim.get(dim, []))

    def mean_sq(self, x: Tensor) -> Tensor:
        """The GLOBAL mean of ``x * x`` over the leaf
        (``_global_mean_sq``)."""
        axes = [a for d in sorted(self.by_dim) for a in self.by_dim[d]]
        return self._mean(torch.mean(x * x), axes)


class Adafactor(Optimizer):
    """``shard_dims`` (flat leaf name -> {mesh axis: split dim}) and
    ``mesh`` (a ``MeshManager``): the layout of the local shards the
    optimizer updates (the module docstring); None: whole leaves."""

    def __init__(self, schedule: Callable[[int], float],
                 weight_decay_rate: Optional[float] = None, *,
                 shard_dims: Optional[Dict[str, Dict[str, int]]] = None,
                 mesh=None) -> None:
        super().__init__(schedule)
        self.weight_decay_rate = weight_decay_rate
        self.shard_dims = shard_dims or {}
        self.mesh = mesh

    def _leaf_splits(self, params: Tree) -> List[_Split]:
        """Each leaf's ``_Split``, in ``tree_leaves`` order."""
        from scaletorch_tpu_torch.models.convert import flatten_params

        return [_Split(tuple(p.shape), self.shard_dims.get(name, {}),
                       self.mesh)
                for name, p in flatten_params(params).items()]

    def init(self, params: Tree) -> Tree:
        def one(p, split, which):
            fd = factored_dims(split.shape)
            if fd is None:
                shape = tuple(p.shape) if which == "v" else (1,)
            elif which == "v":
                shape = (1,)
            else:
                d1, d0 = fd
                gone = d0 if which == "v_row" else d1
                shape = tuple(1 if i == gone else s
                              for i, s in enumerate(p.shape))
            return torch.zeros(shape, dtype=p.dtype, device=p.device)

        def build(tree, splits, which):
            return {k: (build(v, splits, which) if isinstance(v, dict)
                        else one(v, next(splits), which))
                    for k, v in tree.items()}

        splits = self._leaf_splits(params)
        return {"count": torch.zeros((), dtype=torch.int64),
                **{w: build(params, iter(splits), w)
                   for w in ("v_row", "v_col", "v")}}

    @torch.no_grad()
    def _apply(self, params: Tree, state: Tree, grads: Tree,
               ok: Optional[Tensor]) -> None:
        count = int(state["count"])
        t = torch.tensor(count + 1, dtype=torch.float32)
        decay = 1.0 - t ** (-DECAY_RATE)  # fp32, as the reference's
        decay_t, keep = float(decay), float(1.0 - decay)
        lr = self.lr(count)
        for p, vr, vc, v, g, split in zip(
                tree_leaves(params), tree_leaves(state["v_row"]),
                tree_leaves(state["v_col"]), tree_leaves(state["v"]),
                tree_leaves(grads), self._leaf_splits(params)):
            g32 = g.float()
            gsq = g32 * g32 + EPSILON
            fd = factored_dims(split.shape)
            if fd is not None:
                d1, d0 = fd
                new_vr = (decay_t * vr.float()
                          + keep * split.mean_over(gsq, d0))
                new_vc = (decay_t * vc.float()
                          + keep * split.mean_over(gsq, d1))
                row_factor = (new_vr / split.mean_over(new_vr, d1)) ** -0.5
                u = g32 * row_factor * new_vc ** -0.5
                commit(vr, new_vr.to(vr.dtype), ok)
                commit(vc, new_vc.to(vc.dtype), ok)
            else:
                new_v = decay_t * v.float() + keep * gsq
                u = g32 * new_v ** -0.5
                commit(v, new_v.to(v.dtype), ok)
            u_rms = torch.sqrt(split.mean_sq(u))
            u = u / torch.clamp(u_rms / CLIPPING_THRESHOLD, min=1.0)
            p32 = p.float()
            p_rms = torch.sqrt(split.mean_sq(p32))
            scaled = lr * u * torch.clamp(p_rms, min=MIN_PARAMETER_SCALE)
            if self.weight_decay_rate is not None:
                scaled = scaled + self.weight_decay_rate * p32
            commit(p, p + (-scaled).to(p.dtype), ok)
        state["count"] += 1
