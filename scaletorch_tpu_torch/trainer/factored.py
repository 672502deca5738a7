"""Adafactor as the reference's ``Trainer`` runs it (counterpart of
scaletorch_tpu/trainer/factored.py's ``adafactor_sharded`` at one device,
every spec replicated).

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
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from scaletorch_tpu_torch.trainer.optimizer import (
    Optimizer,
    Tree,
    commit,
    tree_leaves,
    tree_map,
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


class Adafactor(Optimizer):
    def __init__(self, schedule: Callable[[int], float],
                 weight_decay_rate: Optional[float] = None) -> None:
        super().__init__(schedule)
        self.weight_decay_rate = weight_decay_rate

    def init(self, params: Tree) -> Tree:
        def one(p, which):
            fd = factored_dims(tuple(p.shape))
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

        return {"count": torch.zeros((), dtype=torch.int64),
                **{w: tree_map(lambda p, w=w: one(p, w), params)
                   for w in ("v_row", "v_col", "v")}}

    @torch.no_grad()
    def _apply(self, params: Tree, state: Tree, grads: Tree,
               ok: Optional[Tensor]) -> None:
        count = int(state["count"])
        t = torch.tensor(count + 1, dtype=torch.float32)
        decay = 1.0 - t ** (-DECAY_RATE)  # fp32, as the reference's
        decay_t, keep = float(decay), float(1.0 - decay)
        lr = self.lr(count)
        for p, vr, vc, v, g in zip(
                tree_leaves(params), tree_leaves(state["v_row"]),
                tree_leaves(state["v_col"]), tree_leaves(state["v"]),
                tree_leaves(grads)):
            g32 = g.float()
            gsq = g32 * g32 + EPSILON
            fd = factored_dims(tuple(p.shape))
            if fd is not None:
                d1, d0 = fd
                new_vr = decay_t * vr.float() + keep * gsq.mean(d0, True)
                new_vc = decay_t * vc.float() + keep * gsq.mean(d1, True)
                row_factor = (new_vr / new_vr.mean(d1, True)) ** -0.5
                u = g32 * row_factor * new_vc ** -0.5
                commit(vr, new_vr.to(vr.dtype), ok)
                commit(vc, new_vc.to(vc.dtype), ok)
            else:
                new_v = decay_t * v.float() + keep * gsq
                u = g32 * new_v ** -0.5
                commit(v, new_v.to(v.dtype), ok)
            u_rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(u_rms / CLIPPING_THRESHOLD, min=1.0)
            p32 = p.float()
            p_rms = torch.sqrt(torch.mean(p32 * p32))
            scaled = lr * u * torch.clamp(p_rms, min=MIN_PARAMETER_SCALE)
            if self.weight_decay_rate is not None:
                scaled = scaled + self.weight_decay_rate * p32
            commit(p, p + (-scaled).to(p.dtype), ok)
        state["count"] += 1
