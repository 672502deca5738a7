"""AdamW equal to ``optax.adamw`` (counterpart of
scaletorch_tpu/trainer/optimizer.py for ``optimizer_name="adamw"``).

The update is optax's chain: ``scale_by_adam`` (bias-corrected moments,
``eps`` outside the square root), ``add_decayed_weights`` (decoupled
decay on EVERY leaf, norms and embedding included), then the learning
rate of the schedule at the count before it advances. Moments take the
parameters' dtype: fp32 masters get fp32 moments.

The state is ``{"count": int64 CPU tensor, "mu": tree, "nu": tree}``
with trees of the parameter dict's shape. ``update`` and
``guarded_update`` write the new parameters and moments IN PLACE (the
counterpart of the reference's buffer donation) and return them. Adam,
SGD, LAMB and Adafactor are still to port (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

Tensor = torch.Tensor
Tree = Dict[str, Any]


def tree_leaves(tree: Tree) -> List[Tensor]:
    """Leaves of a nested dict in key order (depth first)."""
    out: List[Tensor] = []
    for key in tree:
        value = tree[key]
        out.extend(tree_leaves(value) if isinstance(value, dict) else [value])
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    return {k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


class AdamW:
    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4) -> None:
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Tree) -> Tree:
        return {
            "count": torch.zeros((), dtype=torch.int64),
            "mu": tree_map(lambda p: torch.zeros_like(p,
                                                      requires_grad=False),
                           params),
            "nu": tree_map(lambda p: torch.zeros_like(p,
                                                      requires_grad=False),
                           params),
        }

    @torch.no_grad()
    def _apply(self, params: Tree, state: Tree, grads: Tree,
               ok: Any) -> None:
        count = int(state["count"])
        lr = float(self.schedule(count))
        c = count + 1
        bc1 = 1 - self.b1 ** c
        bc2 = 1 - self.b2 ** c
        for p, mu, nu, g in zip(tree_leaves(params), tree_leaves(state["mu"]),
                                tree_leaves(state["nu"]), tree_leaves(grads)):
            mu_new = (1 - self.b1) * g + self.b1 * mu
            nu_new = (1 - self.b2) * (g * g) + self.b2 * nu
            u = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.eps)
            u = u + self.weight_decay * p
            p_new = (p + (-lr) * u).to(p.dtype)
            if ok is None:
                p.copy_(p_new)
                mu.copy_(mu_new)
                nu.copy_(nu_new)
            else:
                p.copy_(torch.where(ok, p_new, p))
                mu.copy_(torch.where(ok, mu_new, mu))
                nu.copy_(torch.where(ok, nu_new, nu))
        state["count"] += 1

    def update(self, grads: Tree, state: Tree,
               params: Tree) -> Tuple[Tree, Tree]:
        """One step, unconditionally: (params, state), updated in place."""
        self._apply(params, state, grads, None)
        return params, state


def guarded_update(optimizer: AdamW, params: Tree, opt_state: Tree,
                   grads: Tree, ok: Tensor) -> Tuple[Tree, Tree, Tensor]:
    """Apply the update only where ``ok`` (a 0-d bool tensor on the
    parameters' device) holds; otherwise the parameters and the float
    state keep their values, so NaN/Inf never reaches them. The step
    count advances either way: a skipped batch still consumes a step, so
    the schedule stays in step with the trainer. Returns ``(params,
    opt_state, update_skipped)``, ``update_skipped`` 1.0 on a rejected
    step. No host synchronisation."""
    optimizer._apply(params, opt_state, grads, ok)
    return params, opt_state, 1.0 - ok.float()


def create_optimizer(cfg, schedule: Callable[[int], float] = None
                     ) -> Tuple[AdamW, Callable[[int], float]]:
    """(optimizer, schedule) from the config's optimizer fields. The
    train step clips by the global norm itself, as the reference's SPMD
    step does, so no clip is chained here."""
    if schedule is None:
        from scaletorch_tpu_torch.trainer.lr_scheduler import (
            create_lr_scheduler,
        )

        schedule = create_lr_scheduler(cfg)
    name = cfg.optimizer_name.lower()
    if name != "adamw":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer_name!r} is not ported yet (ROADMAP "
            "Queue 1); the port has AdamW")
    return AdamW(schedule, b1=cfg.adam_beta1, b2=cfg.adam_beta2,
                 eps=cfg.adam_epsilon,
                 weight_decay=cfg.weight_decay), schedule
