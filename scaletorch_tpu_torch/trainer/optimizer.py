"""The optimizers of the reference's ``create_optimizer`` (counterpart of
scaletorch_tpu/trainer/optimizer.py): AdamW, Adam, SGD and LAMB equal to
their optax chains, and Adafactor as the reference's ``Trainer`` runs it
(``trainer/factored.py``).

* ``adamw``: ``scale_by_adam`` (bias-corrected moments, ``eps`` outside
  the square root), ``add_decayed_weights`` (decoupled decay on EVERY
  leaf, norms and embedding included), the learning rate;
* ``adam``: the same without the decay;
* ``sgd``: ``trace(momentum)`` (not Nesterov), the learning rate;
* ``lamb``: ``scale_by_adam(eps_root=0)``, the decay on every leaf, then
  ``scale_by_trust_ratio`` (``||p|| / ||u||`` over each whole leaf, 1
  where either norm is 0), the learning rate;
* ``Adadelta`` (the MNIST example's, outside the factory):
  ``scale_by_adadelta``, the learning rate.

The learning rate is the schedule's at the count before it advances.
State leaves take the parameters' dtype, as optax's do: fp32 masters get
fp32 moments, bf16 masters bf16 ones. Every python constant that optax
applies to a leaf (the betas, ``eps``, the decay, the bias corrections
and the learning rate) is rounded to the leaf's dtype first, as JAX
rounds a weakly typed scalar; torch then rounds after every op.

The state is a dict of trees of the parameter dict's shape plus
``count`` (an int64 CPU tensor). ``_apply(params, state, grads, ok)``
writes the new parameters and state IN PLACE (the counterpart of the
reference's buffer donation): with ``ok`` (a 0-d bool tensor on the
parameters' device) false, the parameters and the float state keep
their values, and ``count`` advances either way (the reference's
``guarded_update``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

Tensor = torch.Tensor
Tree = Dict[str, Any]

OPTIMIZERS = ("adamw", "adam", "sgd", "lamb", "adafactor")


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


def zeros_like_tree(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros_like(p, requires_grad=False),
                    params)


def as_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a python float."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def commit(dst: Tensor, new: Tensor, ok: Optional[Tensor]) -> None:
    """``dst`` <- ``new``, or kept where ``ok`` is false."""
    dst.copy_(new if ok is None else torch.where(ok, new, dst))


class Optimizer:
    """``init(params) -> state`` and the in-place ``_apply``."""

    def __init__(self, schedule: Callable[[int], float]) -> None:
        self.schedule = schedule

    def lr(self, count: int) -> float:
        """The schedule's rate at ``count``, rounded to fp32 as the
        reference's schedule computes it."""
        return float(torch.tensor(self.schedule(count), dtype=torch.float32))

    def init(self, params: Tree) -> Tree:
        raise NotImplementedError

    def _apply(self, params: Tree, state: Tree, grads: Tree,
               ok: Optional[Tensor]) -> None:
        raise NotImplementedError

    def update(self, grads: Tree, state: Tree,
               params: Tree) -> Tuple[Tree, Tree]:
        """One step, unconditionally: (params, state), updated in place."""
        self._apply(params, state, grads, None)
        return params, state


class Adam(Optimizer):
    """``optax.adam``, or ``optax.adamw`` with ``weight_decay`` set."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: Optional[float] = None) -> None:
        super().__init__(schedule)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Tree) -> Tree:
        return {"count": torch.zeros((), dtype=torch.int64),
                "mu": zeros_like_tree(params), "nu": zeros_like_tree(params)}

    def _direction(self, p: Tensor, u: Tensor) -> Tensor:
        """What follows ``scale_by_adam`` and the decay in the chain."""
        return u

    @torch.no_grad()
    def _apply(self, params: Tree, state: Tree, grads: Tree,
               ok: Optional[Tensor]) -> None:
        count = int(state["count"])
        lr = -self.lr(count)
        c = count + 1
        bc1, bc2 = (float(1 - torch.tensor(b, dtype=torch.float32) ** c)
                    for b in (self.b1, self.b2))
        for p, mu, nu, g in zip(tree_leaves(params), tree_leaves(state["mu"]),
                                tree_leaves(state["nu"]), tree_leaves(grads)):
            d = p.dtype
            mu_new = as_dtype(1 - self.b1, d) * g + as_dtype(self.b1, d) * mu
            nu_new = (as_dtype(1 - self.b2, d) * (g * g)
                      + as_dtype(self.b2, d) * nu)
            u = (mu_new / as_dtype(bc1, d)) / (
                torch.sqrt(nu_new / as_dtype(bc2, d)) + as_dtype(self.eps, d))
            if self.weight_decay is not None:
                u = u + as_dtype(self.weight_decay, d) * p
            u = as_dtype(lr, d) * self._direction(p, u)
            commit(p, (p + u).to(d), ok)
            commit(mu, mu_new, ok)
            commit(nu, nu_new, ok)
        state["count"] += 1


class AdamW(Adam):
    """``optax.adamw``: Adam with decoupled decay on every leaf."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4) -> None:
        super().__init__(schedule, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay)


class Lamb(Adam):
    """``optax.lamb``: AdamW's direction scaled per leaf by the trust
    ratio ``||p|| / ||u||`` (1 where either norm is 0)."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0) -> None:
        super().__init__(schedule, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay)

    def _direction(self, p: Tensor, u: Tensor) -> Tensor:
        # jnp.linalg.norm over the whole leaf: products in the leaf's
        # dtype, the sum accumulated in fp32 and rounded back
        p_norm = torch.sqrt(torch.sum(p * p))
        u_norm = torch.sqrt(torch.sum(u * u))
        ratio = torch.where((p_norm == 0) | (u_norm == 0),
                            torch.ones_like(p_norm), p_norm / u_norm)
        return u * ratio


class SGD(Optimizer):
    """``optax.sgd(momentum=m)``: ``trace = g + m * trace`` (not
    Nesterov) in the parameters' dtype, then the learning rate."""

    def __init__(self, schedule: Callable[[int], float],
                 momentum: float = 0.9) -> None:
        super().__init__(schedule)
        self.momentum = momentum

    def init(self, params: Tree) -> Tree:
        return {"count": torch.zeros((), dtype=torch.int64),
                "trace": zeros_like_tree(params)}

    @torch.no_grad()
    def _apply(self, params: Tree, state: Tree, grads: Tree,
               ok: Optional[Tensor]) -> None:
        lr = -self.lr(int(state["count"]))
        for p, t, g in zip(tree_leaves(params), tree_leaves(state["trace"]),
                           tree_leaves(grads)):
            d = p.dtype
            t_new = g + as_dtype(self.momentum, d) * t
            commit(p, (p + as_dtype(lr, d) * t_new).to(d), ok)
            commit(t, t_new, ok)
        state["count"] += 1


class Adadelta(Optimizer):
    """``optax.adadelta`` (the MNIST example's optimizer): ``e_g = rho·e_g
    + (1 - rho)·g²``, ``u = sqrt(e_x + eps) / sqrt(e_g + eps) · g`` with
    the previous ``e_x``, ``e_x = rho·e_x + (1 - rho)·u²``, then the
    learning rate."""

    def __init__(self, schedule: Callable[[int], float], rho: float = 0.9,
                 eps: float = 1e-6) -> None:
        super().__init__(schedule)
        self.rho, self.eps = rho, eps

    def init(self, params: Tree) -> Tree:
        return {"count": torch.zeros((), dtype=torch.int64),
                "e_g": zeros_like_tree(params), "e_x": zeros_like_tree(params)}

    @torch.no_grad()
    def _apply(self, params: Tree, state: Tree, grads: Tree,
               ok: Optional[Tensor]) -> None:
        lr = -self.lr(int(state["count"]))
        for p, e_g, e_x, g in zip(tree_leaves(params), tree_leaves(state["e_g"]),
                                  tree_leaves(state["e_x"]),
                                  tree_leaves(grads)):
            d = p.dtype
            rho, rest, eps = (as_dtype(v, d) for v in
                              (self.rho, 1 - self.rho, self.eps))
            e_g_new = rho * e_g + rest * (g * g)
            u = torch.sqrt(e_x + eps) / torch.sqrt(e_g_new + eps) * g
            e_x_new = rho * e_x + rest * (u * u)
            commit(p, (p + as_dtype(lr, d) * u).to(d), ok)
            commit(e_g, e_g_new, ok)
            commit(e_x, e_x_new, ok)
        state["count"] += 1


def guarded_update(optimizer: Optimizer, params: Tree, opt_state: Tree,
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


def create_optimizer(cfg, schedule: Callable[[int], float] = None, *,
                     shard_dims: Optional[Dict[str, Dict[str, int]]] = None,
                     mesh=None) -> Tuple[Optimizer, Callable[[int], float]]:
    """(optimizer, schedule) from the config's optimizer fields, as the
    reference's ``Trainer`` builds them: the train step clips by the
    global norm itself, so no clip is chained here, and ``adafactor`` is
    the reference's sharded Adafactor (decay ``weight_decay or None``)
    over the local shards that ``shard_dims`` (``tensor_parallel.
    shard_dims``) and ``mesh`` (the ``MeshManager``) describe, whole
    leaves without them; the other optimizers work leaf by leaf and need
    no layout. An unknown name raises."""
    if schedule is None:
        from scaletorch_tpu_torch.trainer.lr_scheduler import (
            create_lr_scheduler,
        )

        schedule = create_lr_scheduler(cfg)
    name = cfg.optimizer_name.lower()
    if name == "adamw":
        opt: Optimizer = AdamW(schedule, b1=cfg.adam_beta1, b2=cfg.adam_beta2,
                               eps=cfg.adam_epsilon,
                               weight_decay=cfg.weight_decay)
    elif name == "adam":
        opt = Adam(schedule, b1=cfg.adam_beta1, b2=cfg.adam_beta2,
                   eps=cfg.adam_epsilon)
    elif name == "sgd":
        opt = SGD(schedule, momentum=cfg.momentum)
    elif name == "lamb":
        opt = Lamb(schedule, b1=cfg.adam_beta1, b2=cfg.adam_beta2,
                   eps=cfg.adam_epsilon, weight_decay=cfg.weight_decay)
    elif name == "adafactor":
        from scaletorch_tpu_torch.trainer.factored import Adafactor

        opt = Adafactor(schedule, weight_decay_rate=cfg.weight_decay or None,
                        shard_dims=shard_dims, mesh=mesh)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer_name!r}; have "
                         f"{OPTIMIZERS}")
    return opt, schedule
