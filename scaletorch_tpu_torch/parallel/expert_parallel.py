"""Top-k routing and capacity dispatch of the MoE layer, single device.

PyTorch counterpart of the ``axis=None`` parts of
scaletorch_tpu/parallel/expert_parallel.py. Each expert accepts at most C
(token, choice) rows per group; routing decides, for every (token,
choice), its expert and its slot in that expert's queue, and the movement
forms carry rows into an ``[E, G, C, H]`` slot buffer and back:

    route     [G, N, E] logits -> expert_idx, slot, weight [G, N, k] (index)
                                  or dispatch / combine [G, N, E, C] (einsum)
    dispatch  [G, N, H] -> [E, G·C, H]  (a scatter, or the one-hot einsum)
    compute   the per-expert SwiGLU (``moe_mlp``: batched products, or the
              grouped-MLP kernels K5-K7 with per-(expert, group) fill counts)
    combine   [E, G·C, H] -> [G, N, H]  weighted top-k sum

The routing math lives in one place (``_route_core``), so both forms make
the same decisions, drop the same rows and report the same aux losses.
Ties in the top-k go to the lower expert index, as ``jax.lax.top_k``
breaks them (a stable descending sort; ``torch.topk`` promises no order).

Only the single-device forms are ported: an expert-parallel ``axis``
raises ``NotImplementedError`` (ROADMAP Queue 1 item 6b, the EP exchange).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Tensor = torch.Tensor


def _single_device(axis: Optional[str]) -> None:
    if axis is not None:
        raise NotImplementedError(
            f"expert-parallel axis {axis!r}: the port runs MoE on one device "
            "only; the EP exchange is ROADMAP Queue 1 item 6b")


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """C = ceil(capacity_factor * N * k / E), at least 1, at most N."""
    c = int(-(-capacity_factor * num_tokens * top_k // num_experts))
    return max(1, min(c, num_tokens))


def _grouped(t: Tensor, ndim: int) -> Tensor:
    """Add the leading group axis to an ungrouped tensor."""
    return t[None] if t.ndim == ndim else t


def _route_core(router_logits: Tensor, top_k: int, capacity: int,
                normalize_weights: bool, with_aux: bool = True):
    """Routing math shared by both forms, per group: logits [G, N, E] ->
    (gate_idx [G, N, k] int64, gate_w [G, N, k] fp32, pos [G, N, k] int64,
    kept [G, N, k] bool, aux {name: [G] or [G, E]}). Without
    ``with_aux`` (serving) the aux losses and statistics, which only
    training reads, are not computed and ``aux`` is None; the decisions
    are the same."""
    g, n, e = router_logits.shape
    logits32 = router_logits.float()
    probs = torch.softmax(logits32, dim=-1)
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_idx = gate_w[..., :top_k], gate_idx[..., :top_k]
    if normalize_weights:
        gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)
    # the queue position of each (token, choice) in its expert: tokens in
    # index order, choice-major (every first choice before any second).
    # The reference takes a cumsum of one-hots over the k·N rows; here a
    # stable sort by expert gives the same ranks without the [k·N, E]
    # scan: a row's position is its rank among the rows of its expert.
    flat = gate_idx.transpose(1, 2).reshape(g, top_k * n)
    order = torch.sort(flat, dim=-1, stable=True).indices
    load = torch.zeros(g, e, dtype=torch.long, device=flat.device)
    load.scatter_add_(1, flat, torch.ones_like(flat))
    starts = torch.cumsum(load, dim=-1) - load
    rank = (torch.arange(top_k * n, device=flat.device)
            - starts.gather(1, flat.gather(1, order)))
    pos = torch.empty_like(flat).scatter_(1, order, rank)
    pos = pos.view(g, top_k, n).transpose(1, 2)
    kept = pos < capacity
    if not with_aux:
        return gate_idx, gate_w, pos, kept, None
    # Switch aux loss E * sum_e f_e P_e / k over the pre-capacity choices
    f = load.float() / n  # [G, E]: choices per token, sums to k
    p = probs.mean(dim=1)
    aux = {
        "aux_loss": e * (f * p).sum(dim=-1) / top_k,
        "z_loss": torch.logsumexp(logits32, dim=-1).square().mean(dim=-1),
        "expert_load": f,
        "dropped_fraction": 1.0 - kept.sum(dim=(1, 2)) / (n * top_k),
    }
    return gate_idx, gate_w, pos, kept, aux


def top_k_routing(router_logits: Tensor, top_k: int, capacity: int, *,
                  normalize_weights: bool = True, with_aux: bool = True):
    """One-hot form: router_logits [N, E] (or [G, N, E]) -> (dispatch
    [(G,) N, E, C] in {0, 1}, combine [(G,) N, E, C] = dispatch x gate
    weight, aux). Dropped choices occupy no slot. ``with_aux`` as in
    ``_route_core``."""
    grouped = router_logits.ndim == 3
    logits = _grouped(router_logits, 2)
    gate_idx, gate_w, pos, kept, aux = _route_core(
        logits, top_k, capacity, normalize_weights, with_aux)
    g, n, e = logits.shape
    dispatch = torch.zeros(g, n, e, capacity, device=logits.device)
    combine = torch.zeros_like(dispatch)
    gi, ni, ki = kept.nonzero(as_tuple=True)
    at = (gi, ni, gate_idx[gi, ni, ki], pos[gi, ni, ki])
    # the (expert, slot) of each kept choice is unique, so set == sum
    dispatch[at] = 1.0
    combine[at] = gate_w[gi, ni, ki]
    if not grouped:
        dispatch, combine = dispatch[0], combine[0]
        if aux is not None:
            aux = {k: v[0] for k, v in aux.items()}
    return dispatch, combine, aux


def top_k_routing_indexed(router_logits: Tensor, top_k: int, capacity: int,
                          *, normalize_weights: bool = True,
                          with_aux: bool = True):
    """Index form: the same decisions without the one-hots. Returns
    (routing, aux), routing = {expert_idx [.., k] int32, slot [.., k] int32
    (>= capacity: dropped), weight [.., k] fp32 (0 for drops)}.
    ``with_aux`` as in ``_route_core``."""
    grouped = router_logits.ndim == 3
    gate_idx, gate_w, pos, kept, aux = _route_core(
        _grouped(router_logits, 2), top_k, capacity, normalize_weights,
        with_aux)
    routing = {
        "expert_idx": gate_idx.to(torch.int32),
        "slot": pos.to(torch.int32),
        "weight": torch.where(kept, gate_w, torch.zeros_like(gate_w)),
    }
    if not grouped:
        routing = {k: v[0] for k, v in routing.items()}
        if aux is not None:
            aux = {k: v[0] for k, v in aux.items()}
    return routing, aux


def dispatch_tokens(x: Tensor, dispatch: Tensor, *,
                    axis: Optional[str] = None) -> Tensor:
    """One-hot dispatch: x [(G,) N, H], dispatch [(G,) N, E, C] ->
    [E, G·C, H]."""
    _single_device(axis)
    x, dispatch = _grouped(x, 2), _grouped(dispatch, 3)
    slots = torch.einsum("gnh,gnec->egch", x, dispatch.to(x.dtype))
    e, g, c, h = slots.shape
    return slots.reshape(e, g * c, h)


def gather_tokens(expert_out: Tensor, combine: Tensor, *,
                  axis: Optional[str] = None) -> Tensor:
    """One-hot combine: expert_out [E, G·C, H], combine [(G,) N, E, C] ->
    [(G,) N, H], the weighted sum over each token's kept slots."""
    _single_device(axis)
    grouped = combine.ndim == 4
    combine = _grouped(combine, 3)
    g, n, e, c = combine.shape
    slots = expert_out.reshape(e, g, c, expert_out.shape[-1])
    y = torch.einsum("egch,gnec->gnh", slots, combine.to(expert_out.dtype))
    return y if grouped else y[0]


def _index_grid(routing: Dict[str, Tensor]):
    g, n, k = routing["expert_idx"].shape
    dev = routing["expert_idx"].device
    gi = torch.arange(g, device=dev)[:, None, None].expand(g, n, k)
    ni = torch.arange(n, device=dev)[None, :, None].expand(g, n, k)
    return gi, ni


def dispatch_tokens_indexed(x: Tensor, routing: Dict[str, Tensor], *,
                            num_experts: int, capacity: int,
                            axis: Optional[str] = None) -> Tensor:
    """Index dispatch: scatter each kept (token, choice) row of x [(G,) N,
    H] into its slot of a zeroed [E, G, C, H] buffer -> [E, G·C, H].

    A dropped row (slot >= C) goes to a trash expert E past the end of
    the buffer that is cut away, which is ``mode="drop"``'s semantics
    without a data-dependent shape (no host synchronisation)."""
    _single_device(axis)
    x = _grouped(x, 2)
    routing = {k: _grouped(v, 2) for k, v in routing.items()}
    g, n, h = x.shape
    gi, ni = _index_grid(routing)
    slot = routing["slot"].long()
    drop = slot >= capacity
    expert = torch.where(drop, num_experts, routing["expert_idx"].long())
    slot = torch.where(drop, 0, slot)
    slots = x.new_zeros(num_experts + 1, g, capacity, h)
    slots.index_put_((expert, gi, slot), x[gi, ni])
    return slots[:num_experts].reshape(num_experts, g * capacity, h)


def gather_tokens_indexed(expert_out: Tensor, routing: Dict[str, Tensor], *,
                          num_experts: int, capacity: int,
                          axis: Optional[str] = None) -> Tensor:
    """Index combine: gather each (token, choice) slot of expert_out [E,
    G·C, H] and take the weighted top-k sum -> [(G,) N, H]; a dropped
    choice carries weight 0."""
    _single_device(axis)
    grouped = routing["expert_idx"].ndim == 3
    routing = {k: _grouped(v, 2) for k, v in routing.items()}
    g = routing["expert_idx"].shape[0]
    slots = expert_out.reshape(num_experts, g, capacity, expert_out.shape[-1])
    gi, _ = _index_grid(routing)
    safe_slot = routing["slot"].long().clamp(max=capacity - 1)
    vals = slots[routing["expert_idx"].long(), gi, safe_slot]  # [G, N, k, H]
    w = routing["weight"].to(expert_out.dtype)[..., None]
    y = torch.sum(w * vals, dim=2)
    return y if grouped else y[0]


# ---- one API over both movement forms -------------------------------------------
_MODES = ("einsum", "index")


def _check_mode(mode: str, allow_auto: bool = False) -> None:
    ok = ("auto",) + _MODES if allow_auto else _MODES
    if mode not in ok:
        raise ValueError(f"moe dispatch mode must be one of {ok}, got {mode!r}")


def resolve_moe_dispatch(mode: str, num_experts: int) -> str:
    """``auto`` -> ``index`` at every expert count (the reference's rule:
    the one-hot form's cost does not depend on E and is always larger);
    ``einsum`` stays selectable for parity and A/B runs."""
    _check_mode(mode, allow_auto=True)
    return "index" if mode == "auto" else mode


def route_tokens(router_logits: Tensor, top_k: int, capacity: int, *,
                 mode: str, normalize_weights: bool = True,
                 with_aux: bool = True):
    """(state, aux) for ``mode`` in {einsum, index}: the same decisions,
    drops and aux losses in both forms (``aux`` None without
    ``with_aux``)."""
    _check_mode(mode)
    if mode == "index":
        return top_k_routing_indexed(router_logits, top_k, capacity,
                                     normalize_weights=normalize_weights,
                                     with_aux=with_aux)
    dispatch, combine, aux = top_k_routing(
        router_logits, top_k, capacity, normalize_weights=normalize_weights,
        with_aux=with_aux)
    return {"dispatch": dispatch, "combine": combine}, aux


def dispatch_routed(x: Tensor, state: Dict[str, Tensor], *, mode: str,
                    num_experts: int, capacity: int,
                    axis: Optional[str] = None) -> Tensor:
    """Move tokens to their experts: [E, G·C, H] in both modes."""
    _check_mode(mode)
    if mode == "index":
        return dispatch_tokens_indexed(x, state, num_experts=num_experts,
                                       capacity=capacity, axis=axis)
    return dispatch_tokens(x, state["dispatch"], axis=axis)


def combine_routed(expert_out: Tensor, state: Dict[str, Tensor], *,
                   mode: str, num_experts: int, capacity: int,
                   axis: Optional[str] = None) -> Tensor:
    """Bring expert outputs home and take the weighted top-k sum."""
    _check_mode(mode)
    if mode == "index":
        return gather_tokens_indexed(expert_out, state,
                                     num_experts=num_experts,
                                     capacity=capacity, axis=axis)
    return gather_tokens(expert_out, state["combine"], axis=axis)


def routed_fill_counts(state: Dict[str, Tensor], *, mode: str,
                       num_experts: int, capacity: int) -> Tensor:
    """[E, G] int32 per-(expert, group) fill counts from either form."""
    _check_mode(mode)
    if mode == "index":
        return slot_fill_counts_indexed(state, num_experts, capacity)
    from scaletorch_tpu_torch.ops.grouped_mlp import slot_fill_counts

    return slot_fill_counts(state["dispatch"])


def slot_fill_counts_indexed(routing: Dict[str, Tensor], num_experts: int,
                             capacity: int) -> Tensor:
    """[E, G] int32 fill counts from index-form routing: the kept rows of
    each (expert, group), which fill its slots as a prefix."""
    ei = _grouped(routing["expert_idx"], 2).long()
    kept = _grouped(routing["slot"], 2) < capacity
    g = ei.shape[0]
    counts = torch.zeros(g, num_experts, dtype=torch.int32, device=ei.device)
    counts.scatter_add_(1, ei.reshape(g, -1),
                        kept.reshape(g, -1).to(torch.int32))
    return counts.T.contiguous()


def validate_ep_divisibility(cfg, ep: int) -> None:
    """Experts shard evenly over the ep axis."""
    if cfg.num_experts % ep != 0:
        raise ValueError(
            f"num_experts={cfg.num_experts} not divisible by ep={ep}")


def moe_mlp(x_grouped: Tensor, gate_w: Tensor, up_w: Tensor, down_w: Tensor,
            *, tp_axis: Optional[str] = None, compute_dtype=None,
            slot_counts: Optional[Tensor] = None,
            capacity: Optional[int] = None) -> Tensor:
    """Per-expert SwiGLU over x_grouped [E, T, H] with gate/up [E, H, I]
    and down [E, I, H], in ``compute_dtype``.

    With ``slot_counts`` [E, T / capacity] and ``capacity`` it runs the
    grouped-MLP op (``ops.grouped_mlp.grouped_swiglu_mlp``: the CUDA
    kernels K5-K7 on the card, their plain versions on the CPU), which
    skips the slots past each (expert, group)'s fill count. Without them,
    three batched products over every slot (the reference's einsum path)."""
    _single_device(tp_axis)
    cdt = compute_dtype or x_grouped.dtype
    gate_w, up_w, down_w = (w.to(cdt) for w in (gate_w, up_w, down_w))
    x_grouped = x_grouped.to(cdt)
    if slot_counts is not None and capacity:
        from scaletorch_tpu_torch.ops.grouped_mlp import grouped_swiglu_mlp

        e, t, h = x_grouped.shape
        x4 = x_grouped.reshape(e, t // capacity, capacity, h)
        out = grouped_swiglu_mlp(x4, slot_counts, gate_w, up_w, down_w)
        return out.reshape(e, t, h)
    from scaletorch_tpu_torch.models.layers import swiglu

    g = torch.bmm(x_grouped, gate_w)
    u = torch.bmm(x_grouped, up_w)
    return torch.bmm(swiglu(g, u), down_w)
