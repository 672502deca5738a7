"""Top-k routing, capacity dispatch and the expert-parallel exchange of
the MoE layer (counterpart of scaletorch_tpu/parallel/expert_parallel.py).

Each expert accepts at most C (token, choice) rows per group; routing
decides, for every (token, choice), its expert and its slot in that
expert's queue, and the movement forms carry rows into an ``[E, G, C, H]``
slot buffer and back:

    route     [G, N, E] logits -> expert_idx, slot, weight [G, N, k] (index)
                                  or dispatch / combine [G, N, E, C] (einsum)
    dispatch  [G, N, H] -> [E, G·C, H]  (a scatter, or the one-hot einsum)
              with ``axis``: all-to-all over ep -> [E/ep, ep·G·C, H]
    compute   the per-expert SwiGLU (``moe_mlp``: batched products, or the
              grouped-MLP kernels K5-K7 with per-(expert, group) fill counts,
              exchanged by ``exchange_slot_counts`` in the slabs' order)
    combine   the reverse all-to-all, then [E, G·C, H] -> [G, N, H], the
              weighted top-k sum

The exchange is one ``torch.autograd.Function`` a direction
(``all_to_all_single`` over the ep group of the current mesh manager),
whose backward is the other direction: each rank sends the ``[E/ep, G·C,
H]`` slab of every destination's experts and receives its own experts'
slabs from every source rank, laid out (source_rank, group) along the
token axis. With ``axis`` None, or one rank, it is the identity.

Beside the capacity path, ``sorted_moe_forward`` is the reference's
zero-drop sort-based dispatch (``sort_dispatch_tokens`` /
``sort_gather_tokens``: rows sorted by destination rank, one all-to-all
of the sizes and two of the fixed slabs).

The routing math lives in one place (``_route_core``), so both forms make
the same decisions, drop the same rows and report the same aux losses.
Ties in the top-k go to the lower expert index, as ``jax.lax.top_k``
breaks them (a stable descending sort; ``torch.topk`` promises no order).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from scaletorch_tpu_torch.parallel.mesh import axis_group, group_size

Tensor = torch.Tensor


# ---- the exchange over the ep axis ------------------------------------------------
def _all_to_all(x: Tensor, group) -> Tensor:
    x = x.contiguous()  # before empty_like, which keeps a view's strides
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _to_experts(slots: Tensor, group) -> Tensor:
    """[E, G·C, H] -> [E/ep, ep·G·C, H]: every rank's slabs of this rank's
    experts, in source-rank order."""
    ep = group_size(group)
    e, gc, h = slots.shape
    recv = _all_to_all(slots.reshape(ep, e // ep, gc, h), group)
    return recv.transpose(0, 1).reshape(e // ep, ep * gc, h)


def _from_experts(expert_out: Tensor, group) -> Tensor:
    """[E/ep, ep·G·C, H] -> [E, G·C, H]: the inverse of ``_to_experts``."""
    ep = group_size(group)
    e_local, t, h = expert_out.shape
    send = expert_out.reshape(e_local, ep, t // ep, h).transpose(0, 1)
    return _all_to_all(send, group).reshape(ep * e_local, t // ep, h)


class _ToExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, slots, group):
        ctx.group = group
        return _to_experts(slots, group)

    @staticmethod
    def backward(ctx, grad):
        return _from_experts(grad, ctx.group), None


class _FromExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, expert_out, group):
        ctx.group = group
        return _from_experts(expert_out, group)

    @staticmethod
    def backward(ctx, grad):
        return _to_experts(grad, ctx.group), None


def _exchange_to_experts(slots: Tensor, axis: Optional[str]) -> Tensor:
    """[E, G·C, H] full-expert slabs -> [E/ep, ep·G·C, H] on the rank that
    owns each expert (identity with ``axis`` None or on one rank)."""
    group = axis_group(axis)
    if group_size(group) == 1:
        return slots
    return _ToExperts.apply(slots, group)


def _exchange_from_experts(expert_out: Tensor, axis: Optional[str]
                           ) -> Tensor:
    """The reverse of ``_exchange_to_experts``."""
    group = axis_group(axis)
    if group_size(group) == 1:
        return expert_out
    return _FromExperts.apply(expert_out, group)


def exchange_slot_counts(counts: Tensor, axis: Optional[str]) -> Tensor:
    """[E, G] per-(expert, group) fill counts -> this rank's receive-slab
    order [E/ep, ep·G], blocks of ``capacity`` rows ordered (source_rank,
    group) as ``dispatch_tokens`` lays the tokens out."""
    group = axis_group(axis)
    ep = group_size(group)
    if ep == 1:
        return counts
    e, g = counts.shape
    recv = _all_to_all(counts.reshape(ep, e // ep, g), group)
    return recv.transpose(0, 1).reshape(e // ep, ep * g).contiguous()


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
    [E, G·C, H], or [E/ep, ep·G·C, H] over ``axis``."""
    x, dispatch = _grouped(x, 2), _grouped(dispatch, 3)
    slots = torch.einsum("gnh,gnec->egch", x, dispatch.to(x.dtype))
    e, g, c, h = slots.shape
    return _exchange_to_experts(slots.reshape(e, g * c, h), axis)


def gather_tokens(expert_out: Tensor, combine: Tensor, *,
                  axis: Optional[str] = None) -> Tensor:
    """One-hot combine: expert_out [E, G·C, H] ([E/ep, ep·G·C, H] over
    ``axis``), combine [(G,) N, E, C] -> [(G,) N, H], the weighted sum
    over each token's kept slots."""
    expert_out = _exchange_from_experts(expert_out, axis)
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
    without a data-dependent shape (no host synchronisation). Over
    ``axis`` the buffer goes through the exchange: [E/ep, ep·G·C, H]."""
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
    return _exchange_to_experts(
        slots[:num_experts].reshape(num_experts, g * capacity, h), axis)


def gather_tokens_indexed(expert_out: Tensor, routing: Dict[str, Tensor], *,
                          num_experts: int, capacity: int,
                          axis: Optional[str] = None) -> Tensor:
    """Index combine: gather each (token, choice) slot of expert_out [E,
    G·C, H] (after the reverse exchange over ``axis``) and take the
    weighted top-k sum -> [(G,) N, H]; a dropped choice carries weight 0."""
    expert_out = _exchange_from_experts(expert_out, axis)
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


def sorted_dispatch_reference(x: Tensor, expert_ids: Tensor,
                              num_experts: int):
    """Sort-based dispatch semantics, for tests and ragged flows outside a
    captured step: (sorted_tokens = x[sort_idx] grouped by expert id and
    stable within a group, sort_idx, counts per expert summing to N)."""
    sort_idx = torch.sort(expert_ids, stable=True).indices
    counts = torch.bincount(expert_ids.long(), minlength=num_experts)
    return x[sort_idx], sort_idx, counts


# ---- the sort-based exchange: zero drops, ragged sizes in fixed slabs ---------
#
# Rows are stable-sorted by destination rank and scattered into one slab of
# ``chunk_capacity`` rows per destination (default N: nothing can drop);
# one all-to-all carries the true sizes and two carry the slabs (rows and
# their expert ids). Every local expert then runs over the whole receive
# buffer under a membership mask, which costs E_local times the capacity
# path's products: a correctness path for few local experts.

class _AllToAll(torch.autograd.Function):
    """The equal-split exchange along dim 0; its adjoint is itself."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _excl_cumsum(x: Tensor) -> Tensor:
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0)[:-1]])


def sort_dispatch_tokens(x: Tensor, expert_ids: Tensor, *,
                         axis: Optional[str], num_experts: int,
                         chunk_capacity: Optional[int] = None):
    """x [N, H] local (token·choice) rows and each row's global expert
    ``expert_ids`` [N] -> (recv_x [ep·P, H] grouped by source rank,
    recv_local [ep·P] each row's local expert (E_local marks an empty
    slot), recv_valid [ep·P] bool, meta for ``sort_gather_tokens``).

    P = ``chunk_capacity`` (default N, the zero-drop worst case). Rows
    past a destination's slab are dropped at the sender and counted in
    ``meta["dropped_rows"]``. The scatter sends them to a trash row past
    the slab, so no shape depends on the data."""
    group = axis_group(axis)
    ep = group_size(group)
    me = dist.get_rank(group) if ep > 1 else 0
    n, h = x.shape
    e_local = num_experts // ep
    p = chunk_capacity or n
    dest = expert_ids.long() // e_local
    order = torch.sort(dest, stable=True).indices
    x_s, ids_s, dest_s = x[order], expert_ids[order], dest[order]
    send_sizes = torch.bincount(dest, minlength=ep)
    slot = torch.arange(n, device=x.device) - _excl_cumsum(send_sizes)[dest_s]
    at = (dest_s, torch.clamp(slot, max=p))
    send_x = x.new_zeros(ep, p + 1, h).index_put(at, x_s)[:, :p]
    send_ids = torch.full((ep, p + 1), num_experts, dtype=ids_s.dtype,
                          device=x.device).index_put(at, ids_s)[:, :p]
    if ep > 1:
        recv_sizes = _all_to_all(send_sizes, group)
        recv_x = _AllToAll.apply(send_x, group)
        recv_ids = _all_to_all(send_ids, group)
    else:
        recv_sizes, recv_x, recv_ids = send_sizes, send_x, send_ids
    recv_valid = (torch.arange(p, device=x.device)[None, :]
                  < torch.clamp(recv_sizes, max=p)[:, None]).reshape(-1)
    recv_local = torch.where(recv_valid,
                             recv_ids.reshape(-1).long() - me * e_local,
                             e_local)
    meta = {"order": order, "dest_s": dest_s, "slot": slot, "n": n, "p": p,
            "dropped_rows": torch.clamp(send_sizes - p, min=0).sum()}
    return recv_x.reshape(ep * p, h), recv_local, recv_valid, meta


def sort_gather_tokens(expert_out: Tensor, meta: Dict[str, Tensor], *,
                       axis: Optional[str]) -> Tensor:
    """Expert outputs [ep·P, H] in the receive-slab layout -> [N, H] in
    the rows' original order on their source rank. A row that never left
    (past its slab) comes back as zeros."""
    group = axis_group(axis)
    ep = group_size(group)
    p, n = meta["p"], meta["n"]
    h = expert_out.shape[-1]
    back = expert_out.reshape(ep, p, h)
    if ep > 1:
        back = _AllToAll.apply(back, group)
    kept = meta["slot"] < p
    sorted_back = torch.where(
        kept[:, None],
        back[meta["dest_s"], torch.clamp(meta["slot"], max=p - 1)], 0.0)
    # un-sort: row i of the send order was x[order[i]]
    return sorted_back.new_zeros(n, h).index_copy(0, meta["order"],
                                                  sorted_back)


def sorted_moe_forward(x: Tensor, gate_idx: Tensor, gate_w: Tensor,
                       gate_proj: Tensor, up_proj: Tensor, down_proj: Tensor,
                       *, axis: Optional[str] = None, num_experts: int,
                       chunk_capacity: Optional[int] = None,
                       compute_dtype=None) -> Tensor:
    """Zero-drop MoE forward over the sort-based exchange: x [N, H],
    gate_idx / gate_w [N, k], this rank's experts gate/up [E_local, H, I]
    and down [E_local, I, H] -> [N, H]. ``axis`` None runs locally with
    E_local = E (the world-1 no-op); a named axis, even of one rank, goes
    through the exchange, whose ``chunk_capacity`` may drop rows."""
    from scaletorch_tpu_torch.models.layers import swiglu

    n, h = x.shape
    k = gate_idx.shape[-1]
    cdt = compute_dtype or x.dtype
    flat_x = torch.repeat_interleave(x, k, dim=0)  # row n·k+j = choice j
    flat_ids = gate_idx.reshape(-1)
    if axis is None:
        recv, local_ids = flat_x, flat_ids.long()
        valid = torch.ones(n * k, dtype=torch.bool, device=x.device)
    else:
        recv, local_ids, valid, meta = sort_dispatch_tokens(
            flat_x, flat_ids, axis=axis, num_experts=num_experts,
            chunk_capacity=chunk_capacity)
    e_local = gate_proj.shape[0]
    if e_local > 4:
        import warnings

        warnings.warn(
            f"sorted_moe_forward with E_local={e_local}: every local expert "
            "multiplies the WHOLE receive buffer under a membership mask, "
            f"so compute scales {e_local}x against the capacity path's "
            "slots. For E_local > 4 use the capacity dispatch "
            "(dispatch_routed / moe_mlp) or a larger expert-parallel size.",
            RuntimeWarning, stacklevel=2)
    recv_c = torch.where(valid[:, None], recv, 0.0).to(cdt)
    out = torch.zeros(recv.shape, dtype=cdt, device=x.device)
    for e in range(e_local):  # each expert masks its rows
        mask = (local_ids == e)[:, None]
        g = recv_c @ gate_proj[e].to(cdt)
        u = recv_c @ up_proj[e].to(cdt)
        out = out + torch.where(mask, swiglu(g, u) @ down_proj[e].to(cdt),
                                0.0)
    if axis is not None:
        out = sort_gather_tokens(out, meta, axis=axis)
    y = out.reshape(n, k, h) * gate_w[..., None].to(cdt)
    return y.sum(dim=1)


def validate_ep_divisibility(cfg, ep: int) -> None:
    """Experts shard evenly over the ep axis."""
    if cfg.num_experts % ep != 0:
        raise ValueError(
            f"num_experts={cfg.num_experts} not divisible by ep={ep}")


def moe_mlp(x_grouped: Tensor, gate_w: Tensor, up_w: Tensor, down_w: Tensor,
            *, tp_axis: Optional[str] = None, compute_dtype=None,
            reduce: str = "sum", slot_counts: Optional[Tensor] = None,
            capacity: Optional[int] = None) -> Tensor:
    """Per-expert SwiGLU over x_grouped [E, T, H] with gate/up [E, H, I]
    and down [E, I, H], in ``compute_dtype``.

    With ``tp_axis`` the weights are this rank's tp shards, gate/up
    column-parallel ([E, H, I/tp]) and down row-parallel ([E, I/tp, H])
    inside each expert: ``reduce='sum'`` enters the region
    (``copy_to_tensor_parallel_region`` on the input) and leaves it with
    the all-reduce; ``reduce='none'`` does neither and returns the
    tp-partial output, for a caller that enters with the sequence
    all-gather and leaves with the reduce-scatter (the SP path).

    With ``slot_counts`` [E, T / capacity] and ``capacity`` it runs the
    grouped-MLP op (``ops.grouped_mlp.grouped_swiglu_mlp``: the CUDA
    kernels K5-K7 on the card, their plain versions on the CPU), which
    skips the slots past each (expert, group)'s fill count. Without them,
    three batched products over every slot (the reference's einsum path)."""
    if reduce not in ("sum", "none"):
        raise ValueError(f"reduce must be 'sum' or 'none', got {reduce!r}")
    region = tp_axis is not None and reduce == "sum"
    if region:
        from scaletorch_tpu_torch.parallel.tensor_parallel import (
            copy_to_tensor_parallel_region,
        )

        x_grouped = copy_to_tensor_parallel_region(x_grouped, tp_axis)
    cdt = compute_dtype or x_grouped.dtype
    gate_w, up_w, down_w = (w.to(cdt) for w in (gate_w, up_w, down_w))
    x_grouped = x_grouped.to(cdt)
    if slot_counts is not None and capacity:
        from scaletorch_tpu_torch.ops.grouped_mlp import grouped_swiglu_mlp

        e, t, h = x_grouped.shape
        x4 = x_grouped.reshape(e, t // capacity, capacity, h)
        out = grouped_swiglu_mlp(x4, slot_counts, gate_w, up_w, down_w)
        out = out.reshape(e, t, h)
    else:
        from scaletorch_tpu_torch.models.layers import swiglu

        g = torch.bmm(x_grouped, gate_w)
        u = torch.bmm(x_grouped, up_w)
        out = torch.bmm(swiglu(g, u), down_w)
    if region:
        from scaletorch_tpu_torch.parallel.tensor_parallel import (
            reduce_from_tensor_parallel_region,
        )

        out = reduce_from_tensor_parallel_region(out, tp_axis)
    return out
