"""Tensor parallelism: Megatron-style column, row and vocab-parallel ops
and the vocab-parallel losses (counterpart of
scaletorch_tpu/parallel/tensor_parallel.py).

Every rank holds plain local shards (not DTensors) and the collectives
are explicit ``torch.autograd.Function``s on the group of the mesh axis
``axis`` names (of the current ``parallel.mesh.MeshManager``; None: one
device), the reference's f/g region functions:

  * ``copy_to_tensor_parallel_region``: identity forward, all-reduce
    backward (a replicated activation entering rank-local compute);
  * ``reduce_from_tensor_parallel_region``: all-reduce forward, identity
    backward (partial sums leaving it);
  * ``gather_from_tensor_parallel_region``: all-gather of the last dim
    forward, this rank's slice backward.

With them every activation gradient is whole on every rank, so a
sharded weight's gradient is exactly its shard's and a replicated
weight's gradient is whole where it met replicated data. A replicated
weight that met sharded data (a norm over a sequence slice under SP, the
per-head q/k norms over this rank's heads) has a partial gradient:
``llama_grad_partial_over_tp`` names those leaves, and the train step
sums them over tp (the reference's ``rep_axes`` psum).

Weights are ``[in, out]``; ``llama_param_specs`` gives the dim of each
leaf that splits over tp (None: replicated): q/k/v/gate/up split their
output dim, o/down their input dim, the embedding its vocab rows, the
untied head its vocab columns.

The losses: ``fused_vocab_parallel_cross_entropy`` applies the LM head
and the loss one sequence chunk at a time; each chunk runs under
``torch.utils.checkpoint`` so its logits are recomputed in the backward
and the full ``[B, S, V/tp]`` logits never exist. With ``axis`` None
(the losses' default) they are the single-device forms.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from scaletorch_tpu_torch.parallel.mesh import (
    all_gather_cat,
    all_reduce_,
    axis_group,
    group_size,
)
from scaletorch_tpu_torch.parallel.sequence_parallel import (
    reduce_scatter_sequence,
)

Tensor = torch.Tensor


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


# ---- f/g region functions ------------------------------------------------------
class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_cat(x, group, -1)

    @staticmethod
    def backward(ctx, grad):
        world = group_size(ctx.group)
        if world == 1:
            return grad, None
        width = grad.shape[-1] // world
        r = _rank(ctx.group)
        return grad[..., r * width:(r + 1) * width].contiguous(), None


def copy_to_tensor_parallel_region(x: Tensor,
                                   axis: Optional[str] = "tp") -> Tensor:
    """Identity forward / all-reduce backward."""
    return _CopyToRegion.apply(x, axis_group(axis))


def reduce_from_tensor_parallel_region(x: Tensor,
                                       axis: Optional[str] = "tp") -> Tensor:
    """All-reduce forward / identity backward."""
    return _ReduceFromRegion.apply(x, axis_group(axis))


def gather_from_tensor_parallel_region(x: Tensor,
                                       axis: Optional[str] = "tp") -> Tensor:
    """All-gather of the last dim forward / this rank's slice backward."""
    return _GatherFromRegion.apply(x, axis_group(axis))


# ---- parallel layers -----------------------------------------------------------
def column_parallel_linear(x: Tensor, w_local: Tensor, *,
                           axis: Optional[str] = "tp",
                           gather_output: bool = False) -> Tensor:
    """y_local = x @ W[:, shard]: ``x`` replicated over tp, the output
    sharded on its last dim (or gathered with ``gather_output``)."""
    y = copy_to_tensor_parallel_region(x, axis) @ w_local
    if gather_output:
        y = gather_from_tensor_parallel_region(y, axis)
    return y


def row_parallel_linear(x_local: Tensor, w_local: Tensor, *,
                        axis: Optional[str] = "tp",
                        sequence_parallel: bool = False,
                        seq_dim: int = 1) -> Tensor:
    """y = sum over tp of x_local @ W[shard, :]; with
    ``sequence_parallel`` the sum is a reduce-scatter along ``seq_dim``."""
    partial = x_local @ w_local
    if sequence_parallel:
        return reduce_scatter_sequence(partial, axis, seq_dim)
    return reduce_from_tensor_parallel_region(partial, axis)


def vocab_parallel_embedding(ids: Tensor, table_local: Tensor, *,
                             axis: Optional[str] = "tp",
                             reduce: str = "sum") -> Tensor:
    """Row-sharded embedding lookup: ids [B, S] (global), table_local
    [V/tp, H]. Ids outside this rank's rows read zeros; ``reduce='none'``
    returns the partial sums for the caller to complete (the SP path
    completes them with a sequence reduce-scatter)."""
    vocab_local = table_local.shape[0]
    offset = _rank(axis_group(axis)) * vocab_local
    ids = ids.long()
    in_shard = (ids >= offset) & (ids < offset + vocab_local)
    local_ids = torch.where(in_shard, ids - offset, 0)
    emb = torch.where(in_shard[..., None], table_local[local_ids], 0)
    if reduce == "none":
        return emb
    return reduce_from_tensor_parallel_region(emb, axis)


# ---- losses --------------------------------------------------------------------
def _vocab_parallel_token_stats(
    logits_local: Tensor,
    targets: Tensor,
    axis: Optional[str],
    ignore_index: int,
) -> Tuple[Tensor, Tensor]:
    """(nll_sum, token_count), fp32: logsumexp with a gradient-free max
    shift and the gold logit, each over the local vocab shard and summed
    over ``axis`` (None: one device)."""
    group = axis_group(axis)
    logits32 = logits_local.float()
    vocab_local = logits32.shape[-1]
    offset = _rank(group) * vocab_local
    shift = logits32.amax(dim=-1).detach()
    if group_size(group) > 1:
        dist.all_reduce(shift, op=dist.ReduceOp.MAX, group=group)
    sumexp = torch.exp(logits32 - shift[..., None]).sum(dim=-1)
    if axis is not None:
        sumexp = reduce_from_tensor_parallel_region(sumexp, axis)
    logz = shift + torch.log(sumexp)
    mask = targets != ignore_index
    safe_t = torch.where(mask, targets, 0).long()
    if axis is None:
        gold = torch.gather(logits32, -1, safe_t[..., None])[..., 0]
    else:
        in_shard = (safe_t >= offset) & (safe_t < offset + vocab_local)
        local_t = torch.where(in_shard, safe_t - offset, 0)
        gold = torch.gather(logits32, -1, local_t[..., None])[..., 0]
        gold = reduce_from_tensor_parallel_region(
            torch.where(in_shard, gold, 0.0), axis)
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum().float()


def vocab_parallel_cross_entropy(
    logits_local: Tensor,
    targets: Tensor,
    *,
    axis: Optional[str] = None,
    ignore_index: int = -100,
) -> Tensor:
    """Token-mean cross entropy over vocab-sharded [..., V/tp] logits
    without gathering them."""
    nll_sum, count = _vocab_parallel_token_stats(
        logits_local, targets, axis, ignore_index)
    return nll_sum / count.clamp_min(1.0)


def fused_vocab_parallel_cross_entropy(
    hidden: Tensor,
    head_local: Tensor,
    targets: Tensor,
    *,
    axis: Optional[str] = None,
    chunk_size: int = 1024,
    ignore_index: int = -100,
) -> Tensor:
    """LM-head matmul + cross entropy fused over sequence chunks.

    hidden: [B, S, H] (replicated over tp; the caller's region function
    sums its gradient); head_local: [H, V/tp]; targets: [B, S]. The last
    chunk may be shorter. Each chunk's logits are recomputed in the
    backward, so only the [B, C, H] hidden chunk is kept per chunk."""
    s = hidden.shape[1]
    chunk = min(chunk_size, s)

    def chunk_stats(x_chunk, head, t_chunk):
        return _vocab_parallel_token_stats(x_chunk @ head, t_chunk, axis,
                                           ignore_index)

    if chunk >= s:
        nll_sum, count = chunk_stats(hidden, head_local, targets)
        return nll_sum / count.clamp_min(1.0)
    nll_sum = count = None
    for c0 in range(0, s, chunk):
        n, m = checkpoint(chunk_stats, hidden[:, c0:c0 + chunk], head_local,
                          targets[:, c0:c0 + chunk], use_reentrant=False)
        nll_sum = n if nll_sum is None else nll_sum + n
        count = m if count is None else count + m
    return nll_sum / count.clamp_min(1.0)


# ---- sharding rules ------------------------------------------------------------
def validate_tp_divisibility(cfg, tp: int) -> None:
    """Every dim that splits over tp must divide by it."""
    checks = {
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "intermediate_size": cfg.intermediate_size,
        "vocab_size": cfg.vocab_size,
    }
    for name, value in checks.items():
        if value % tp != 0:
            raise ValueError(f"{name}={value} not divisible by tp={tp}")


def llama_param_specs(cfg) -> Dict[str, object]:
    """The dim of each Llama/Qwen3 leaf that splits over tp (None:
    replicated), in the parameter dict's nesting: the declarative form
    of the reference's ``llama_param_specs`` (layers are stacked on
    dim 0)."""
    layers: Dict[str, Optional[int]] = {
        "input_layernorm": None,
        "q_proj": 2, "k_proj": 2, "v_proj": 2,
        "o_proj": 1,
        "post_attention_layernorm": None,
        "gate_proj": 2, "up_proj": 2,
        "down_proj": 1,
    }
    if cfg.qk_norm:
        layers["q_norm"] = None
        layers["k_norm"] = None
    specs: Dict[str, object] = {"embed_tokens": 0, "layers": layers,
                                "norm": None}
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = 1
    return specs


def param_specs(cfg) -> Dict[str, object]:
    """The tp split dims of ``cfg``'s parameters: ``llama_param_specs``,
    ``models.qwen3_moe.qwen3_moe_param_specs`` for a Qwen3-MoE or
    ``models.gpt_moe.gpt_moe_param_specs`` for a GPT-MoE."""
    from scaletorch_tpu_torch.models.gpt_moe import (
        GPTMoEConfig,
        gpt_moe_param_specs,
    )

    if isinstance(cfg, GPTMoEConfig):
        return gpt_moe_param_specs(cfg)
    if hasattr(cfg, "num_experts"):
        from scaletorch_tpu_torch.models.qwen3_moe import (
            qwen3_moe_param_specs,
        )

        return qwen3_moe_param_specs(cfg)
    return llama_param_specs(cfg)


def shard_dims(cfg) -> Dict[str, Dict[str, int]]:
    """Flat leaf name -> {mesh axis: the dim that splits over it}: tp as
    ``param_specs``; every stacked layer leaf's dim 0 over pp; every expert
    leaf's expert dim over ep. An axis of size 1 splits nothing."""
    from scaletorch_tpu_torch.models.convert import flatten_params

    out = {}
    for name, tp_dim in flatten_params(param_specs(cfg)).items():
        dims = {} if tp_dim is None else {"tp": tp_dim}
        if name.startswith("layers."):
            dims["pp"] = 0
            if name.split(".")[-1].startswith("expert_"):
                dims["ep"] = 1
        out[name] = dims
    return out


def llama_grad_partial_over_tp(cfg, sequence_parallel: bool
                               ) -> Dict[str, object]:
    """Per leaf (nesting of ``param_specs``): whether its gradient on one
    tp rank is a partial to be summed over tp. The q/k norms always are
    (each rank's heads); the hidden-size norms and the MoE router are
    under SP (each rank's sequence slice, the tp-partial expert output);
    sharded leaves never are."""

    def partial(name: str, dim) -> bool:
        if dim is not None:
            return False
        return name in ("q_norm", "k_norm") or sequence_parallel

    specs = param_specs(cfg)
    return {k: ({n: partial(n, d) for n, d in v.items()}
                if isinstance(v, dict) else partial(k, v))
            for k, v in specs.items()}
