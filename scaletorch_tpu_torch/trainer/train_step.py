"""The training step (counterpart of
scaletorch_tpu/parallel/spmd.make_spmd_train_step, with
scaletorch_tpu/trainer/train_step.guarded_update), on one device and,
through ``MeshHooks``, over a device mesh.

``make_train_step`` returns ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``. Per step:

  1. the loss of ``spmd._build_losses.loss_fn``: the decoder forward with
     ``return_hidden=True``, then the chunked fused LM head + cross
     entropy (``fused_vocab_parallel_cross_entropy``, chunk
     ``SCALETORCH_TPU_CE_CHUNK``, default 1024); a Qwen3-MoE forward
     also returns its router aux loss, which joins the loss, and its
     routing statistics (``moe_dropped_fraction``, ``moe_load_cv``),
     which join the metrics (averaged over the microbatches);
  2. the gradients of the loss, averaged over the batch's leading
     accumulation axis (one microbatch: no accumulation buffer at all);
  3. the gradients promoted to fp32 (one leaf at a time), their global
     norm, and the clip to ``max_grad_norm``, in place (the metrics report
     the norm before the clip);
  4. the gradients cast back to each parameter's dtype (bf16 masters get
     bf16 gradients, as the reference's), and ``guarded_update`` with any
     of the port's optimizers (``trainer/optimizer.py``): a non-finite
     loss or norm leaves the parameters and the float optimizer state as
     they were and reports ``update_skipped = 1``.

A mesh (``parallel/spmd.MeshReductions``, or FSDP's
``parallel/fsdp.FsdpReductions``) adds its reductions to steps 2 and 3
through the ``MeshHooks`` it overrides (FSDP also gathers the shards in
step 1); the base hooks do nothing, so one device runs the steps above as
they are. Under pipeline
parallelism a pipeline pass (``parallel/pipeline_parallel``) takes the
place of step 1's microbatch loop and the gradients of step 2.

Parameters and optimizer state are updated in place and returned.
``metrics`` holds 0-d device tensors: reading them is the caller's
synchronisation point.

``make_eval_step`` returns the validation loss of the same loss function
under ``torch.no_grad()``, without gradient checkpointing.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from scaletorch_tpu_torch.env import get_env
from scaletorch_tpu_torch.models import llama, qwen3_moe
from scaletorch_tpu_torch.parallel.tensor_parallel import (
    fused_vocab_parallel_cross_entropy,
)
from scaletorch_tpu_torch.trainer.optimizer import (
    Optimizer,
    guarded_update,
    tree_leaves,
)

Tensor = torch.Tensor
Batch = Dict[str, Tensor]  # input_ids/target_ids [accum, micro_bs, seq]


def ce_chunk_size() -> int:
    """``SCALETORCH_TPU_CE_CHUNK`` (default 1024), read through the env
    registry as the reference reads it."""
    return get_env("SCALETORCH_TPU_CE_CHUNK")


def global_grad_norm(grads: List[Tensor]) -> Tensor:
    """sqrt of the sum of squares of every gradient, in fp32."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def clip_scale(norm: Tensor, max_norm: float) -> Tensor:
    """min(1, max_norm / norm): the factor of the clip to ``max_norm``."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


class MeshHooks:
    """What a step over a device mesh adds to the one-device step. Each
    hook here does nothing; ``parallel/spmd.MeshReductions`` overrides
    them with the mesh's reductions."""

    tp_axis: Optional[str] = None
    ep_axis: Optional[str] = None
    sequence_parallel: bool = False
    # FSDP's ``parallel/fsdp.FsdpGather``: the shards' full leaves for the
    # forward (None: the leaves are whole)
    param_gather: Optional[Any] = None

    def scope(self):
        """Context of the forward and backward (on a mesh, its axis names
        resolve inside it)."""
        return contextlib.nullcontext()

    def reduce(self, params, loss: Tensor, grads: List[Tensor]
               ) -> Tuple[Tensor, List[Tensor]]:
        """(loss, fp32 gradients) of the whole step over the mesh."""
        return loss, grads

    def grad_norm(self, params, grads: List[Tensor]) -> Tensor:
        return global_grad_norm(grads)

    def reduce_stats(self, stats: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The routing statistics of the whole step over the mesh."""
        return stats

    def loss_sum(self, total: Tensor) -> Tuple[Tensor, int]:
        """(sum of ``total`` over the data ranks, their count)."""
        return total, 1


def make_loss_fn(cfg, *, attention_backend: str,
                 gradient_checkpointing: bool,
                 remat_policy: str = "nothing_saveable",
                 tp_axis: Optional[str] = None,
                 sequence_parallel: bool = False,
                 ep_axis: Optional[str] = None,
                 param_gather: Optional[Any] = None) -> Callable:
    """loss(params, microbatch) -> (fp32 scalar, routing stats): the
    hidden states of the decoder through the chunked fused head + cross
    entropy, plus the router aux loss for a Qwen3-MoE config, whose
    routing statistics come beside it (empty for a dense model). With
    ``tp_axis`` the decoder runs its tensor-parallel path (SP with
    ``sequence_parallel``) and the loss is the vocab-parallel one; with
    ``ep_axis`` the MoE layers exchange their slots over ep; with
    ``param_gather`` (FSDP) the parameters are shards, gathered for the
    head and embedding once and for each layer inside it."""
    chunk = ce_chunk_size()
    is_moe = isinstance(cfg, qwen3_moe.Qwen3MoEConfig)
    model = qwen3_moe if is_moe else llama
    tp_kw = ({"tp_axis": tp_axis, "sequence_parallel": sequence_parallel}
             if tp_axis is not None else {})
    if ep_axis is not None and is_moe:
        tp_kw["ep_axis"] = ep_axis

    def loss_fn(params, mb: Dict[str, Tensor]
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
        fwd_kw = dict(tp_kw)
        if param_gather is not None:
            params = param_gather.outer(params)
            fwd_kw["layer_gather"] = param_gather.layer
        out = model.forward(
            params, mb["input_ids"], cfg,
            positions=mb["position_ids"],
            attention_backend=attention_backend,
            gradient_checkpointing=gradient_checkpointing,
            remat_policy=remat_policy,
            return_hidden=True,
            **({"return_moe_stats": True} if is_moe else {}),
            **fwd_kw,
        )
        hidden, aux, stats = out if is_moe else (out, 0.0, {})
        head = model.lm_head_weight(params, cfg)
        loss = fused_vocab_parallel_cross_entropy(
            hidden, head, mb["target_ids"], axis=tp_axis,
            chunk_size=chunk) + aux
        return loss, stats

    return loss_fn


def _cast_(grads: List[Tensor], dtypes: List[torch.dtype]) -> None:
    """grads[i] cast to dtypes[i] in the list, one at a time, so each
    old tensor can go before the next is made (a whole second copy of the
    gradients never exists)."""
    for i, dtype in enumerate(dtypes):
        grads[i] = grads[i].to(dtype)


def _micro(batch: Batch, a: int) -> Dict[str, Tensor]:
    return {k: v[a] for k, v in batch.items()}


def make_grad_fn(cfg, *, attention_backend: str = "sdpa",
                 gradient_checkpointing: bool = False,
                 remat_policy: str = "nothing_saveable",
                 mesh: Optional[MeshHooks] = None,
                 pipeline: Optional[Callable] = None) -> Callable:
    """grads(params, batch) -> (loss, stats, fp32 gradients in
    ``tree_leaves`` order), averaged over the batch's accumulation axis
    and reduced over ``mesh``: steps 1 and 2 of the step. ``pipeline``
    (``parallel/pipeline_parallel.make_pipeline_grad_fn``) replaces the
    microbatch loop by a pipeline pass over the same axis."""
    mesh = mesh or MeshHooks()
    loss_fn = make_loss_fn(cfg, attention_backend=attention_backend,
                           gradient_checkpointing=gradient_checkpointing,
                           remat_policy=remat_policy, tp_axis=mesh.tp_axis,
                           sequence_parallel=mesh.sequence_parallel,
                           ep_axis=mesh.ep_axis,
                           param_gather=mesh.param_gather)

    def grads_fn(params, batch: Batch):
        if pipeline is not None:
            with mesh.scope():
                loss, stats, grads = pipeline(params, batch)
            loss, grads = mesh.reduce(params, loss.detach(), grads)
            return loss, mesh.reduce_stats(stats), grads
        leaves = tree_leaves(params)
        accum = batch["input_ids"].shape[0]
        with mesh.scope():
            loss, stats = loss_fn(params, _micro(batch, 0))
            grads = list(torch.autograd.grad(loss, leaves))
            if accum > 1:
                _cast_(grads, [torch.float32] * len(grads))
                for a in range(1, accum):
                    loss_a, stats_a = loss_fn(params, _micro(batch, a))
                    for acc, g in zip(grads,
                                      torch.autograd.grad(loss_a, leaves)):
                        acc.add_(g.float())
                    loss = loss + loss_a
                    stats = {k: v + stats_a[k] for k, v in stats.items()}
                for g in grads:
                    g.div_(accum)
                loss = loss / accum
                stats = {k: v / accum for k, v in stats.items()}
        _cast_(grads, [torch.float32] * len(grads))
        loss, grads = mesh.reduce(params, loss.detach(), grads)
        return loss, mesh.reduce_stats(stats), grads

    return grads_fn


def make_train_step(
    cfg,
    optimizer: Optimizer,
    *,
    attention_backend: str = "sdpa",
    gradient_checkpointing: bool = False,
    remat_policy: str = "nothing_saveable",
    max_grad_norm: float = 0.0,
    mesh: Optional[MeshHooks] = None,
    pipeline: Optional[Callable] = None,
) -> Callable:
    """Build ``step(params, opt_state, batch)`` for ``optimizer`` (AdamW,
    Adam, SGD, LAMB or Adafactor) and the remat policy. ``batch`` leaves
    live on the parameters' device: ``input_ids``/``target_ids`` [accum,
    micro_bs, seq], ``position_ids`` [accum, seq]. ``mesh``: the mesh's
    reductions (``parallel/spmd.make_spmd_train_step``); none on one
    device. ``pipeline``: ``make_grad_fn``'s."""
    mesh = mesh or MeshHooks()
    grads_fn = make_grad_fn(cfg, attention_backend=attention_backend,
                            gradient_checkpointing=gradient_checkpointing,
                            remat_policy=remat_policy, mesh=mesh,
                            pipeline=pipeline)

    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        loss, stats, grads = grads_fn(params, batch)
        grad_norm = mesh.grad_norm(params, grads)
        if max_grad_norm and max_grad_norm > 0:
            scale = clip_scale(grad_norm, max_grad_norm)
            # in place, each distinct tensor once: no second fp32 copy
            for g in {id(g): g for g in grads}.values():
                g.mul_(scale)
        _cast_(grads, [p.dtype for p in leaves])
        tree = _like(params, grads)
        ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
        params, opt_state, skipped = guarded_update(
            optimizer, params, opt_state, tree, ok)
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "update_skipped": skipped,
                   **{k: v.detach() for k, v in stats.items()}}
        return params, opt_state, metrics

    return step


def make_eval_step(cfg, *, attention_backend: str = "sdpa",
                   mesh: Optional[MeshHooks] = None,
                   pipeline: Optional[Callable] = None) -> Callable:
    """``eval_step(params, batch) -> loss``: the train step's loss (the
    MoE aux loss included) averaged over the batch's accumulation axis
    (and over the mesh's data ranks), under ``torch.no_grad()`` and
    without gradient checkpointing, on the train step's attention
    backend. A 0-d fp32 device tensor. ``pipeline``
    (``parallel/pipeline_parallel.make_pipeline_eval_fn``) gives the
    mean over the accumulation axis in one pipeline pass."""
    mesh = mesh or MeshHooks()
    loss_fn = make_loss_fn(cfg, attention_backend=attention_backend,
                           gradient_checkpointing=False,
                           tp_axis=mesh.tp_axis,
                           sequence_parallel=mesh.sequence_parallel,
                           ep_axis=mesh.ep_axis,
                           param_gather=mesh.param_gather)

    @torch.no_grad()
    def eval_step(params, batch) -> Tensor:
        if pipeline is not None:
            with mesh.scope():
                loss = pipeline(params, batch).float()
            total, ranks = mesh.loss_sum(loss)
            return total / ranks
        accum = batch["input_ids"].shape[0]
        total = torch.zeros((), dtype=torch.float32,
                            device=batch["input_ids"].device)
        with mesh.scope():
            for a in range(accum):
                loss, _ = loss_fn(params, _micro(batch, a))
                total = total + loss.float()
        total, ranks = mesh.loss_sum(total)
        return total / (accum * ranks)

    return eval_step


def _like(tree, leaves: List[Tensor]):
    """``leaves`` (in ``tree_leaves`` order) in the shape of ``tree``."""
    it = iter(leaves)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}

    return build(tree)


# ---- the analyzer's audit entries ------------------------------------------------
def audit_train_contract(name: str, file: str, mesh_sizes: Dict[str, int],
                         batch_shape: Tuple[int, int, int],
                         make_step: Callable, *,
                         donate: bool = True,
                         inplace_share: float = 0.9) -> Dict[str, Any]:
    """A train-step audit entry (``analysis/entry_audit.py``): the tiny
    Llama of the inference entries (hidden 64, 2 layers, 4 / 2 heads of D
    16, vocab 128, fp32), its shards on this rank of ``mesh_sizes``
    (under the analyzer's ``fake`` group at the mesh's world size), SGD
    state, a seeded batch of ``batch_shape`` = (accumulation, global
    micro-batch rows, seq) cut to this rank, and the step
    ``make_step(mm, cfg, optimizer)`` over the flash attention backend.

    The contract is pinned here, not derived from the arguments: the dp
    edge carries int8 (``quantized_axis``), parameters and optimizer
    state are updated in place (``expect_inplace``, ``inplace_min_mb``:
    ``inplace_share`` of the bytes of the parameters and of their SGD
    trace, the rank's share under tp),
    no dp collective runs inside the microbatch loop (``hoisted_axes``,
    marked by ``_micro``), no collective result exceeds four times the
    parameter bytes. ``donate=False`` is the injected regression: the
    step then leaves each parameter in a fresh tensor (out of place)."""
    from scaletorch_tpu_torch.inference.decode import audit_cfg

    cfg = audit_cfg()
    param_mb = 4 * cfg.num_params() / 1e6

    def setup(device) -> Dict[str, Any]:
        import numpy as np

        from scaletorch_tpu_torch.data.dataloader import device_batch
        from scaletorch_tpu_torch.models.convert import (
            params_from_numpy,
            shard_numpy_params,
        )
        from scaletorch_tpu_torch.parallel.mesh import setup_mesh_manager
        from scaletorch_tpu_torch.parallel.spmd import local_batch
        from scaletorch_tpu_torch.trainer.optimizer import SGD, tree_leaves

        dev = torch.device(device)
        mm = setup_mesh_manager(**mesh_sizes, device_type=dev.type)
        full = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
        params = params_from_numpy(
            shard_numpy_params(full, cfg, mm, mm.rank), dev)
        optimizer = SGD(lambda step: 0.1, momentum=0.0)
        state = optimizer.init(params)
        accum, rows, seq = batch_shape
        rng = np.random.default_rng(0)
        batch = {k: rng.integers(0, cfg.vocab_size, batch_shape,
                                 dtype=np.int32)
                 for k in ("input_ids", "target_ids")}
        batch["position_ids"] = np.broadcast_to(
            np.arange(seq, dtype=np.int32), (accum, seq)).copy()
        local = device_batch(local_batch(batch, mm), dev)
        step = make_step(mm, cfg, optimizer)

        def call():
            out = step(params, state, local)
            if not donate:  # the injected regression: out of place
                for p in tree_leaves(params):
                    p.data = p.data.clone()
            return out

        inplace = {f"param{i}": p for i, p in enumerate(tree_leaves(params))}
        inplace.update({f"state{i}": t for i, t in enumerate(
            tree_leaves(state["trace"]))})
        return {"call": call, "inplace": inplace, "mesh": mm,
                "arguments": [*inplace.values(), *local.values()]}

    tp = mesh_sizes.get("tp", 1)
    return {
        "name": name, "file": file,
        "world_size": math.prod(mesh_sizes.values()),
        "quantized_axis": ("dp", "int8"),
        # pinned contract, NOT echoed from ``donate``: building with
        # donate=False is the injected regression the audit must catch
        "expect_inplace": True,
        "hoisted_axes": ("dp",),
        "max_collective_result_mb": max(1.0, 4.0 * param_mb),
        "compute_dtype": "fp32",
        "inplace_min_mb": round(inplace_share * 2 * param_mb / tp, 4),
        "microbatches": batch_shape[0],
        "loop_marker": "scaletorch_tpu_torch.trainer.train_step._micro",
        "grad": True,
        "setup": setup,
    }


def audit_entry(grad_allreduce_dtype: str = "int8", donate: bool = True,
                *, world: int = 8) -> Dict[str, Any]:
    """Audit entry: the quantized-dp train step on a pure dp 8 mesh
    (the reference's declarative step; the port has one step body,
    ``make_train_step`` over ``parallel/spmd.MeshReductions``), seq 64,
    2 x 8 microbatch rows. ``grad_allreduce_dtype`` / ``donate`` exist so
    the tests can inject exactly the reference's regressions; ``world``
    builds the same step over another dp size (one row a rank)."""

    def make_step(mm, cfg, optimizer):
        from scaletorch_tpu_torch.parallel.spmd import MeshReductions

        return make_train_step(
            cfg, optimizer, attention_backend="flash", max_grad_norm=1.0,
            mesh=MeshReductions(mm, cfg,
                                grad_allreduce_dtype=grad_allreduce_dtype,
                                grad_allreduce_axis="dp"))

    return audit_train_contract(
        "declarative_train_step", "scaletorch_tpu_torch/trainer/train_step.py",
        {"dp": world}, (2, world, 64), make_step, donate=donate)
