"""The training loop (counterpart of scaletorch_tpu/trainer/trainer.Trainer)
on one card or over a device mesh.

``Trainer(cfg, device=None, tokenizer=None)`` builds the model config
(Llama, Qwen3 or Qwen3-MoE; from ``model_name_or_path``'s
``config.json`` when set), the master parameters in ``param_dtype``
(fp32 or bf16; seeded, or read from the HF safetensors at
``model_name_or_path`` with ``load_pretrained_weights``), the optimizer
``optimizer_name`` names (adamw, adam, sgd, lamb or adafactor, its state
in the parameters' dtype) with its schedule, the loader (a
local ``.json``/``.jsonl`` corpus tokenized by ``tokenizer`` or the one
``tokenizer_name_or_path`` names, or the synthetic stream), the train
step and, with ``eval_frequency``, the eval step over a fixed held-out
set. With ``resume`` auto or must it restores the newest checkpoint in
``checkpoint_dir`` at construction.

``step(batch=None)`` runs one optimizer step; ``train(num_steps=None)``
runs the loop: a ``MetricsLogger`` line every ``log_frequency`` steps,
``evaluate()`` every ``eval_frequency`` steps, ``save_checkpoint()``
every ``save_frequency`` steps, and the metrics history as JSON in
``performance_log_dir`` at the end; ``export_hf(path)`` writes the
parameters as a HF checkpoint. ``device=None`` means the CUDA card
and raises without one; the CPU runs only when asked for by name.

Over a mesh (``torchrun --nproc-per-node N -m scaletorch_tpu_torch.train
--tensor_parallel_size ... --context_parallel_size ...
--pipeline_parallel_size ... --pp_engine afab|memory_chunked|interleaved
--expert_parallel_size ... --data_parallel_size ...``) the constructor
follows the reference's order: ``dist.init_distributed`` (NCCL on
``cuda:LOCAL_RANK``, gloo for ``device='cpu'``), ``validate_world_size``,
the mesh (``parallel/mesh.setup_mesh_manager``), the virtual-stage count
(``suggest_virtual_stages`` for ``pp_virtual_stages=0``), the cp backend
(``auto`` through ``parallel/cp_select.resolve_cp_backend``; cp needs
``ring`` or ``ulysses``), the zigzag sequence check, the tp and ep
divisibility checks. Every rank draws the same full parameters from the
seed and keeps its part (``models/convert.local_shard_fn``: the stacked
layer axis padded for an uneven split, or put in interleaved order, then
its pp block; its experts; its tp slice), so the weights are one card's;
each step feeds the rank its part of the global batch
(``parallel/spmd.local_batch``) to ``parallel/spmd.make_spmd_train_step``
(the single-device step at world 1), with the pipeline schedule and
the gradient wire format (``grad_allreduce_dtype``) the config names. A
Qwen3-MoE logs its routing statistics (``moe_dropped_fraction``,
``moe_load_cv``). Logs and the metrics JSON come from rank 0 only.
Adafactor reduces its statistics over the split dims of each shard
(``trainer/factored.py``). Checkpoints over processes are global
tensors written once per distinct shard and agreed on the decision bus
(``utils/checkpoint.py``); ``export_hf`` gathers the shards leaf by leaf
to rank 0, in the model's layer order, and writes the one-card files.

The runtime around the loop follows the reference's: a
``ResilienceManager`` (divergence sentinel with skip, rollback or abort;
fault injection from the ``ft_*`` fields and ``SCALETORCH_TPU_FT_*``),
``PreemptionHandler`` installed for ``train()`` (SIGTERM or SIGINT asks
for an emergency checkpoint at the next step boundary and a clean
return with ``preempted`` set), a ``HangWatchdog`` when
``ft_hang_timeout`` > 0, a crash report on every abort path, and the
``Telemetry`` facade (spans, the JSONL stream, profiler windows, SIGUSR1
live snapshots) when ``telemetry_dir`` is set. Over processes every
control decision is coordinated (``CoordinatedResilience`` on a gloo
``DecisionBus``: one rank's SIGTERM is a collective emergency save at one
step, one rank's NaN a fleet-wide skip, rollback or abort), with a
``StragglerDetector`` on rank 0 when ``straggler_factor`` is set. With
``elastic`` an ``ElasticCoordinator`` keeps the membership: a lost peer
(``PeerLostError``) makes the survivors agree a smaller epoch, re-form
their process group at the epoch's rendezvous, rebuild the mesh with dp
absorbing the change and restore the newest checkpoint; a relaunched rank
parks until a checkpoint boundary readmits it; the run ends at the same
``total_train_steps``. An NCCL group cannot be re-formed in place
(``dist.can_reform_in_process``): there the elastic layer hands over to
the launcher's fleet restart (exit 43, or NCCL's watchdog ending a rank
blocked on the lost peer at the group's timeout).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import socket
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from scaletorch_tpu_torch import dist as stdist
from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
from scaletorch_tpu_torch.data.dataloader import (
    MicroBatchDataLoader,
    SyntheticDataLoader,
    device_batch,
    remap_loader_position,
)
from scaletorch_tpu_torch.models import llama, qwen3_moe
from scaletorch_tpu_torch.models.qwen3 import Qwen3Config
from scaletorch_tpu_torch.models.convert import (
    local_shard_fn,
    shard_numpy_params,
)
from scaletorch_tpu_torch.models.registry import resolve_attention_backend
from scaletorch_tpu_torch.parallel.cp_select import resolve_cp_backend
from scaletorch_tpu_torch.parallel.expert_parallel import (
    validate_ep_divisibility,
)
from scaletorch_tpu_torch.parallel.mesh import (
    MeshShrinkError,
    elastic_mesh_kwargs,
    setup_mesh_manager,
)
from scaletorch_tpu_torch.parallel.pipeline_parallel import (
    stage_layer_layout,
    suggest_virtual_stages,
)
from scaletorch_tpu_torch.parallel.spmd import (
    local_batch,
    make_spmd_eval_step,
    make_spmd_train_step,
)
from scaletorch_tpu_torch.parallel.tensor_parallel import (
    shard_dims,
    validate_tp_divisibility,
)
from scaletorch_tpu_torch.resilience import (
    ResilienceManager,
    TrainingDivergedError,
)
from scaletorch_tpu_torch.resilience_distributed import (
    CoordinatedResilience,
    DecisionBus,
    ElasticCoordinator,
    ElasticRemeshError,
    HangWatchdog,
    PeerLostError,
    hang_timeout_from_config,
    is_transport_error,
    write_crash_report,
)
from scaletorch_tpu_torch.telemetry import (
    NOOP_SPAN,
    StragglerDetector,
    Telemetry,
)
from scaletorch_tpu_torch.trainer.metrics import MetricsLogger
from scaletorch_tpu_torch.trainer.optimizer import (
    create_optimizer,
    tree_leaves,
)
from scaletorch_tpu_torch.utils.device import (
    DeviceLike,
    get_theoretical_flops,
    resolve_device,
)
from scaletorch_tpu_torch.utils.logger import get_logger
from scaletorch_tpu_torch.utils.misc import (
    get_num_params,
    to_readable_format,
)

_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# in-place remeshes (every member alive) at one step before a further
# transport error there is raised as itself
MAX_SPURIOUS_REMESHES = 2


def build_model_config(cfg: ScaleTorchTPUArguments):
    """``model_type`` dispatch over the config's architecture fields, or
    over ``model_name_or_path``'s ``config.json`` when set (the training
    knobs still come from ``cfg``)."""
    if cfg.model_type in ("lenet", "gpt_moe", "mingpt"):
        # the examples' models train through their own mains, not the LLM
        # Trainer's sequence / cross-entropy pipeline
        raise ValueError(
            f"model_type {cfg.model_type!r} trains via its example: "
            "python -m scaletorch_tpu_torch.examples.mnist.train_mnist "
            "(lenet) or python -m "
            "scaletorch_tpu_torch.examples.mingpt.train_mingpt "
            "(gpt_moe/mingpt)")
    overrides = dict(dtype=_DTYPE[cfg.dtype],
                     param_dtype=_DTYPE[cfg.param_dtype])
    if cfg.model_name_or_path:
        from scaletorch_tpu_torch.utils.hf_interop import read_hf_config

        hf = read_hf_config(cfg.model_name_or_path)
        if cfg.model_type == "qwen3_moe":
            # an explicit CLI value overrides the checkpoint's
            # architecture; a single -1 clears mlp_only_layers
            arch = {}
            if cfg.mlp_only_layers is not None:
                arch["mlp_only_layers"] = tuple(
                    i for i in cfg.mlp_only_layers if i >= 0)
            if cfg.decoder_sparse_step is not None:
                arch["decoder_sparse_step"] = cfg.decoder_sparse_step
            return qwen3_moe.Qwen3MoEConfig.from_hf(
                hf, capacity_factor=cfg.moe_capacity_factor,
                moe_dispatch=cfg.moe_dispatch,
                aux_loss_coef=cfg.router_aux_loss_coef,
                z_loss_coef=cfg.router_z_loss_coef, **arch, **overrides)
        if cfg.model_type == "qwen3":
            return Qwen3Config.from_hf(hf, **overrides)
        if cfg.model_type == "llama":
            return llama.LlamaConfig.from_hf(hf, **overrides)
        raise ValueError(f"model_type {cfg.model_type!r} is not ported; "
                         "the port trains llama, qwen3 and qwen3_moe")
    common = dict(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size or 4 * cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads
        or cfg.num_attention_heads,
        head_dim=cfg.head_dim,
        max_position_embeddings=cfg.max_position_embeddings,
        rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.rms_norm_eps,
        tie_word_embeddings=cfg.tie_word_embeddings,
        **overrides,
    )
    if cfg.model_type == "qwen3_moe":
        return qwen3_moe.Qwen3MoEConfig(
            qk_norm=True,
            num_experts=cfg.num_experts,
            num_experts_per_tok=cfg.num_experts_per_tok,
            moe_intermediate_size=cfg.moe_intermediate_size
            or (cfg.intermediate_size or 4 * cfg.hidden_size),
            capacity_factor=cfg.moe_capacity_factor,
            moe_dispatch=cfg.moe_dispatch,
            mlp_only_layers=tuple(
                i for i in (cfg.mlp_only_layers or ()) if i >= 0),
            decoder_sparse_step=cfg.decoder_sparse_step or 1,
            aux_loss_coef=cfg.router_aux_loss_coef,
            z_loss_coef=cfg.router_z_loss_coef,
            **common,
        )
    if cfg.model_type == "qwen3":
        return Qwen3Config(qk_norm=True, **common)
    if cfg.model_type == "llama":
        return llama.LlamaConfig(**common)
    raise ValueError(f"model_type {cfg.model_type!r} is not ported; the "
                     "port trains llama, qwen3 and qwen3_moe")


def build_dataloader(cfg: ScaleTorchTPUArguments, model_cfg,
                     tokenizer: Any = None, fault_injector: Any = None):
    """The synthetic stream (``synthetic_data``, or no ``dataset_name``),
    else ``MicroBatchDataLoader`` over the local file ``dataset_name``
    tokenized by ``tokenizer`` (an object), or by the tokenizer that
    ``tokenizer_name_or_path`` (default: ``model_name_or_path``) names;
    ``fault_injector`` drills its step-batch reads
    (``ft_bad_batch_at_step``). The batches are global: ``dp * ep``
    times ``micro_batch_size`` rows."""
    dp = cfg.data_parallel_size * cfg.expert_parallel_size
    if cfg.synthetic_data or not cfg.dataset_name:
        return SyntheticDataLoader(
            vocab_size=min(model_cfg.vocab_size,
                           cfg.synthetic_vocab_size or model_cfg.vocab_size),
            sequence_length=cfg.sequence_length,
            micro_batch_size=cfg.micro_batch_size,
            gradient_accumulation_steps=cfg.gradient_accumulation_steps,
            data_parallel_size=dp,
            seed=cfg.seed,
        )
    from scaletorch_tpu_torch.data.dataset import (
        DatasetProcessor,
        chunks_to_array,
    )

    tok = (tokenizer if tokenizer is not None
           else cfg.tokenizer_name_or_path or cfg.model_name_or_path)
    if tok is None:
        raise ValueError(
            f"dataset_name {cfg.dataset_name!r} needs a tokenizer: pass "
            "Trainer(tokenizer=...), --tokenizer_name_or_path or "
            "--model_name_or_path")
    proc = DatasetProcessor(tok, cfg.sequence_length, cfg.tokenize_strategy,
                            cfg.dataset_text_key, cfg.num_proc)
    tokens = chunks_to_array(proc.process(cfg.dataset_name))
    return MicroBatchDataLoader(
        tokens,
        micro_batch_size=cfg.micro_batch_size,
        gradient_accumulation_steps=cfg.gradient_accumulation_steps,
        data_parallel_size=dp,
        seed=cfg.seed,
        read_retries=cfg.data_read_retries,
        retry_base_delay=cfg.data_retry_base_delay,
        max_skipped_batches=cfg.data_max_skipped_batches,
        fault_injector=fault_injector,
    )


class Trainer:
    """End-to-end training loop, on one card or over a device mesh."""

    def __init__(self, cfg: ScaleTorchTPUArguments,
                 device: DeviceLike = None, tokenizer: Any = None) -> None:
        self.cfg = cfg
        self.logger = get_logger(log_file=cfg.log_file,
                                 log_format=cfg.log_format)
        # the process group first: everything after may be collective
        device = resolve_device(device)
        # spans, the JSONL stream, profiler windows and SIGUSR1 snapshots:
        # every component None (one branch a site) without telemetry_dir;
        # named by the launch rank, and up before the membership records
        self.telemetry = Telemetry.from_config(
            cfg, process_index=stdist.launch_identity(
                cfg.distributed_launcher, cfg.coordinator_address,
                cfg.num_processes, cfg.process_id)[0])
        self._tracer = self.telemetry.tracer
        # with elastic, the membership decides which group to form: a
        # relaunched rank the fleet shed parks here until a grow admits it
        self.elastic: Optional[ElasticCoordinator] = None
        view = self._elastic_membership(device)
        if view is None or view.epoch == 0:
            stdist.init_distributed(
                cfg.distributed_launcher,
                coordinator_address=cfg.coordinator_address,
                num_processes=cfg.num_processes, process_id=cfg.process_id,
                device=device, **self._group_timeout())
        else:
            self._join_epoch_group(view, device)
        self.world = stdist.process_count()
        if device.type == "cuda" and self.world > 1:
            device = torch.device("cuda", stdist.local_rank())
        self.device = device
        self._group_epoch = 0 if view is None else view.epoch
        if not stdist.is_main_process():
            self.logger.setLevel(logging.ERROR)
        if cfg.verbose:
            from scaletorch_tpu_torch.utils.env_info import log_system_info

            log_system_info(self.logger)
        if not cfg.donate_params:
            raise NotImplementedError(
                "donate_params false: the port always updates parameters "
                "and optimizer state in place")
        self.mesh_kwargs = self._epoch_mesh_kwargs(view)
        if self.elastic is None:
            cfg.validate_world_size(self.world)
        self.mm = setup_mesh_manager(**self.mesh_kwargs,
                                     device_type=self.device.type)
        if self.mm.world_size != self.world:
            raise ElasticRemeshError(
                f"membership epoch {view.epoch} has {self.world} processes "
                f"but the mesh {self.mesh_kwargs} needs {self.mm.world_size}")
        self._make_groups()
        self._mesh_epoch = self._group_epoch
        self.model_cfg = build_model_config(cfg)
        self.pp_vpp = self._resolve_virtual_stages()
        self.attention_backend = self._resolve_attention_backend()
        if cfg.tensor_parallel_size > 1:
            validate_tp_divisibility(self.model_cfg, cfg.tensor_parallel_size)
        torch.manual_seed(cfg.seed)
        self.is_moe = isinstance(self.model_cfg, qwen3_moe.Qwen3MoEConfig)
        if self.is_moe and cfg.expert_parallel_size > 1:
            validate_ep_divisibility(self.model_cfg, cfg.expert_parallel_size)
        model = qwen3_moe if self.is_moe else llama
        # a rank keeps a part of the parameters when a model axis splits
        tp_shard = self.mm.tp * self.mm.pp * self.mm.ep > 1
        # the stacked layer axis before its pp split: uneven padding or
        # the interleave order (the reference Trainer's order)
        self.layer_layout = stage_layer_layout(
            self.model_cfg.num_hidden_layers, self.mm.pp, cfg.pp_engine,
            self.pp_vpp)
        if cfg.load_pretrained_weights:
            if not cfg.model_name_or_path:
                raise ValueError(
                    "load_pretrained_weights requires model_name_or_path")
            from scaletorch_tpu_torch.utils.hf_interop import load_hf_params

            self.params = load_hf_params(cfg.model_name_or_path,
                                         self.model_cfg, device=self.device)
            if tp_shard:
                self.params = shard_numpy_params(
                    self.params, self.model_cfg, self.mm, self.mm.rank,
                    layout=self.layer_layout)
            for leaf in tree_leaves(self.params):
                leaf.requires_grad_(True)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(cfg.seed)
            shard = ({"local_slice": local_shard_fn(
                self.model_cfg, self.mm, self.mm.rank,
                layout=self.layer_layout)} if tp_shard else {})
            self.params = model.init_params(
                self.model_cfg, gen, self.device, requires_grad=True,
                **shard)
        # Adafactor's statistics reduce over the split dims of each shard
        # (the reference passes its param specs and mesh sizes)
        self.optimizer, self.schedule = create_optimizer(
            cfg, shard_dims=shard_dims(self.model_cfg), mesh=self.mm)
        self.opt_state = self.optimizer.init(self.params)
        self.tokenizer = tokenizer
        # host-side resilience, built before the loader so its corrupt-read
        # drill binds the same injector; the device-side half is the
        # train step's guarded_update
        self.resilience = ResilienceManager.from_config(cfg)
        if self.elastic is not None:
            # the drills target a launch rank, whatever the epoch's rank
            self.resilience.injector.host_index = self.elastic.rank
        self.coordinator = CoordinatedResilience.from_config(
            cfg, self.resilience, bus=self._epoch_bus())
        self._watchdog: Optional[HangWatchdog] = None
        self.loader = build_dataloader(cfg, self.model_cfg, tokenizer,
                                       fault_injector=self.resilience.injector)
        self._set_loader_dp()
        self.step_fn = self._make_step_fn()
        # the whole model's count, whatever this rank holds
        self.num_params = (self.model_cfg.num_params() if tp_shard
                           else get_num_params(self.params))
        # MoE MFU counts the parameters a token touches (the reference's
        # active-parameter MFU)
        self.mfu_params = (self.model_cfg.num_active_params() if self.is_moe
                           else self.num_params)
        self.metrics = MetricsLogger(
            num_params=self.mfu_params,
            num_layers=self.model_cfg.num_hidden_layers,
            num_heads=self.model_cfg.num_attention_heads,
            head_dim=self.model_cfg.actual_head_dim,
            seq_len=cfg.sequence_length,
            tokens_per_step=self.loader.tokens_per_step,
            log_frequency=cfg.log_frequency,
            peak_flops=self.peak_flops(),
            device=self.device,
        )
        self.metrics.exporter = self.telemetry.exporter
        if cfg.straggler_factor and self.coordinator.coordinated:
            # a fleet to compare: the per-process step and data-fetch
            # times ride the decision gather, reduced on rank 0
            self.coordinator.straggler = StragglerDetector(
                factor=cfg.straggler_factor,
                patience=cfg.straggler_patience,
                log_frequency=cfg.log_frequency,
                tracer=self._tracer)
        self._last_data_fetch_s = 0.0
        if self.telemetry.snapshotter is not None:
            # armed now, not in train(): SIGUSR1's default disposition
            # would end the run during set-up; close() uninstalls it
            self.telemetry.snapshotter.install(self._live_snapshot)
        self.global_step = 0
        self.tokens_seen = 0
        self.preempted = False
        # wall-clock marks of each elastic transition (a lost peer, an
        # adopted epoch's restore), read by the drills
        self.elastic_timeline: list = []
        self._spurious_remeshes: Dict[int, int] = {}
        self.emergency_checkpoint_saved = False
        # seconds of the last emergency checkpoint: the drain of a save in
        # flight, the save's blocking snapshot, the wait for its write
        self.emergency_timing: Dict[str, float] = {}
        # the stream position minus global_step, for a loader that does
        # not count its own position: a rollback moves global_step back
        # while the stream moves past the bad region, and every later
        # checkpoint must keep that skew; the position the newest
        # checkpoint stores tells the emergency save whether the
        # checkpoint at this step is stale
        self._loader_skew = 0
        self._saved_loader_position: Optional[int] = None
        self._train_iter = None
        self._ckpt_mgr = None
        self._eval_fn = None
        self._eval_loader = None
        self._eval_batches: Optional[list] = None
        self._eval_iter = None
        if cfg.eval_frequency:
            self._eval_fn = make_spmd_eval_step(
                self.mm, self.model_cfg,
                attention_backend=self.attention_backend,
                sequence_parallel=cfg.sequence_parallel,
                cp_layout=cfg.cp_layout, pp_engine=cfg.pp_engine,
                pp_vpp=self.pp_vpp)
            self._eval_loader = self._build_eval_loader()
        self._wandb: Any = None
        self._wandb_logged_step = 0
        if cfg.wandb_project and stdist.is_main_process():
            try:
                import wandb

                self._wandb = wandb.init(project=cfg.wandb_project,
                                         name=cfg.wandb_run_name,
                                         config=dataclasses.asdict(cfg))
            except Exception as exc:  # wandb is not installed
                self.logger.warning(
                    f"wandb requested but unavailable: {exc!r}")
        self.logger.info(
            f"model {cfg.model_type}: "
            f"{to_readable_format(self.num_params)} params, "
            f"attention {self.attention_backend}, device {self.device}, "
            f"seq {cfg.sequence_length}, micro_bs {cfg.micro_batch_size}, "
            f"grad_accum {cfg.gradient_accumulation_steps}, "
            f"gc {cfg.gradient_checkpointing}, "
            f"data {cfg.dataset_name or 'synthetic'}")
        # a rank admitted by a grow restores with the fleet, in train()
        if (cfg.resume != "off" and cfg.checkpoint_dir
                and not (self.elastic is not None
                         and self.elastic.needs_join)):
            self.load_checkpoint(required=cfg.resume == "must")

    @property
    def history(self) -> list:
        """The logged records, oldest first."""
        return self.metrics.history

    def step(self, batch: Optional[Dict[str, np.ndarray]] = None
             ) -> Dict[str, Any]:
        """Run ONE optimizer step on ``batch`` (default: the loader's next
        batch) and return its metrics (0-d device tensors)."""
        self._last_data_fetch_s = 0.0
        if batch is None:
            if self._train_iter is None:
                self._train_iter = iter(self.loader)
            self._beat("data_fetch")
            t_fetch = time.perf_counter()
            batch = next(self._train_iter)
            self._last_data_fetch_s = time.perf_counter() - t_fetch
        dev_batch = self._device_batch(batch)
        self._beat("step_dispatch")
        self.params, self.opt_state, m = self.step_fn(
            self.params, self.opt_state, dev_batch)
        self.global_step += 1
        self.tokens_seen += int(np.prod(np.shape(batch["input_ids"])))
        return m

    # -- processes, membership and the mesh ----------------------------------
    def _launch_rank(self) -> int:
        """This process's rank as the launcher started it (its identity
        across elastic epochs, whose group ranks renumber)."""
        if self.elastic is not None:
            return self.elastic.rank
        return stdist.process_index()

    def _group_timeout(self) -> Dict[str, float]:
        """An elastic run's groups time out at its deadline, so a dead
        peer surfaces as an error in time."""
        if self.elastic is None:
            return {}
        return {"timeout_s": float(self.cfg.elastic_deadline_seconds)}

    def _elastic_membership(self, device: torch.device):
        """With ``elastic``: the coordinator over
        ``<checkpoint_dir>/membership`` and the epoch this process enters
        (a relaunched rank the fleet shed waits here, at the rejoin
        barrier, for a grow epoch that admits it). None without."""
        cfg = self.cfg
        if not cfg.elastic:
            return None
        rank, world = stdist.launch_identity(
            cfg.distributed_launcher, cfg.coordinator_address,
            cfg.num_processes, cfg.process_id)
        self.elastic = ElasticCoordinator.from_config(
            cfg, rank=rank, num_hosts=world,
            bus_factory=lambda view, rank: DecisionBus.default(
                self.mm.host_group()),
            exporter=self.telemetry.exporter,
            relaunched=stdist.restart_count() > 0,
            # a survivor blocked on the lost peer itself learns of the loss
            # only at the group's timeout (the deadline), up to one
            # deadline after the others: the roll call spans that
            suspect_seconds=2 * float(cfg.elastic_deadline_seconds))
        self._fleet_hosts = world
        if not stdist.can_reform_in_process(
                "nccl" if device.type == "cuda" else "gloo"):
            # only a group re-formed in place admits a parked rank: here
            # a parked rank gives up at once, for the fleet restart
            self.elastic.join_timeout = 0.0
        if self.elastic.parked:
            self.logger.warning(
                f"rank {rank}: the fleet is at membership epoch "
                f"{self.elastic.view.epoch} without this rank; parking at "
                "the rejoin barrier")
            self.elastic.join(step=None)
        return self.elastic.view

    def _join_epoch_group(self, view, device: torch.device) -> None:
        """Form the default group of membership epoch ``view`` at its
        rendezvous (every member calls this for the same epoch)."""
        store = self.elastic.store
        stdist.join_process_group(
            store.rendezvous(view.epoch), view.num_hosts,
            view.bus_index(self.elastic.rank), device=device,
            **self._group_timeout())
        self._group_epoch = view.epoch

    def _make_groups(self) -> None:
        """The mesh's host-side gloo groups, made by every rank in one
        order right after the mesh: the decision bus's, and the
        checkpoint's own (its writer thread uses it alone)."""
        if self.mm.mesh is not None:
            self.mm.host_group()
            if self.cfg.checkpoint_dir:
                self.mm.checkpoint_group()

    def _epoch_mesh_kwargs(self, view) -> Dict[str, int]:
        """The mesh of this epoch: the config's, its dp scaled by the
        membership (``elastic_mesh_kwargs``; an unshrinkable geometry
        raises ``ElasticRemeshError``)."""
        kwargs = self.cfg.mesh_kwargs()
        if self.elastic is None:
            return kwargs
        try:
            return elastic_mesh_kwargs(kwargs, hosts_before=self._fleet_hosts,
                                       hosts_after=view.num_hosts)
        except MeshShrinkError as exc:
            raise ElasticRemeshError(str(exc)) from exc

    def _epoch_bus(self) -> Optional[DecisionBus]:
        """The decision bus over this epoch's processes (a gloo group),
        transport failures raised as ``PeerLostError`` under elastic;
        None for one process."""
        if self.elastic is not None:
            return self.elastic.bus
        if self.world == 1:
            return None
        return DecisionBus.default(self.mm.host_group())

    def _set_loader_dp(self) -> None:
        """The loader's dp degree for this mesh (an elastic epoch's)."""
        dp = self.mesh_kwargs["dp"] * self.cfg.expert_parallel_size
        if (hasattr(self.loader, "set_data_parallel_size")
                and self.loader.dp != dp):
            self.loader.set_data_parallel_size(dp)

    def _make_step_fn(self):
        cfg = self.cfg
        return make_spmd_train_step(
            self.mm, self.model_cfg, self.optimizer,
            attention_backend=self.attention_backend,
            gradient_checkpointing=cfg.gradient_checkpointing,
            remat_policy=cfg.remat_policy,
            sequence_parallel=cfg.sequence_parallel,
            max_grad_norm=cfg.max_grad_norm,
            cp_layout=cfg.cp_layout,
            pp_engine=cfg.pp_engine,
            pp_vpp=self.pp_vpp,
            grad_allreduce_dtype=cfg.grad_allreduce_dtype,
            grad_allreduce_axis=cfg.grad_allreduce_axis,
            grad_allreduce_block_size=cfg.grad_allreduce_block_size,
        )

    def _stacked_layout(self) -> Dict[str, Any]:
        """How the stacked layer axis lies in the parameters (the
        checkpoint records it): the model's order, or the pp padding or
        interleave order a checkpoint must be restored at."""
        if self.layer_layout is None:
            return {"stacked": "plain"}
        return {"stacked": self.cfg.pp_engine, "pp": self.mm.pp,
                "vpp": self.pp_vpp,
                "layers": self.model_cfg.num_hidden_layers}

    def _agree_all(self, flag: bool) -> bool:
        """True iff every process holds True (the identity for one): a
        branch whose arms run different collectives is taken from an
        agreed flag, never from one process's view."""
        if self.coordinator.coordinated:
            return self.coordinator.bus.agree_all(flag)
        return bool(flag)

    def _agree_any(self, flag: bool) -> bool:
        if self.coordinator.coordinated:
            return self.coordinator.bus.agree_any(flag)
        return bool(flag)

    def peak_flops(self) -> Optional[float]:
        """The dense peak of every card of the run together, for MFU per
        card (raises for a card without an entry); None on the CPU."""
        if self.device.type != "cuda":
            return None
        return self.world * get_theoretical_flops(
            torch.cuda.get_device_name(self.device))

    def _resolve_virtual_stages(self) -> int:
        """``pp_virtual_stages``, its 0 (auto) resolved by
        ``suggest_virtual_stages`` into this attribute, never into the
        config (the reference's rule)."""
        cfg = self.cfg
        vpp = cfg.pp_virtual_stages
        if (cfg.pipeline_parallel_size > 1 and cfg.pp_engine == "interleaved"
                and vpp == 0):
            layers = self.model_cfg.num_hidden_layers
            pp = cfg.pipeline_parallel_size
            vpp = suggest_virtual_stages(layers, pp)
            if vpp < 2:
                if layers % pp:
                    raise ValueError(
                        f"pp_engine='interleaved' cannot apply: "
                        f"num_hidden_layers={layers} is not divisible by "
                        f"pp={pp} (no pp_virtual_stages value can fix this); "
                        "use pp_engine='afab', which pads uneven layer "
                        "counts")
                raise ValueError(
                    f"pp_virtual_stages=0 (auto) found no virtual-stage "
                    f"count: per-rank layer count {layers // pp} has no "
                    "divisor in [2, 4]; set pp_virtual_stages explicitly "
                    "or use pp_engine='afab'")
            self.logger.info(f"pp_virtual_stages auto-selected: {vpp}")
        return vpp

    def _resolve_attention_backend(self) -> str:
        """The attention backend, as the reference's ``__init__`` settles
        it: under cp, 'auto' asks ``resolve_cp_backend`` (the host of
        every rank gives the ring's host hops) and an explicit backend
        must be 'ring' or 'ulysses'; sets ``_zigzag_cp`` (the batch is
        permuted for the zigzag ring)."""
        cfg = self.cfg
        cp = cfg.context_parallel_size
        if cp > 1 and cfg.attention_backend == "auto":
            choice = resolve_cp_backend(
                "auto", self.mm, cp=cp,
                num_q_heads=self.model_cfg.num_attention_heads,
                num_kv_heads=self.model_cfg.num_key_value_heads,
                seq_len=cfg.sequence_length,
                hosts=stdist.all_gather_object(socket.gethostname()),
                layout=cfg.cp_layout)
            backend = choice.backend
            self.logger.info(f"cp backend auto-selected: {choice.backend} "
                             f"(layout {choice.layout}): {choice.reason}")
        else:
            backend = resolve_attention_backend(cfg.attention_backend,
                                                context_parallel=cp > 1)
        if cp > 1 and backend not in ("ring", "ulysses"):
            # a full-sequence backend on cp shards would compute
            # block-diagonal attention
            raise ValueError(
                f"context_parallel_size={cp} requires a CP-aware attention "
                f"backend ('ring' or 'ulysses'), got {backend!r}")
        self._zigzag_cp = (cp > 1 and cfg.cp_layout == "zigzag"
                           and backend == "ring")
        if self._zigzag_cp and cfg.sequence_length % (2 * cp):
            raise ValueError(
                f"cp_layout='zigzag' needs sequence_length "
                f"{cfg.sequence_length} divisible by 2*cp ({2 * cp}); use "
                "cp_layout='contiguous' for odd stripe splits")
        if cp > 1 and cfg.cp_layout == "zigzag" and backend == "ulysses":
            self.logger.info(
                "cp_layout='zigzag' has no effect with the ulysses backend "
                "(head ownership balances causal work); using the "
                "contiguous sequence layout")
        return backend

    def _device_batch(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
        """This rank's part of a global host batch, on the device."""
        if self.world > 1:
            batch = local_batch(batch, self.mm, zigzag=self._zigzag_cp)
        return device_batch(batch, self.device)

    # -- evaluation -----------------------------------------------------------
    def _build_eval_loader(self):
        """``eval_dataset_name`` when given; a synthetic stream of another
        seed for a synthetic run; else None (eval skipped, with a
        warning: the concat-chunk stream has no held-out split)."""
        cfg = self.cfg
        if cfg.eval_dataset_name:
            eval_cfg = dataclasses.replace(
                cfg, dataset_name=cfg.eval_dataset_name, synthetic_data=False)
            return build_dataloader(eval_cfg, self.model_cfg, self.tokenizer)
        if cfg.synthetic_data or not cfg.dataset_name:
            eval_cfg = dataclasses.replace(cfg, seed=cfg.seed + 104729)
            return build_dataloader(eval_cfg, self.model_cfg)
        self.logger.warning(
            "eval_frequency set but no eval_dataset_name; validation skipped")
        return None

    def evaluate(self, num_batches: Optional[int] = None) -> Optional[float]:
        """Mean validation loss over a FIXED set of ``num_batches``
        (default ``eval_steps``) batches, drawn once and cached; a larger
        request extends the set from the same live iterator, so earlier
        readings keep scoring the same data."""
        if self._eval_fn is None or self._eval_loader is None:
            return None
        num_batches = num_batches or self.cfg.eval_steps
        if self._eval_batches is None:
            self._eval_batches = []
        if len(self._eval_batches) < num_batches:
            if self._eval_iter is None:
                self._eval_iter = iter(self._eval_loader)
            self._eval_batches.extend(
                next(self._eval_iter)
                for _ in range(num_batches - len(self._eval_batches)))
        total = 0.0
        for batch in self._eval_batches[:num_batches]:
            total += float(self._eval_fn(self.params,
                                         self._device_batch(batch)))
        return total / max(num_batches, 1)

    # -- checkpoints ----------------------------------------------------------
    @property
    def checkpoint_manager(self):
        if self._ckpt_mgr is None:
            from scaletorch_tpu_torch.utils.checkpoint import (
                CheckpointManager,
            )

            if not self.cfg.checkpoint_dir:
                raise ValueError("checkpoints need --checkpoint_dir")
            # with a process group: global tensors of this mesh's layout,
            # DCP over the checkpoint's own gloo group; over processes
            # every decision agreed on the epoch's bus
            pg = self.mm.mesh is not None
            self._ckpt_mgr = CheckpointManager(
                self.cfg.checkpoint_dir,
                keep_n=self.cfg.keep_n_checkpoints,
                async_save=self.cfg.async_checkpointing,
                retries=self.cfg.checkpoint_retries,
                retry_base_delay=self.cfg.checkpoint_retry_base_delay,
                fault_injector=self.resilience.injector,
                verify=self.cfg.checkpoint_verify,
                decision_bus=self._epoch_bus() if self.world > 1 else None,
                mesh=self.mm,
                split_dims=shard_dims(self.model_cfg),
                group=self.mm.checkpoint_group() if pg else None,
                layout=self._stacked_layout(),
            )
        return self._ckpt_mgr

    def _stream_position(self) -> int:
        """The stream position covered so far: the loader's own (it counts
        skipped regions too), else ``global_step`` plus the skew that a
        restore or a rollback set."""
        position = getattr(self.loader, "position", None)
        if position is None:
            return self.global_step + self._loader_skew
        return position

    def save_checkpoint(self) -> bool:
        """Save the parameters, the optimizer state and the counters
        (``tokens_seen``, the loader's ``loader_position`` and its
        ``samples_per_step``) at ``global_step``."""
        self._beat("checkpoint")
        position = self._stream_position()
        with self._span("checkpoint_save", step=self.global_step):
            saved = self.checkpoint_manager.save(
                step=self.global_step, params=self.params,
                opt_state=self.opt_state,
                extra={"tokens_seen": self.tokens_seen,
                       "loader_position": position,
                       "samples_per_step": getattr(
                           self.loader, "samples_per_step", None)})
        if saved:
            self._saved_loader_position = position
        return saved

    def load_checkpoint(self, required: bool = False,
                        target_mesh: Any = None) -> bool:
        """Restore the newest readable checkpoint in place; returns
        whether one was restored. ``required`` (``--resume must``) raises
        when none restores. The loader is fast-forwarded to the saved
        ``loader_position`` (translated if the step size changed, as after
        an elastic dp change; ahead of the step after a rollback) and the
        live iterator dropped. ``target_mesh``: the mesh the live shards
        lie on, when it changed since the manager was made."""
        restored = self.checkpoint_manager.load_latest(
            params=self.params, opt_state=self.opt_state,
            target_mesh=target_mesh)
        if restored is None:
            if required:
                raise FileNotFoundError(
                    f"--resume must: no restorable checkpoint in "
                    f"{self.cfg.checkpoint_dir}")
            self.logger.warning(
                f"resume requested but no checkpoint found in "
                f"{self.cfg.checkpoint_dir}; training from step 0")
            return False
        extra = restored["extra"]
        self.global_step = restored["step"]
        self.tokens_seen = extra.get("tokens_seen", 0)
        position = extra.get("loader_position", self.global_step)
        saved_spp = extra.get("samples_per_step")
        cur_spp = getattr(self.loader, "samples_per_step", None)
        if saved_spp and cur_spp and int(saved_spp) != int(cur_spp):
            position = remap_loader_position(
                position, old_samples_per_step=int(saved_spp),
                new_samples_per_step=int(cur_spp))
        self._loader_skew = position - self.global_step
        self._saved_loader_position = position
        if hasattr(self.loader, "set_state"):
            self.loader.set_state(position)
        self._train_iter = None
        self.logger.info(f"resumed from step {self.global_step}")
        return True

    def _rollback_to_last_good(self, anomaly_step: int) -> bool:
        """The sentinel's rollback: drain any save in flight (it would
        otherwise land after the restore as a stale newest checkpoint),
        restore the newest checkpoint in place (every parameter and state
        tensor keeps its storage) and fast-forward the stream PAST the
        anomalous batch, keeping the skew for later checkpoints. False
        (the caller skips instead) without a restorable checkpoint."""
        if not self.cfg.checkpoint_dir:
            return False
        self.checkpoint_manager.wait()
        # agreed before any process can return early: either every
        # process restores or every process skips
        if not self._agree_all(
                self.checkpoint_manager.latest_step() is not None):
            return False
        self.logger.warning(
            f"divergence at step {anomaly_step}: rolling back to the last "
            "good checkpoint and fast-forwarding the data stream")
        # the anomalous batch's true position, before the restore
        # overwrites the skew from the checkpoint
        bad_position = self._stream_position()
        if not self.load_checkpoint():
            return False
        self._loader_skew = bad_position - self.global_step
        if hasattr(self.loader, "set_state"):
            self.loader.set_state(bad_position)
            self._train_iter = None
        return True

    def _emergency_checkpoint(self) -> bool:
        """Preemption: persist the state at this step boundary and return
        whether this step's state is on disk (also kept as
        ``emergency_checkpoint_saved``). It drains a save in flight first,
        then saves and waits for the write; ``emergency_timing`` keeps
        the seconds of each part."""
        sig = (self.resilience.preemption.signum
               if self.resilience.preemption is not None else None)
        self.emergency_timing = {}
        if not self.cfg.checkpoint_dir:
            self.logger.warning(
                f"preemption requested (signal {sig}) but no "
                "checkpoint_dir is configured: exiting without a "
                "checkpoint")
            self.emergency_checkpoint_saved = False
            return False
        self.coordinator.verify_agreement(
            "emergency_checkpoint_step", self.global_step)
        self._beat("emergency_checkpoint")
        mgr = self.checkpoint_manager
        t0 = time.perf_counter()
        mgr.wait()
        drained = time.perf_counter()
        self.emergency_timing["drain_s"] = drained - t0
        # every branch below is taken from an agreed flag, so all
        # processes run the same collectives
        if self._agree_any(mgr.latest_step() == self.global_step):
            if self._agree_all(
                    mgr.latest_step() == self.global_step
                    and self._saved_loader_position
                    == self._stream_position()):
                # the cadence already saved this very state
                self.logger.warning(
                    f"preemption requested (signal {sig}): step "
                    f"{self.global_step} is already checkpointed; exiting")
                self.emergency_checkpoint_saved = True
                return True
            # same step, stale loader position (a rollback moved the
            # stream after it was saved): replace it, rank 0 alone on the
            # shared directory, seen by every process before the save
            if stdist.is_main_process():
                try:
                    mgr.delete(self.global_step)
                except OSError as exc:
                    self.logger.error(
                        f"could not replace stale checkpoint at step "
                        f"{self.global_step}: {exc!r}")
            self._agree_all(True)
        self.logger.warning(
            f"preemption requested (signal {sig}): writing emergency "
            f"checkpoint at step {self.global_step}")
        saved = self.save_checkpoint()
        saved_at = time.perf_counter()
        saved = mgr.wait() and saved
        self.emergency_timing.update(
            blocking_s=saved_at - drained,
            write_s=time.perf_counter() - saved_at,
            total_s=time.perf_counter() - t0)
        # the directory is the ground truth of "is my step on disk", and
        # the verdict is the fleet's
        saved = self._agree_all(saved and mgr.latest_step()
                                == self.global_step)
        self.emergency_checkpoint_saved = saved
        return saved

    # -- liveness, spans and post-mortems -------------------------------------
    def _beat(self, phase: str) -> None:
        """Feed the hang watchdog and the tracer's phase track: liveness
        and tracing share one phase vocabulary (step_boundary /
        data_fetch / step_dispatch / checkpoint / emergency_checkpoint).
        One branch each when neither is armed."""
        if self._watchdog is not None:
            self._watchdog.beat(self.global_step, phase)
        if self._tracer is not None:
            self._tracer.phase(phase, step=self.global_step)

    def _span(self, name: str, **args):
        """A telemetry span when a tracer is attached, the shared no-op
        otherwise."""
        if self._tracer is None:
            return NOOP_SPAN
        return self._tracer.span(name, **args)

    def _write_crash_report(self, reason: str, thread_stacks=None) -> str:
        return write_crash_report(
            reason,
            self.global_step,
            directory=self.cfg.crash_report_dir,
            config=self.cfg,
            monitor_records=self.metrics.ring_buffer(),
            last_metrics=self.metrics.history[-5:],
            counters=self.resilience.counters(),
            thread_stacks=thread_stacks,
            span_tail=self.telemetry.span_tail(),
            process_index=self._launch_rank(),
        )

    def _live_snapshot(self) -> Dict[str, Any]:
        """The SIGUSR1 payload: what a crash report carries, from a live
        run. Host-side state only (the handler may run right after a
        blocking CUDA wait and must not touch a tensor)."""
        return {
            "step": self.global_step,
            "tokens_seen": self.tokens_seen,
            "span_tail": self.telemetry.span_tail(),
            "monitor_records": self.metrics.ring_buffer(64),
            "last_metrics": self.metrics.history[-5:],
            "counters": {**self.resilience.counters(),
                         **self.coordinator.straggler_counters()},
        }

    def _watchdog_crash_report(self, info: dict) -> str:
        """The HangWatchdog's callback: the post-mortem before the exit."""
        return self._write_crash_report(
            info["reason"], thread_stacks=info.get("thread_stacks"))

    # a hook of its own so tests can record the exit; os._exit, since a
    # SystemExit raised on the watchdog's thread would not end a wedged run
    _watchdog_exit = staticmethod(os._exit)

    def export_hf(self, path: str, dtype: str = "bfloat16",
                  max_shard_bytes: int = 5 * 1024 ** 3) -> str:
        """Write the parameters as a HF checkpoint directory: safetensors
        (``save_hf_params``) and its ``config.json``. Returns the
        safetensors file's path, or the index's when sharded ('' off rank
        0). Parameters split over tp, pp or ep are gathered to rank 0 leaf
        by leaf (``save_hf_params_sharded``; every rank calls this): the
        files are a one-card export's."""
        from scaletorch_tpu_torch.parallel.pipeline_parallel import (
            stage_layer_unlayout,
        )
        from scaletorch_tpu_torch.utils.hf_interop import (
            hf_config_dict,
            save_hf_params,
            save_hf_params_sharded,
        )

        if self.mm.tp * self.mm.pp * self.mm.ep > 1:
            out = save_hf_params_sharded(
                path, self.params, self.model_cfg, self.mm,
                group=self.mm.host_group(),
                unlayout=stage_layer_unlayout(
                    self.model_cfg.num_hidden_layers, self.mm.pp,
                    self.cfg.pp_engine, self.pp_vpp),
                dtype=dtype, max_shard_bytes=max_shard_bytes)
        elif stdist.is_main_process():
            out = save_hf_params(path, self.params, self.model_cfg,
                                 dtype=dtype, max_shard_bytes=max_shard_bytes)
        else:
            return ""
        if not stdist.is_main_process():
            return ""
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(hf_config_dict(self.model_cfg, dtype), f, indent=2)
        self.logger.info(f"HF weights written to {path}")
        return out

    # -- the loop -------------------------------------------------------------
    def train(self, num_steps: Optional[int] = None) -> Dict[str, Any]:
        """Run ``num_steps`` more steps (default: up to
        ``total_train_steps``, so a resumed run ends where an
        uninterrupted one would) and return the last logged record (with
        ``val_loss`` on an eval step).

        At each step boundary a preemption request (SIGTERM or SIGINT
        under ``handle_preemption``) writes an emergency checkpoint and
        returns with ``preempted`` set; after each step the divergence
        sentinel applies its policy (skip, rollback to the last good
        checkpoint, abort with a crash report and
        ``TrainingDivergedError``)."""
        cfg = self.cfg
        target = (max(cfg.total_train_steps, self.global_step)
                  if num_steps is None else self.global_step + num_steps)
        last: Dict[str, Any] = {}
        self.preempted = False
        if cfg.handle_preemption:
            self.resilience.install_preemption_handler()
        hang_timeout = hang_timeout_from_config(cfg)
        if hang_timeout > 0 and self._watchdog is None:
            self._watchdog = HangWatchdog(
                hang_timeout, crash_report=self._watchdog_crash_report,
                exit_fn=self._watchdog_exit).start()
        if self.telemetry.snapshotter is not None:
            self.telemetry.snapshotter.install(self._live_snapshot)
        profiler = self.telemetry.profiler
        self.metrics.start_window(self.global_step)
        try:
            # the remesh-and-resume loop: a lost peer (a process died or
            # hung past the deadline: a step's, a save's or a restore's
            # collective failed in its transport) makes the survivors
            # agree a new membership epoch, restore onto it and go on to
            # the same target; without elastic it propagates
            lost: Optional[PeerLostError] = None
            while True:
                try:
                    if lost is not None:
                        exc, lost = lost, None
                        self._elastic_recover(exc)
                    elif self.elastic is not None and self.elastic.needs_join:
                        # a rank admitted by a grow: restore the fleet's
                        # checkpoint with the fleet before entering
                        # lockstep
                        self._elastic_join()
                    last = self._train_until(target, profiler, last)
                    break
                except Exception as exc:
                    if self.elastic is None or not is_transport_error(exc):
                        raise
                    if (self._spurious_remeshes.get(self.global_step, 0)
                            >= MAX_SPURIOUS_REMESHES):
                        # every member answered each roll call at this
                        # step: not a lost peer but a fault of its own (a
                        # deterministic error in a collective), raised as
                        # itself
                        raise (exc.__cause__ if isinstance(
                            exc, PeerLostError) and exc.__cause__
                            else exc) from None
                    if isinstance(exc, PeerLostError):
                        lost = exc
                    else:
                        lost = PeerLostError(f"collective failed: {exc!r}")
                        lost.__cause__ = exc
        except TrainingDivergedError as exc:
            # every abort path leaves a post-mortem on disk
            self._write_crash_report(str(exc))
            raise
        finally:
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None
            self.resilience.uninstall_preemption_handler()
            if profiler is not None:
                profiler.close()
            # the SIGUSR1 handler stays armed until close(); train() may
            # be called again, so the tracer stays open
            if self._tracer is not None:
                self._tracer.end_phase()
            self.telemetry.flush()
        if self._ckpt_mgr is not None:
            self._ckpt_mgr.wait()  # the last async save is on disk
        if cfg.performance_log_dir and stdist.is_main_process():
            path = self.metrics.save_json(os.path.join(
                cfg.performance_log_dir,
                f"performance_log_step{self.global_step}.json"))
            self.logger.info(f"performance log written to {path}")
        return last

    def _train_until(self, target: int, profiler,
                     last: Dict[str, Any]) -> Dict[str, Any]:
        """The inner loop of ``train``: steps up to ``target``, or a
        preemption's emergency checkpoint."""
        cfg = self.cfg
        while self.global_step < target:
            self._beat("step_boundary")
            if self.elastic is not None:
                self.elastic.beat(self.global_step)
            t_boundary = time.perf_counter()
            # the telemetry drill stalls the step about to run, so the
            # slow-step detector fires on exactly that step
            self.resilience.injector.maybe_slow_step(self.global_step + 1)
            if profiler is not None:
                profiler.before_step(self.global_step + 1)
            if self.coordinator.should_stop():
                self._emergency_checkpoint()
                self.preempted = True
                break
            m = self.step()
            step_time = time.perf_counter() - t_boundary
            step = self.global_step
            m, action = self.coordinator.after_step(
                step, m,
                rollback=lambda: self._rollback_to_last_good(step),
                position=self._stream_position(),
                telemetry={"step_time": step_time,
                           "data_fetch_time": self._last_data_fetch_s})
            if profiler is not None:
                profiler.after_step(step, step_time)
            if action == "rollback":
                # global_step is back at the restored checkpoint: the
                # anomalous step's record would be logged against the
                # wrong step
                continue
            record = self.metrics.log_step(
                step, loss=m["loss"],
                # the update just applied used the count before it
                # advanced
                lr=float(self.schedule(step - 1)),
                grad_norm=m["grad_norm"],
                extras={**{k: v for k, v in m.items()
                           if k not in ("loss", "grad_norm")},
                        **self.coordinator.counters(),
                        **self.coordinator.straggler_counters()})
            last = record or last
            if cfg.eval_frequency and step % cfg.eval_frequency == 0:
                val = self.evaluate()
                if val is not None:
                    self.logger.info(
                        f"step {step:>6} | val_loss {val:.4f}")
                    if record:
                        record["val_loss"] = val
                    else:
                        last = {**last, "val_loss": val}
            if (last and self._wandb is not None
                    and step > self._wandb_logged_step):
                # a rollback moves the step back, and wandb drops a step
                # that does not increase: log again once it passes the
                # highest step logged
                self._wandb.log(last, step=step)
                self._wandb_logged_step = step
            if (cfg.save_frequency and cfg.checkpoint_dir
                    and step % cfg.save_frequency == 0):
                self.save_checkpoint()
                # a checkpoint boundary is the only scale-up point: the
                # state a parked rank restores is freshly on disk
                self._maybe_elastic_grow()
        return last

    # -- elastic membership ---------------------------------------------------
    def _elastic_join(self) -> None:
        """A relaunched rank: wait at the rejoin barrier until a grow
        epoch admits it (already done when it was parked at
        construction), then take the restore path the members take at
        that boundary."""
        view = self._elastic_membership_change(self.elastic.join)
        self._elastic_apply_view(view)

    def _elastic_recover(self, exc: BaseException) -> None:
        """A collective broke: the membership recovery (store-based, no
        collective over the broken group), then onto the agreed epoch."""
        self.logger.warning(
            f"elastic recovery at step {self.global_step}: {exc!r}")
        self.elastic_timeline.append({"event": "peer_lost",
                                      "time": time.time(),
                                      "step": self.global_step,
                                      "error": repr(exc)[:300]})
        step, before = self.global_step, self.elastic.view.members
        view = self._elastic_membership_change(
            self.elastic.on_peer_lost, exc=exc)
        if view.members == before:
            # every member answered the roll call: remeshed in place
            self._spurious_remeshes[step] = (
                self._spurious_remeshes.get(step, 0) + 1)
        self._elastic_apply_view(view)

    def _elastic_membership_change(self, change, **kw):
        """``change(step, **kw)``'s view; when the fleet goes on without
        this rank (``ElasticRemeshError``), its process group is left
        without a collective first: a destroy would wait on the peers."""
        try:
            return change(self.global_step, **kw)
        except ElasticRemeshError:
            self._leave_group()
            raise

    def _leave_group(self) -> None:
        """Off the current group without a collective: left in place
        (gloo); an NCCL group stays as it is for the process's end
        (``dist.can_reform_in_process``; ``train.py`` ends the process
        without a teardown that would wait on the lost peer)."""
        if self._ckpt_mgr is not None:
            self._ckpt_mgr.detach()
            self._ckpt_mgr = None
        if stdist.can_reform_in_process():
            self.mm.forget()
            stdist.leave_process_group()

    def _maybe_elastic_grow(self) -> None:
        """At a checkpoint boundary, rank 0 of the epoch reads the rejoin
        mailbox and the decision rides the epoch's bus: every member
        admits the same joiners at the same boundary, or none does."""
        if self.elastic is None:
            return
        self.checkpoint_manager.wait()
        view = self.elastic.maybe_grow(self.global_step)
        if view is not None:
            self._elastic_apply_view(view)

    def _elastic_apply_view(self, view) -> None:
        """Move onto an adopted membership epoch: retire the checkpoint
        manager without a collective, re-form the process group at the
        epoch's rendezvous, rebind the decision bus, rebuild the mesh and
        the step, and restore the newest checkpoint. Every member
        restores, those that lost no step too, so the collectives match
        on every process and what follows is a function of the
        checkpoint alone."""
        if self._ckpt_mgr is not None:
            self._ckpt_mgr.detach()
            self._ckpt_mgr = None
        self._elastic_rebuild_topology(view)
        self.coordinator.rebind_bus(self.elastic.bus)
        if dist.is_initialized():
            # every member enters the restore's collectives together
            stdist.store_barrier(
                f"elastic_restore_e{view.epoch}",
                max(self.elastic.join_timeout,
                    10 * float(self.cfg.elastic_deadline_seconds)))
        self.load_checkpoint(required=True, target_mesh=self.mm)
        self.elastic.pending_bootstrap = False
        self.elastic_timeline.append({"event": "epoch", "time": time.time(),
                                      "step": self.global_step,
                                      "epoch": view.epoch,
                                      "members": list(view.members)})

    def _elastic_rebuild_topology(self, view) -> None:
        """The process group, mesh, step and loader geometry of epoch
        ``view``: dp absorbs the change (``elastic_mesh_kwargs``; an
        unshrinkable geometry raises ``ElasticRemeshError``)."""
        if view.epoch == self._mesh_epoch:
            return  # a rank admitted by this grow built it already
        kwargs = self._epoch_mesh_kwargs(view)
        if view.epoch != self._group_epoch:
            if dist.is_initialized() and not stdist.can_reform_in_process():
                self._leave_group()
                raise ElasticRemeshError(
                    f"membership epoch {view.epoch} needs a new process "
                    "group, and this backend's group cannot be re-formed "
                    "in the process (dist.can_reform_in_process) — falling "
                    "back to a fleet restart")
            self.mm.forget()
            stdist.leave_process_group()
            try:
                self._join_epoch_group(view, self.device)
            except Exception as exc:
                raise ElasticRemeshError(
                    f"rendezvous of membership epoch {view.epoch} failed: "
                    f"{exc!r}") from exc
        self.world = stdist.process_count()
        self.mesh_kwargs = kwargs
        self.mm = setup_mesh_manager(**kwargs, device_type=self.device.type)
        self._make_groups()
        self._mesh_epoch = view.epoch
        self.step_fn = self._make_step_fn()
        if self._eval_fn is not None:
            self._eval_fn = make_spmd_eval_step(
                self.mm, self.model_cfg,
                attention_backend=self.attention_backend,
                sequence_parallel=self.cfg.sequence_parallel,
                cp_layout=self.cfg.cp_layout, pp_engine=self.cfg.pp_engine,
                pp_vpp=self.pp_vpp)
        self._set_loader_dp()
        self.metrics.tokens_per_step = self.loader.tokens_per_step
        self._train_iter = None

    def close(self) -> None:
        """Finish the wandb run and any asynchronous save, release its
        buffers, and close the telemetry (the trace file becomes valid
        JSON here)."""
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
        if self._ckpt_mgr is not None:
            self._ckpt_mgr.close()
            self._ckpt_mgr = None
        self.telemetry.close()
