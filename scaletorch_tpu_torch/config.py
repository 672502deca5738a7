"""Training configuration of the port: the subset of
scaletorch_tpu/config.py that the training slices read.

The dataclasses keep the reference's names, field names and defaults:
``DataArguments`` (the local-file fields), ``ModelArguments`` (its
architecture fields, the MoE fields included, ``model_type``,
``model_name_or_path`` and ``load_pretrained_weights``),
``ParallelArguments`` and ``DistributedArguments`` (whole, with their
validation, ``validate_world_size`` and ``mesh_kwargs``, pipeline and
expert parallelism and the int8 gradient all-reduce included),
``LrSchedulerArguments``,
``OptimizerArguments``, ``TrainingArguments``, ``CheckpointArguments``,
``ResilienceArguments``, ``ServingArguments`` and ``TelemetryArguments``
(whole, with their validation), and the logging fields the port reads. They compose into
``ScaleTorchTPUArguments``. ``parse_args`` is plain ``argparse`` over the
fields (the machine with the card has no ``transformers``, so no
``HfArgumentParser``).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class DataArguments:
    dataset_name: Optional[str] = field(
        default=None,
        metadata={"help": "Local .json/.jsonl file of documents (nothing is "
                          "fetched from a hub)."})
    dataset_text_key: str = field(
        default="text", metadata={"help": "Column holding raw text."})
    tokenizer_name_or_path: Optional[str] = field(
        default=None,
        metadata={"help": "Tokenizer (built with transformers); defaults to "
                          "the model path. Trainer(tokenizer=...) takes a "
                          "tokenizer object instead."})
    sequence_length: int = field(
        default=1024, metadata={"help": "Training sequence length."})
    tokenize_strategy: str = field(
        default="concat_chunk",
        metadata={"help": "Registered tokenize strategy (default "
                          "concat+chunk)."})
    num_proc: int = field(default=4,
                          metadata={"help": "Tokenization shards."})
    synthetic_data: bool = field(
        default=False,
        metadata={"help": "Use a synthetic token stream (benchmarks)."})
    synthetic_vocab_size: Optional[int] = field(
        default=None,
        metadata={"help": "Cap the synthetic stream's sampled token ids "
                          "below the model vocab (default: model vocab)."})
    data_read_retries: int = field(
        default=2,
        metadata={"help": "Retries (exponential backoff) around each "
                          "step-batch read before the region is skipped "
                          "and logged."})
    data_retry_base_delay: float = field(
        default=0.05,
        metadata={"help": "First batch-read retry delay in seconds; "
                          "doubles per attempt."})
    data_max_skipped_batches: int = field(
        default=16,
        metadata={"help": "Abort when more than this many step batches "
                          "stay unreadable after retries. 0 = unlimited."})


@dataclass
class ModelArguments:
    model_name_or_path: Optional[str] = field(
        default=None,
        metadata={"help": "Local HF checkpoint directory: its config.json "
                          "gives the architecture."})
    load_pretrained_weights: bool = field(
        default=False,
        metadata={"help": "Load the HF safetensors weights from "
                          "model_name_or_path (otherwise random init with "
                          "its architecture)."})
    model_type: str = field(
        default="llama", metadata={"help": "llama | qwen3 | qwen3_moe"})
    hidden_size: int = 2048
    intermediate_size: Optional[int] = None
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: Optional[int] = None
    head_dim: Optional[int] = None
    vocab_size: int = 32000
    max_position_embeddings: int = 32768
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    attention_backend: str = field(
        default="auto",
        metadata={"help": "auto | flash | sdpa | ring | ulysses: auto "
                          "resolves like the reference (under cp, "
                          "cp_select's choice; else FLASH_ATTEN -> flash, "
                          "else sdpa); flash, ring and ulysses run the CUDA "
                          "kernels K1-K3."})
    # MoE knobs (qwen3_moe)
    num_experts: int = 8
    num_experts_per_tok: int = 2
    moe_intermediate_size: Optional[int] = None
    moe_capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.001
    router_z_loss_coef: float = 0.0
    moe_dispatch: str = field(
        default="auto",
        metadata={"help": "auto | einsum | index: capacity-dispatch token "
                          "movement; auto picks index (a scatter/gather of "
                          "the moving rows) at every expert count."})
    mlp_only_layers: Optional[List[int]] = field(
        default=None,
        metadata={"help": "qwen3_moe layer indices forced to a dense "
                          "SwiGLU MLP (space-separated; a single -1 clears "
                          "the list)."})
    decoder_sparse_step: Optional[int] = field(
        default=None,
        metadata={"help": "A qwen3_moe layer is sparse only when (idx+1) is "
                          "divisible by this (default 1: every layer)."})


@dataclass
class ParallelArguments:
    data_parallel_size: int = field(default=1, metadata={"help": "DP degree."})
    tensor_parallel_size: int = field(default=1,
                                      metadata={"help": "TP degree."})
    pipeline_parallel_size: int = field(
        default=1, metadata={"help": "PP degree."})
    context_parallel_size: int = field(default=1,
                                       metadata={"help": "CP degree."})
    cp_layout: str = field(
        default="zigzag",
        metadata={"help": "contiguous | zigzag: the CP sequence-shard "
                          "layout. zigzag stripes the sequence so every "
                          "ring rank does equal causal work "
                          "(parallel/zigzag.py)."})
    expert_parallel_size: int = field(
        default=1, metadata={"help": "EP degree."})
    pp_engine: str = field(
        default="afab",
        metadata={"help": "Pipeline schedule: afab | interleaved | "
                          "memory_chunked ('1f1b' is an alias of "
                          "memory_chunked)."})
    pp_virtual_stages: int = field(
        default=1,
        metadata={"help": "Virtual stages per pp rank for "
                          "pp_engine='interleaved' (>= 2, or 0 = auto); 1 "
                          "otherwise."})
    sequence_parallel: bool = field(
        default=False,
        metadata={"help": "Megatron-style SP over the tp axis."})
    num_microbatches: Optional[int] = field(
        default=None,
        metadata={"help": "PP microbatches; defaults to "
                          "gradient_accumulation_steps."})
    grad_allreduce_dtype: str = field(
        default="fp32",
        metadata={"help": "fp32 | bf16 | int8: wire format of the gradient "
                          "mean over grad_allreduce_axis (int8: the "
                          "block-scaled quantized all-reduce)."})
    grad_allreduce_axis: str = field(
        default="dp",
        metadata={"help": "Mesh axis the bf16/int8 gradient mean runs over "
                          "('dp' or 'cp'); the other data axis reduces in "
                          "fp32 first."})
    grad_allreduce_block_size: int = field(
        default=256,
        metadata={"help": "Elements per absmax-scale block for "
                          "grad_allreduce_dtype='int8'."})

    def __post_init__(self) -> None:
        for name in ("data_parallel_size", "tensor_parallel_size",
                     "pipeline_parallel_size", "context_parallel_size",
                     "expert_parallel_size"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"{name} must be >= 1, got {getattr(self, name)}")
        if self.pp_engine not in ("afab", "memory_chunked", "1f1b",
                                  "interleaved"):
            raise ValueError(
                "pp_engine must be 'afab', 'interleaved', 'memory_chunked' "
                f"or the reference-compat alias '1f1b', got "
                f"{self.pp_engine!r}")
        if self.pp_engine == "interleaved":
            if self.pp_virtual_stages < 2 and self.pp_virtual_stages != 0:
                raise ValueError(
                    "pp_engine='interleaved' needs pp_virtual_stages >= 2, "
                    f"or 0 for auto; got {self.pp_virtual_stages}")
        elif self.pp_virtual_stages != 1:
            raise ValueError(
                f"pp_virtual_stages={self.pp_virtual_stages} requires "
                f"pp_engine='interleaved' (got {self.pp_engine!r})")
        if self.pp_engine == "1f1b":
            # the reference's alias: the chunked schedule bounds boundary
            # activations like 1F1B, it is not a faster schedule
            self.pp_engine = "memory_chunked"
            if self.pipeline_parallel_size > 1:
                import warnings

                warnings.warn(
                    "pp_engine='1f1b' selects the memory_chunked schedule: "
                    "it bounds boundary activations at O(pp) like 1F1B but "
                    "is slower than 'afab' (a bubble a chunk). Use "
                    "pp_engine='afab', or 'interleaved' to cut the bubble, "
                    "unless activation memory binds; use 'memory_chunked' "
                    "to silence this warning.",
                    RuntimeWarning, stacklevel=2)
        if self.cp_layout not in ("contiguous", "zigzag"):
            raise ValueError(
                "cp_layout must be 'contiguous' or 'zigzag', got "
                f"{self.cp_layout!r}")
        if self.sequence_parallel and self.tensor_parallel_size == 1:
            raise ValueError(
                "sequence_parallel requires tensor_parallel_size > 1")
        if self.grad_allreduce_dtype not in ("fp32", "bf16", "int8"):
            raise ValueError(
                "grad_allreduce_dtype must be 'fp32', 'bf16' or 'int8', "
                f"got {self.grad_allreduce_dtype!r}")
        if self.grad_allreduce_axis not in ("dp", "cp"):
            raise ValueError(
                "grad_allreduce_axis must be 'dp' or 'cp' (a gradient-mean "
                f"data axis), got {self.grad_allreduce_axis!r}")
        if self.grad_allreduce_block_size < 8:
            raise ValueError(
                "grad_allreduce_block_size must be >= 8, got "
                f"{self.grad_allreduce_block_size}")


@dataclass
class DistributedArguments:
    """Multi-process bootstrap knobs (``dist.init_distributed``). 'auto'
    detects torchrun, SLURM and MPI launchers and stays single-process
    when none is present."""

    distributed_launcher: str = field(
        default="auto",
        metadata={"help": "auto | env | slurm | mpi | none: how to find "
                          "the coordinator."})
    coordinator_address: Optional[str] = field(
        default=None,
        metadata={"help": "host:port of process 0 (env launcher); defaults "
                          "to JAX_COORDINATOR_ADDRESS or "
                          "MASTER_ADDR:MASTER_PORT."})
    num_processes: Optional[int] = field(
        default=None, metadata={"help": "Total process count (env launcher)."})
    process_id: Optional[int] = field(
        default=None, metadata={"help": "This process's rank (env launcher)."})

    def __post_init__(self) -> None:
        if self.distributed_launcher not in ("auto", "env", "slurm", "mpi",
                                             "none"):
            raise ValueError(
                "distributed_launcher must be auto|env|slurm|mpi|none, got "
                f"{self.distributed_launcher!r}")


@dataclass
class LrSchedulerArguments:
    lr_scheduler_type: str = field(
        default="cosine",
        metadata={"help": "linear | cosine | polynomial | step | onecycle | "
                          "constant"})
    warmup_steps: int = 0
    warmup_ratio: float = 0.0
    min_lr_ratio: float = 0.1
    step_size: int = 1000          # for 'step'
    step_gamma: float = 0.9        # for 'step'
    poly_power: float = 1.0        # for 'polynomial'


@dataclass
class OptimizerArguments:
    optimizer_name: str = field(
        default="adamw",
        metadata={"help": "adamw | adam | sgd | lamb | adafactor"})
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    momentum: float = 0.9  # sgd


@dataclass
class TrainingArguments:
    micro_batch_size: int = 1
    gradient_accumulation_steps: int = 1
    eval_frequency: int = field(
        default=0,
        metadata={"help": "Run validation every N optimizer steps (0 = "
                          "off)."})
    eval_steps: int = field(
        default=8, metadata={"help": "Validation batches per evaluation."})
    eval_dataset_name: Optional[str] = None
    global_batch_size: Optional[int] = field(
        default=None,
        metadata={"help": "If set, must equal data_parallel_size * "
                          "expert_parallel_size * micro_batch_size * "
                          "grad_accum."})
    total_train_steps: int = 100
    seed: int = 42
    dtype: str = field(default="bfloat16",
                       metadata={"help": "bfloat16|float32"})
    param_dtype: str = field(
        default="float32",
        metadata={"help": "Master-weight dtype (float32|bfloat16); the "
                          "optimizer state takes it too."})
    gradient_checkpointing: bool = field(
        default=False, metadata={"help": "Recompute each decoder layer in "
                                         "the backward."})
    remat_policy: str = field(
        default="nothing_saveable",
        metadata={"help": "GC policy: nothing_saveable | dots_saveable | "
                          "dots_with_no_batch_dims_saveable | save_attn."})
    donate_params: bool = field(
        default=True,
        metadata={"help": "The port always updates parameters and "
                          "optimizer state in place; false is refused."})


@dataclass
class CheckpointArguments:
    checkpoint_dir: Optional[str] = None
    save_frequency: int = 0
    resume_from_checkpoint: bool = False
    resume: str = field(
        default="off",
        metadata={"help": "off | auto | must: 'auto' resumes from the "
                          "latest checkpoint in checkpoint_dir when one "
                          "exists and starts at step 0 otherwise; "
                          "'must' fails when none restores; "
                          "resume_from_checkpoint=true means 'auto'."})
    async_checkpointing: bool = True
    keep_n_checkpoints: int = 3
    checkpoint_retries: int = field(
        default=3,
        metadata={"help": "Retries (exponential backoff + jitter) around "
                          "each checkpoint save/restore attempt."})
    checkpoint_retry_base_delay: float = field(
        default=0.5,
        metadata={"help": "First retry delay in seconds; doubles per "
                          "attempt."})
    checkpoint_verify: bool = field(
        default=False,
        metadata={"help": "After each save, read back the saved tree's "
                          "names, shapes and dtypes and retire a step that "
                          "differs (waits for an async save)."})

    def __post_init__(self) -> None:
        if self.resume not in ("off", "auto", "must"):
            raise ValueError(
                f"resume must be 'off', 'auto' or 'must', got "
                f"{self.resume!r}")
        if self.resume == "must" and not self.checkpoint_dir:
            raise ValueError("--resume must requires --checkpoint_dir")
        if self.checkpoint_retries < 0:
            raise ValueError(f"checkpoint_retries must be >= 0, got "
                             f"{self.checkpoint_retries}")


@dataclass
class ResilienceArguments:
    """Fault-tolerance knobs (``resilience.py``,
    ``resilience_distributed.py``): divergence sentinel policy,
    preemption handling, the coordinated and elastic multi-process paths,
    and fault-injection hooks."""

    nonfinite_guard: bool = field(
        default=True,
        metadata={"help": "Reject optimizer updates with non-finite loss/"
                          "grad-norm inside the train step (params "
                          "and optimizer state keep their previous values "
                          "for that step)."},
    )
    divergence_policy: str = field(
        default="skip",
        metadata={"help": "skip | rollback | abort — what the host-side "
                          "sentinel does on an anomalous (non-finite or "
                          "spiking) loss. 'rollback' restores the last "
                          "good checkpoint and fast-forwards the data "
                          "stream past the bad region."},
    )
    loss_spike_factor: float = field(
        default=0.0,
        metadata={"help": "Treat loss > factor * EMA(loss) as an anomaly "
                          "(0 = only non-finite losses are anomalous)."},
    )
    loss_ema_beta: float = field(
        default=0.98, metadata={"help": "EMA decay for the loss baseline."}
    )
    max_consecutive_anomalies: int = field(
        default=3,
        metadata={"help": "Abort after this many consecutive anomalous "
                          "steps under any policy (0 = never)."},
    )
    max_rollbacks: int = field(
        default=3,
        metadata={"help": "Abort after this many sentinel-triggered "
                          "rollbacks (0 = unlimited)."},
    )
    sentinel_frequency: int = field(
        default=-1,
        metadata={"help": "Sample the loss on the host every N steps for "
                          "the sentinel (forces a device sync on sampled "
                          "steps). -1 (default) follows log_frequency — "
                          "those steps already pay the sync for logging, "
                          "so the sentinel adds none; 0 disables the host "
                          "sentinel (the in-step nonfinite_guard still "
                          "applies); 1 samples every step for the "
                          "tightest detection latency."},
    )
    handle_preemption: bool = field(
        default=True,
        metadata={"help": "Install SIGTERM/SIGINT handlers during train() "
                          "that request an emergency checkpoint at the "
                          "next step boundary and exit cleanly. On "
                          "multi-process runs the stop flag is "
                          "all-gathered (--ft_coordinate) so any one "
                          "host's preemption triggers a collective "
                          "emergency save on every host."},
    )
    ft_coordinate: bool = field(
        default=True,
        metadata={"help": "Coordinate resilience control decisions "
                          "across hosts on multi-process runs: host 0 "
                          "forms each decision (sentinel action, stop "
                          "request, checkpoint retry/fallback) from the "
                          "all-gathered per-host observations (every "
                          "host forms the same one from the same gather), "
                          "so every host acts in lockstep. Costs one "
                          "small object gather per optimizer step. Env "
                          "override: "
                          "SCALETORCH_TPU_FT_COORDINATE."},
    )
    ft_hang_timeout: float = field(
        default=0.0,
        metadata={"help": "Hang-watchdog timeout in seconds (0 = off): "
                          "if no train-loop progress (data fetch, step "
                          "dispatch, checkpoint) lands within this "
                          "window, dump all thread stacks + the monitor "
                          "ring buffer to a crash report and exit with "
                          "code 43 so the launcher restarts the job "
                          "instead of hanging on a dead collective. Env "
                          "override: SCALETORCH_TPU_FT_HANG_TIMEOUT."},
    )
    crash_report_dir: str = field(
        default="results",
        metadata={"help": "Directory for crash_report_step<N>.json "
                          "post-mortems written on sentinel aborts, "
                          "rollback-budget exhaustion and watchdog "
                          "fires."},
    )
    # Elastic continuation (resilience_distributed.ElasticCoordinator):
    # survive host loss by remeshing onto the survivors, not restarting
    elastic: bool = field(
        default=False,
        metadata={"help": "Elastic training fleet: when a host dies or "
                          "hangs past elastic_deadline_seconds, the "
                          "survivors agree a new membership epoch, "
                          "shrink the dp axis, restore from the latest "
                          "checkpoint onto the smaller mesh and continue "
                          "to total_train_steps; relaunched hosts rejoin "
                          "at the next checkpoint boundary. Requires "
                          "--resume auto|must and a checkpoint_dir, and "
                          "a geometry whose dp divides by the host count "
                          "(tp/pp/cp/ep must not span hosts)."},
    )
    elastic_min_hosts: int = field(
        default=1,
        metadata={"help": "Refuse to continue (abort to the fleet-restart "
                          "fallback, exit 43) when a shrink would leave "
                          "fewer than this many hosts."},
    )
    elastic_heartbeat_seconds: float = field(
        default=2.0,
        metadata={"help": "Cadence of each host's liveness heartbeat file "
                          "in the membership store (operator-visible "
                          "only; detection itself is the bounded "
                          "deadline on every epoch-bus collective)."},
    )
    elastic_deadline_seconds: float = field(
        default=10.0,
        metadata={"help": "Bounded deadline on elastic epoch-bus "
                          "collectives and suspect rounds: a peer that "
                          "misses it is declared lost and the fleet "
                          "remeshes without it."},
    )
    # Fault injection (testing/drills; env vars SCALETORCH_TPU_FT_* override)
    ft_nan_at_step: int = field(
        default=0,
        metadata={"help": "Inject a NaN loss after optimizer step k "
                          "(0 = off; fires once)."},
    )
    ft_fail_saves: int = field(
        default=0,
        metadata={"help": "Fail the first n checkpoint save attempts with "
                          "a retriable I/O error (0 = off)."},
    )
    ft_sigterm_at_step: int = field(
        default=0,
        metadata={"help": "Deliver SIGTERM to this process after optimizer "
                          "step k (0 = off; fires once)."},
    )
    ft_sigterm_host: int = field(
        default=-1,
        metadata={"help": "Restrict ft_sigterm_at_step to one process "
                          "index (-1 = every host) — the multi-host "
                          "drill where exactly one worker is preempted "
                          "and the fleet must still stop together. Env "
                          "override: SCALETORCH_TPU_FT_SIGTERM_HOST."},
    )
    ft_hang_at_step: int = field(
        default=0,
        metadata={"help": "Stall the step boundary once after optimizer "
                          "step k (0 = off), simulating a dead "
                          "collective for the hang watchdog. Env "
                          "override: SCALETORCH_TPU_FT_HANG_STEP."},
    )
    ft_hang_seconds: float = field(
        default=120.0,
        metadata={"help": "Duration of the injected ft_hang_at_step "
                          "stall."},
    )
    ft_bad_batch_at_step: int = field(
        default=0,
        metadata={"help": "Make every read of data-stream position k "
                          "raise a retriable I/O error (0 = off) — "
                          "corrupt-shard injection for the loader's "
                          "retry + skip-and-log path. Env override: "
                          "SCALETORCH_TPU_FT_BAD_BATCH_STEP."},
    )
    ft_slow_step_at_step: int = field(
        default=0,
        metadata={"help": "Telemetry drill: stall optimizer step k at "
                          "its boundary for ft_slow_step_seconds "
                          "(0 = off; fires once) so the slow-step "
                          "detector arms an anomaly-triggered profiler "
                          "window (telemetry/profiling.py). Env "
                          "override: SCALETORCH_TPU_FT_SLOW_STEP_STEP."},
    )
    ft_slow_step_seconds: float = field(
        default=0.5,
        metadata={"help": "Duration of the injected ft_slow_step_at_step "
                          "stall. Env override: "
                          "SCALETORCH_TPU_FT_SLOW_STEP_SECONDS."},
    )
    ft_kill_host_at_step: int = field(
        default=0,
        metadata={"help": "Elastic drill: hard-kill the ft_kill_host-"
                          "selected host after optimizer step k (0 = "
                          "off; fires once) — survivors must remesh and "
                          "continue. Env override: "
                          "SCALETORCH_TPU_FT_KILL_HOST_STEP."},
    )
    ft_kill_host: int = field(
        default=-1,
        metadata={"help": "Process index the ft_kill_host_at_step / "
                          "ft_host_hang_elastic drills target (-1 = "
                          "every host — only meaningful in simulated-"
                          "host tests). Env override: "
                          "SCALETORCH_TPU_FT_KILL_HOST."},
    )
    ft_host_hang_elastic: int = field(
        default=0,
        metadata={"help": "Elastic drill: stall the ft_kill_host-selected "
                          "host past the elastic epoch-bus deadline once "
                          "after optimizer step k (0 = off) — the fleet "
                          "must evict it and it must park-and-rejoin. "
                          "Env override: "
                          "SCALETORCH_TPU_FT_HOST_HANG_ELASTIC."},
    )
    ft_host_hang_seconds: float = field(
        default=30.0,
        metadata={"help": "Duration of the injected ft_host_hang_elastic "
                          "stall (size it past elastic_deadline_seconds)."},
    )
    # Serving fault injection (inference.resilience.ServingFaultInjector;
    # steps are 1-based DECODE steps of the engine's lifetime)
    ft_serve_nan_at_step: int = field(
        default=0,
        metadata={"help": "Serving drill: NaN-poison one slot's KV cache "
                          "before decode step k (0 = off; fires once) so "
                          "its logits go non-finite — drives the "
                          "quarantine path. Env override: "
                          "SCALETORCH_TPU_FT_SERVE_NAN_STEP."},
    )
    ft_serve_nan_slot: int = field(
        default=0,
        metadata={"help": "Slot index the ft_serve_nan_at_step drill "
                          "poisons (falls back to the first active slot). "
                          "Env override: SCALETORCH_TPU_FT_SERVE_NAN_SLOT."},
    )
    ft_serve_slow_at_step: int = field(
        default=0,
        metadata={"help": "Serving drill: stall the engine once before "
                          "decode step k (0 = off) for "
                          "ft_serve_slow_seconds — the wedged-dispatch "
                          "drill for the serving stall watchdog (exit "
                          "code 44). Env override: "
                          "SCALETORCH_TPU_FT_SERVE_SLOW_STEP."},
    )
    ft_serve_slow_seconds: float = field(
        default=30.0,
        metadata={"help": "Duration of the injected ft_serve_slow_at_step "
                          "stall. Env override: "
                          "SCALETORCH_TPU_FT_SERVE_SLOW_SECONDS."},
    )
    ft_serve_submit_storm_at_step: int = field(
        default=0,
        metadata={"help": "Serving drill: inject a burst of "
                          "ft_serve_submit_storm_count requests at decode "
                          "step k (0 = off) — drives bounded admission "
                          "and oldest-first shedding. Env override: "
                          "SCALETORCH_TPU_FT_SERVE_SUBMIT_STORM_STEP."},
    )
    ft_serve_submit_storm_count: int = field(
        default=8,
        metadata={"help": "Number of requests the submit-storm drill "
                          "injects. Env override: "
                          "SCALETORCH_TPU_FT_SERVE_SUBMIT_STORM_COUNT."},
    )
    ft_serve_deadline_storm_at_step: int = field(
        default=0,
        metadata={"help": "Serving drill: force every in-flight request's "
                          "deadline into the past at decode step k "
                          "(0 = off) — drives the timeout paths at "
                          "admission and mid-decode. Env override: "
                          "SCALETORCH_TPU_FT_SERVE_DEADLINE_STORM_STEP."},
    )
    # Gateway fault injection (serving/gateway.py; the counting unit is
    # 1-based HTTP requests, not decode steps)
    ft_gw_tenant_storm_at: int = field(
        default=0,
        metadata={"help": "Gateway drill: when the k-th generate request "
                          "arrives (0 = off; fires once), one synthetic "
                          "'storm' tenant floods the admission queue with "
                          "ft_gw_tenant_storm_count requests — drives "
                          "weighted-fair queueing and shed-before-latency "
                          "backpressure (429 + Retry-After). Env override: "
                          "SCALETORCH_TPU_FT_GW_TENANT_STORM_AT."},
    )
    ft_gw_tenant_storm_count: int = field(
        default=8,
        metadata={"help": "Number of requests the gateway tenant-storm "
                          "drill injects. Env override: "
                          "SCALETORCH_TPU_FT_GW_TENANT_STORM_COUNT."},
    )
    ft_gw_replica_down_at: int = field(
        default=0,
        metadata={"help": "Gateway drill: when the k-th request is "
                          "dispatched to a replica (0 = off; fires once), "
                          "the router marks that replica dead mid-stream "
                          "— its in-flight requests end 'aborted', queued "
                          "requests re-route to the survivors. Env "
                          "override: "
                          "SCALETORCH_TPU_FT_GW_REPLICA_DOWN_AT."},
    )

    def __post_init__(self) -> None:
        if self.divergence_policy not in ("skip", "rollback", "abort"):
            raise ValueError(
                "divergence_policy must be 'skip', 'rollback' or 'abort', "
                f"got {self.divergence_policy!r}"
            )
        if self.loss_spike_factor != 0 and self.loss_spike_factor <= 1.0:
            # a factor in (0, 1] flags virtually every healthy step
            # (loss ~= EMA) as a spike and aborts within a few steps
            raise ValueError(
                "loss_spike_factor must be 0 (off) or > 1 (spike when "
                f"loss > factor * EMA), got {self.loss_spike_factor}"
            )
        if not 0.0 <= self.loss_ema_beta < 1.0:
            raise ValueError(
                f"loss_ema_beta must be in [0, 1), got {self.loss_ema_beta}"
            )
        if self.sentinel_frequency < -1:
            raise ValueError(
                "sentinel_frequency must be -1 (follow log_frequency), 0 "
                f"(off) or a positive period, got {self.sentinel_frequency}"
            )
        for name in ("max_consecutive_anomalies",
                     "max_rollbacks", "ft_nan_at_step", "ft_fail_saves",
                     "ft_sigterm_at_step", "ft_hang_at_step",
                     "ft_bad_batch_at_step", "ft_slow_step_at_step",
                     "ft_kill_host_at_step", "ft_host_hang_elastic",
                     "ft_serve_nan_at_step",
                     "ft_serve_nan_slot", "ft_serve_slow_at_step",
                     "ft_serve_submit_storm_at_step",
                     "ft_serve_deadline_storm_at_step",
                     "ft_gw_tenant_storm_at", "ft_gw_replica_down_at"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"{name} must be >= 0, got {getattr(self, name)}")
        if self.ft_hang_timeout < 0:
            raise ValueError(
                f"ft_hang_timeout must be >= 0 (0 disables the "
                f"watchdog), got {self.ft_hang_timeout}"
            )
        if self.ft_hang_seconds <= 0:
            raise ValueError(
                f"ft_hang_seconds must be > 0, got {self.ft_hang_seconds}"
            )
        if self.ft_sigterm_host < -1:
            raise ValueError(
                f"ft_sigterm_host must be -1 (any host) or a process "
                f"index, got {self.ft_sigterm_host}"
            )
        if self.ft_kill_host < -1:
            raise ValueError(
                f"ft_kill_host must be -1 (any host) or a process "
                f"index, got {self.ft_kill_host}"
            )
        if self.ft_host_hang_seconds <= 0:
            raise ValueError(
                f"ft_host_hang_seconds must be > 0, "
                f"got {self.ft_host_hang_seconds}"
            )
        if self.elastic_min_hosts < 1:
            raise ValueError(
                f"elastic_min_hosts must be >= 1, "
                f"got {self.elastic_min_hosts}"
            )
        if self.elastic_heartbeat_seconds <= 0:
            raise ValueError(
                f"elastic_heartbeat_seconds must be > 0, "
                f"got {self.elastic_heartbeat_seconds}"
            )
        if self.elastic_deadline_seconds <= 0:
            raise ValueError(
                f"elastic_deadline_seconds must be > 0, "
                f"got {self.elastic_deadline_seconds}"
            )
        if self.ft_slow_step_seconds <= 0:
            raise ValueError(
                f"ft_slow_step_seconds must be > 0, "
                f"got {self.ft_slow_step_seconds}"
            )
        if self.ft_serve_slow_seconds <= 0:
            raise ValueError(
                f"ft_serve_slow_seconds must be > 0, "
                f"got {self.ft_serve_slow_seconds}"
            )
        if self.ft_serve_submit_storm_count < 1:
            raise ValueError(
                f"ft_serve_submit_storm_count must be >= 1, "
                f"got {self.ft_serve_submit_storm_count}"
            )
        if self.ft_gw_tenant_storm_count < 1:
            raise ValueError(
                f"ft_gw_tenant_storm_count must be >= 1, "
                f"got {self.ft_gw_tenant_storm_count}"
            )


@dataclass
class ServingArguments:
    """Serving-gateway knobs (``serving/``): the async HTTP front door —
    bind address, tenant fairness/rate limits, admission backpressure,
    and multi-replica routing; the reference's fields and defaults.
    Consumed by ``python -m scaletorch_tpu_torch.serve`` and
    ``serving.gateway.ServingGateway``."""

    serve_host: str = field(
        default="127.0.0.1",
        metadata={"help": "Gateway bind address."},
    )
    serve_port: int = field(
        default=8000,
        metadata={"help": "Gateway bind port (0 = ephemeral; the chosen "
                          "port is logged and exposed as gateway.port)."},
    )
    serve_tenants: str = field(
        default="",
        metadata={"help": "Tenant spec 'name:weight[:rate[:burst]],...' — "
                          "WFQ weight plus an optional token-bucket rate "
                          "limit (request-cost units/s) and burst. Unknown "
                          "tenants get weight serve_default_weight and no "
                          "rate limit. Example: "
                          "'free:1:100:200,pro:4,batch:0.5'."},
    )
    serve_default_weight: float = field(
        default=1.0,
        metadata={"help": "WFQ weight for tenants not named in "
                          "serve_tenants."},
    )
    serve_max_backlog: int = field(
        default=256,
        metadata={"help": "Gateway admission backlog bound (all tenants). "
                          "Beyond it new arrivals are shed (HTTP 429 with "
                          "Retry-After) — backpressure degrades to "
                          "shedding before it degrades to latency."},
    )
    serve_free_page_watermark: float = field(
        default=0.05,
        metadata={"help": "Paged engines only: when the page pool's free "
                          "fraction sits below this watermark AND the "
                          "gateway backlog is non-empty, new arrivals are "
                          "shed instead of queued (the pool gauge drives "
                          "admission, not wishful queueing)."},
    )
    serve_default_ttl_s: float = field(
        default=0.0,
        metadata={"help": "Deadline applied to requests that carry no "
                          "ttl_s of their own (0 = none). Expired "
                          "requests end 'timeout' (HTTP 504)."},
    )
    serve_replicas: int = field(
        default=1,
        metadata={"help": "In-process engine replicas behind the "
                          "prefix-aware router (the serve entry)."},
    )
    serve_disagg: str = field(
        default="",
        metadata={"help": "Disaggregated prefill/decode serving "
                          "(inference/disagg.py): 'P:D' device counts "
                          "for the prefill and decode slices, or 'auto' "
                          "to size the split from the port's per-phase "
                          "memory rows (an even split without them). '' = colocated (default). "
                          "Paged cache layout only."},
    )
    serve_slo_path: str = field(
        default="",
        metadata={"help": "SLO target file (serving/slo.json grammar, see "
                          "serving/slo.py); when set, /healthz carries a "
                          "live 'slo' verdict. "
                          "'' disables."},
    )
    serve_slo_preset: str = field(
        default="tiny",
        metadata={"help": "Preset name inside serve_slo_path."},
    )

    def __post_init__(self) -> None:
        if self.serve_port < 0:
            raise ValueError(
                f"serve_port must be >= 0, got {self.serve_port}")
        if self.serve_default_weight <= 0:
            raise ValueError(
                f"serve_default_weight must be > 0, "
                f"got {self.serve_default_weight}")
        if self.serve_max_backlog < 1:
            raise ValueError(
                f"serve_max_backlog must be >= 1, "
                f"got {self.serve_max_backlog}")
        if not 0.0 <= self.serve_free_page_watermark < 1.0:
            raise ValueError(
                f"serve_free_page_watermark must be in [0, 1), "
                f"got {self.serve_free_page_watermark}")
        if self.serve_default_ttl_s < 0:
            raise ValueError(
                f"serve_default_ttl_s must be >= 0, "
                f"got {self.serve_default_ttl_s}")
        if self.serve_replicas < 1:
            raise ValueError(
                f"serve_replicas must be >= 1, got {self.serve_replicas}")
        if self.serve_tenants:
            # delegate the spec grammar to its single home so the CLI
            # fails at parse time, not mid-serve
            from scaletorch_tpu_torch.serving.admission import parse_tenant_spec

            parse_tenant_spec(self.serve_tenants)
        if self.serve_disagg:
            # same single-home delegation for the slice-split grammar
            # (pure host parsing at config time)
            from scaletorch_tpu_torch.inference.disagg import parse_disagg_spec

            parse_disagg_spec(self.serve_disagg)
        if self.serve_slo_path:
            # same parse-time discipline for the SLO file: a typo'd
            # path or malformed target key fails the CLI, not /healthz
            from scaletorch_tpu_torch.serving.slo import load_slo, preset_targets

            try:
                preset_targets(load_slo(self.serve_slo_path),
                               self.serve_slo_preset)
            except OSError as exc:
                raise ValueError(
                    f"serve_slo_path {self.serve_slo_path!r} is not "
                    f"readable: {exc}") from None


@dataclass
class TelemetryArguments:
    """Observability knobs (``telemetry/``): span tracing,
    anomaly-triggered profiling, straggler detection, JSONL export.
    Everything except straggler detection is enabled by setting
    ``telemetry_dir`` (env override SCALETORCH_TPU_TELEMETRY_DIR,
    present-wins — an explicitly empty value cancels it); stragglers
    ride the existing multi-host decision gather and need no
    directory."""

    telemetry_dir: Optional[str] = field(
        default=None,
        metadata={"help": "Enable telemetry and write its artifacts here: "
                          "trace_proc<N>.trace.json (Chrome trace events, "
                          "Perfetto-loadable host-side spans), "
                          "events_proc<N>.jsonl (schema-versioned metrics "
                          "stream), profiles/ (torch.profiler captures), "
                          "live_snapshot_<n>.json (SIGUSR1 dumps). Unset "
                          "= telemetry off (instrumentation costs one "
                          "branch per site). Env override: "
                          "SCALETORCH_TPU_TELEMETRY_DIR."},
    )
    trace_max_events: int = field(
        default=200_000,
        metadata={"help": "Cap on span events written to the trace file "
                          "(week-long runs stay disk-bounded; the drop "
                          "count is reported, and the in-memory tail for "
                          "crash reports keeps the NEWEST events "
                          "regardless)."},
    )
    span_tail_size: int = field(
        default=256,
        metadata={"help": "Span events retained in memory for crash "
                          "reports and SIGUSR1 live snapshots."},
    )
    profile_on_slow_step: float = field(
        default=0.0,
        metadata={"help": "Arm a bounded torch.profiler window when a "
                          "step's wall time exceeds this factor x its "
                          "EMA (0 = off; must be > 1 otherwise). "
                          "Requires telemetry_dir."},
    )
    profile_window_steps: int = field(
        default=3,
        metadata={"help": "Steps each anomaly-triggered profiler window "
                          "captures."},
    )
    profile_max_captures: int = field(
        default=1,
        metadata={"help": "Maximum anomaly-triggered profiler windows per "
                          "run (a persistently slow run must not fill "
                          "the disk with profiles)."},
    )
    profile_steps: str = field(
        default="",
        metadata={"help": "Manual profiler window 'start:stop' (steps; "
                          "[start, stop), 1-based): capture these steps "
                          "regardless of the slow-step detector. Env "
                          "override: SCALETORCH_TPU_PROFILE_STEPS."},
    )
    straggler_factor: float = field(
        default=2.0,
        metadata={"help": "Flag a host as a straggler when its step wall "
                          "time stays above this factor x the fleet "
                          "median (0 = off; must be > 1 otherwise). "
                          "Multi-host only; observations ride the "
                          "existing per-step coordination gather — zero "
                          "new collectives."},
    )
    straggler_patience: int = field(
        default=3,
        metadata={"help": "Consecutive over-threshold observations before "
                          "a host is flagged (raises the straggler_flags "
                          "counter and logs the host index)."},
    )

    def __post_init__(self) -> None:
        if self.profile_on_slow_step != 0 and self.profile_on_slow_step <= 1.0:
            raise ValueError(
                "profile_on_slow_step must be 0 (off) or > 1 (spike when "
                f"step_time > factor * EMA), got {self.profile_on_slow_step}"
            )
        if self.profile_window_steps < 1:
            raise ValueError(
                f"profile_window_steps must be >= 1, "
                f"got {self.profile_window_steps}"
            )
        if self.profile_max_captures < 0:
            raise ValueError(
                f"profile_max_captures must be >= 0, "
                f"got {self.profile_max_captures}"
            )
        if self.profile_steps:
            from scaletorch_tpu_torch.telemetry.profiling import (
                parse_profile_steps,
            )

            parse_profile_steps(self.profile_steps)  # raises on bad spec
        if self.profile_on_slow_step or self.profile_steps:
            # profiling captures land under the telemetry dir — without
            # one the knob would be a silent no-op and the operator would
            # wait forever for a window that never arms
            from scaletorch_tpu_torch.telemetry import (
                telemetry_dir_from_config,
            )

            if telemetry_dir_from_config(self) is None:
                raise ValueError(
                    "profile_on_slow_step / profile_steps need a telemetry "
                    "directory to write captures into: set --telemetry_dir "
                    "(or SCALETORCH_TPU_TELEMETRY_DIR)"
                )
        if self.straggler_factor != 0 and self.straggler_factor <= 1.0:
            raise ValueError(
                "straggler_factor must be 0 (off) or > 1 (flag when "
                f"step_time > factor * median), got {self.straggler_factor}"
            )
        if self.straggler_patience < 1:
            raise ValueError(
                f"straggler_patience must be >= 1, "
                f"got {self.straggler_patience}"
            )
        if self.trace_max_events < 1 or self.span_tail_size < 1:
            raise ValueError(
                "trace_max_events and span_tail_size must be >= 1, got "
                f"{self.trace_max_events} / {self.span_tail_size}"
            )


@dataclass
class LoggingArguments:
    log_frequency: int = 1
    log_file: Optional[str] = None
    log_format: str = field(
        default="text",
        metadata={"help": "text | json: the console and file log format. "
                          "'json' writes one JSON object a line (a step's "
                          "metrics record as is, with ts/level/proc added; "
                          "any other message as {'msg': ...})."})
    performance_log_dir: Optional[str] = field(
        default=None,
        metadata={"help": "Write the per-step metrics history as JSON here "
                          "at the end of training."})
    verbose: bool = field(
        default=False,
        metadata={"help": "Log the system and card diagnostics at start."})
    wandb_project: Optional[str] = field(
        default=None,
        metadata={"help": "Log each step's metrics to this wandb project "
                          "(process 0 only); a warning and no logging "
                          "when wandb cannot be imported."})
    wandb_run_name: Optional[str] = None


@dataclass
class ScaleTorchTPUArguments(
    DataArguments,
    ModelArguments,
    ParallelArguments,
    DistributedArguments,
    LrSchedulerArguments,
    OptimizerArguments,
    TrainingArguments,
    CheckpointArguments,
    ResilienceArguments,
    ServingArguments,
    TelemetryArguments,
    LoggingArguments,
):
    """The training arguments the port reads, composed."""

    def __post_init__(self) -> None:
        ParallelArguments.__post_init__(self)
        DistributedArguments.__post_init__(self)
        CheckpointArguments.__post_init__(self)
        ResilienceArguments.__post_init__(self)
        ServingArguments.__post_init__(self)
        TelemetryArguments.__post_init__(self)
        if self.log_format not in ("text", "json"):
            raise ValueError(
                f"log_format must be 'text' or 'json', got {self.log_format!r}"
            )
        for name in ("data_read_retries", "data_max_skipped_batches"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"{name} must be >= 0, got {getattr(self, name)}")
        # resume_from_checkpoint predates the tri-state knob: an alias
        # for 'auto' that never weakens an explicit 'must'
        if self.resume_from_checkpoint and self.resume == "off":
            self.resume = "auto"
        if self.elastic:
            # every membership change restores the newest checkpoint onto
            # the new topology: a config that cannot resume, or whose
            # geometry cannot shed a process, is refused here
            if not self.checkpoint_dir:
                raise ValueError(
                    "--elastic requires --checkpoint_dir: every membership "
                    "transition restores from the latest checkpoint")
            if self.resume == "off":
                raise ValueError(
                    "--elastic requires --resume auto|must: survivors (and "
                    "relaunched processes) continue by restoring, never "
                    "from scratch")
            if self.num_processes:
                if self.elastic_min_hosts > self.num_processes:
                    raise ValueError(
                        f"--elastic_min_hosts {self.elastic_min_hosts} > "
                        f"--num_processes {self.num_processes}: the fleet "
                        "could never satisfy its own floor — lower "
                        "elastic_min_hosts or launch more processes")
                if (self.num_processes > 1
                        and self.data_parallel_size % self.num_processes):
                    raise ValueError(
                        f"--elastic needs data_parallel_size "
                        f"{self.data_parallel_size} divisible by "
                        f"num_processes {self.num_processes} so each process "
                        "holds whole dp replicas; otherwise tp/pp/cp/ep "
                        "span processes and none can be shed — raise dp or "
                        "disable --elastic")
        if self.sequence_length % self.context_parallel_size:
            raise ValueError(
                f"sequence_length {self.sequence_length} not divisible by "
                f"context_parallel_size {self.context_parallel_size}")
        if (self.context_parallel_size > 1 and self.cp_layout == "zigzag"
                # ulysses owns whole heads: the zigzag layout never applies
                # to it; 'auto' may resolve to ulysses, so the Trainer
                # checks it once the backend is settled
                and self.attention_backend not in ("ulysses", "auto")
                and self.sequence_length % (2 * self.context_parallel_size)):
            raise ValueError(
                f"cp_layout='zigzag' needs sequence_length "
                f"{self.sequence_length} divisible by 2*cp "
                f"({2 * self.context_parallel_size}); use cp_layout="
                f"'contiguous' for odd stripe splits")
        if self.sequence_parallel:
            seq_local = self.sequence_length // self.context_parallel_size
            if seq_local % self.tensor_parallel_size:
                raise ValueError(
                    f"sequence_parallel needs per-cp-rank sequence "
                    f"{seq_local} divisible by tensor_parallel_size "
                    f"{self.tensor_parallel_size}")
        # ep shards the batch too, so the data-parallel width is dp * ep
        expected = (self.data_parallel_size * self.expert_parallel_size
                    * self.micro_batch_size
                    * self.gradient_accumulation_steps)
        if self.global_batch_size is None:
            self.global_batch_size = expected
        elif self.global_batch_size != expected:
            raise ValueError(
                f"global_batch_size {self.global_batch_size} != dp * ep * "
                f"micro_bs * grad_accum = {expected}")
        if self.num_microbatches is None:
            self.num_microbatches = self.gradient_accumulation_steps
        elif self.num_microbatches != self.gradient_accumulation_steps:
            raise ValueError(
                f"num_microbatches ({self.num_microbatches}) must equal "
                f"gradient_accumulation_steps "
                f"({self.gradient_accumulation_steps})")
        for name in ("dtype", "param_dtype"):
            if getattr(self, name) not in ("bfloat16", "float32"):
                raise ValueError(f"{name} must be bfloat16 or float32, got "
                                 f"{getattr(self, name)!r}")

    @property
    def world_size(self) -> int:
        return (self.data_parallel_size * self.pipeline_parallel_size
                * self.context_parallel_size * self.expert_parallel_size
                * self.tensor_parallel_size)

    def validate_world_size(self, num_devices: int) -> None:
        """The mesh's product must equal the process count."""
        if self.world_size != num_devices:
            raise ValueError(
                f"parallel dims product {self.world_size} != available "
                f"device count {num_devices}")

    def mesh_kwargs(self) -> dict:
        return dict(dp=self.data_parallel_size,
                    pp=self.pipeline_parallel_size,
                    cp=self.context_parallel_size,
                    ep=self.expert_parallel_size,
                    tp=self.tensor_parallel_size)


def _parser_type(annotation: str):
    """(type, nargs) of a field's annotation."""
    base = annotation.replace("Optional[", "").rstrip("]")
    if base.startswith("List["):
        return _parser_type(base[len("List["):])[0], "+"
    if base == "bool":
        return _as_bool, None
    return {"int": int, "float": float, "str": str}[base], None


def _as_bool(text: str) -> bool:
    low = text.lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def parse_args(args: Optional[List[str]] = None) -> ScaleTorchTPUArguments:
    """``--field value`` for every field (booleans take true/false; a bare
    ``--flag`` means true)."""
    parser = argparse.ArgumentParser(
        description="Train a Llama/Qwen3/Qwen3-MoE model with the PyTorch "
                    "port.")
    for f in dataclasses.fields(ScaleTorchTPUArguments):
        kind, nargs = _parser_type(f.type)
        help_text = f.metadata.get("help", "")
        if kind is _as_bool:
            parser.add_argument(f"--{f.name}", type=_as_bool, nargs="?",
                                const=True, default=f.default, help=help_text)
        else:
            parser.add_argument(f"--{f.name}", type=kind, nargs=nargs,
                                default=f.default, help=help_text)
    return ScaleTorchTPUArguments(**vars(parser.parse_args(args)))
