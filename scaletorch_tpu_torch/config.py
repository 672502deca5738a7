"""Training configuration of the port: the subset of
scaletorch_tpu/config.py that the single-device training slice reads.

The dataclasses keep the reference's names, field names and defaults:
``DataArguments`` (the local-file fields), ``ModelArguments`` (its
architecture fields, the MoE fields included, ``model_type``,
``model_name_or_path`` and ``load_pretrained_weights``),
``LrSchedulerArguments``, ``OptimizerArguments``, ``TrainingArguments``
and ``CheckpointArguments`` (whole, with their validation), and the
logging fields the port reads. They compose into
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
        metadata={"help": "auto | flash | sdpa: auto resolves like the "
                          "reference (FLASH_ATTEN -> flash, else sdpa); "
                          "flash runs the CUDA kernels K1-K3."})
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
        metadata={"help": "If set, must equal micro_batch_size * "
                          "grad_accum (one device)."})
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
class LoggingArguments:
    log_frequency: int = 1
    log_file: Optional[str] = None
    performance_log_dir: Optional[str] = field(
        default=None,
        metadata={"help": "Write the per-step metrics history as JSON here "
                          "at the end of training."})
    verbose: bool = field(
        default=False,
        metadata={"help": "Log the system and card diagnostics at start."})


@dataclass
class ScaleTorchTPUArguments(
    DataArguments,
    ModelArguments,
    LrSchedulerArguments,
    OptimizerArguments,
    TrainingArguments,
    CheckpointArguments,
    LoggingArguments,
):
    """The training arguments the port reads, composed."""

    def __post_init__(self) -> None:
        CheckpointArguments.__post_init__(self)
        for name in ("data_read_retries", "data_max_skipped_batches"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"{name} must be >= 0, got {getattr(self, name)}")
        # resume_from_checkpoint predates the tri-state knob: an alias
        # for 'auto' that never weakens an explicit 'must'
        if self.resume_from_checkpoint and self.resume == "off":
            self.resume = "auto"
        expected = self.micro_batch_size * self.gradient_accumulation_steps
        if self.global_batch_size is None:
            self.global_batch_size = expected
        elif self.global_batch_size != expected:
            raise ValueError(
                f"global_batch_size {self.global_batch_size} != micro_bs * "
                f"grad_accum = {expected} (one device)")
        for name in ("dtype", "param_dtype"):
            if getattr(self, name) not in ("bfloat16", "float32"):
                raise ValueError(f"{name} must be bfloat16 or float32, got "
                                 f"{getattr(self, name)!r}")


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
