"""The single-device training loop (counterpart of the one-device subset
of scaletorch_tpu/trainer/trainer.Trainer).

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
Telemetry, the resilience policies and the elastic paths are still to
port (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
from scaletorch_tpu_torch.data.dataloader import (
    MicroBatchDataLoader,
    SyntheticDataLoader,
    device_batch,
    remap_loader_position,
)
from scaletorch_tpu_torch.models import llama, qwen3_moe
from scaletorch_tpu_torch.models.qwen3 import Qwen3Config
from scaletorch_tpu_torch.models.registry import resolve_attention_backend
from scaletorch_tpu_torch.trainer.metrics import MetricsLogger
from scaletorch_tpu_torch.trainer.optimizer import (
    create_optimizer,
    tree_leaves,
)
from scaletorch_tpu_torch.trainer.train_step import (
    make_eval_step,
    make_train_step,
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


def build_model_config(cfg: ScaleTorchTPUArguments):
    """``model_type`` dispatch over the config's architecture fields, or
    over ``model_name_or_path``'s ``config.json`` when set (the training
    knobs still come from ``cfg``)."""
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
                     tokenizer: Any = None):
    """The synthetic stream (``synthetic_data``, or no ``dataset_name``),
    else ``MicroBatchDataLoader`` over the local file ``dataset_name``
    tokenized by ``tokenizer`` (an object), or by the tokenizer that
    ``tokenizer_name_or_path`` (default: ``model_name_or_path``) names."""
    if cfg.synthetic_data or not cfg.dataset_name:
        return SyntheticDataLoader(
            vocab_size=min(model_cfg.vocab_size,
                           cfg.synthetic_vocab_size or model_cfg.vocab_size),
            sequence_length=cfg.sequence_length,
            micro_batch_size=cfg.micro_batch_size,
            gradient_accumulation_steps=cfg.gradient_accumulation_steps,
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
        seed=cfg.seed,
        read_retries=cfg.data_read_retries,
        retry_base_delay=cfg.data_retry_base_delay,
        max_skipped_batches=cfg.data_max_skipped_batches,
    )


class Trainer:
    """End-to-end single-device training loop."""

    def __init__(self, cfg: ScaleTorchTPUArguments,
                 device: DeviceLike = None, tokenizer: Any = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.logger = get_logger(log_file=cfg.log_file)
        if cfg.verbose:
            from scaletorch_tpu_torch.utils.env_info import log_system_info

            log_system_info(self.logger)
        if not cfg.donate_params:
            raise NotImplementedError(
                "donate_params false: the port always updates parameters "
                "and optimizer state in place")
        self.model_cfg = build_model_config(cfg)
        self.attention_backend = resolve_attention_backend(
            cfg.attention_backend)
        torch.manual_seed(cfg.seed)
        self.is_moe = isinstance(self.model_cfg, qwen3_moe.Qwen3MoEConfig)
        model = qwen3_moe if self.is_moe else llama
        if cfg.load_pretrained_weights:
            if not cfg.model_name_or_path:
                raise ValueError(
                    "load_pretrained_weights requires model_name_or_path")
            from scaletorch_tpu_torch.utils.hf_interop import load_hf_params

            self.params = load_hf_params(cfg.model_name_or_path,
                                         self.model_cfg, device=self.device)
            for leaf in tree_leaves(self.params):
                leaf.requires_grad_(True)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(cfg.seed)
            self.params = model.init_params(self.model_cfg, gen, self.device,
                                            requires_grad=True)
        self.optimizer, self.schedule = create_optimizer(cfg)
        self.opt_state = self.optimizer.init(self.params)
        self.tokenizer = tokenizer
        self.loader = build_dataloader(cfg, self.model_cfg, tokenizer)
        self.step_fn = make_train_step(
            self.model_cfg, self.optimizer,
            attention_backend=self.attention_backend,
            gradient_checkpointing=cfg.gradient_checkpointing,
            remat_policy=cfg.remat_policy,
            max_grad_norm=cfg.max_grad_norm,
        )
        self.num_params = get_num_params(self.params)
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
        self.global_step = 0
        self.tokens_seen = 0
        self._train_iter = None
        self._ckpt_mgr = None
        self._eval_fn = None
        self._eval_loader = None
        self._eval_batches: Optional[list] = None
        self._eval_iter = None
        if cfg.eval_frequency:
            self._eval_fn = make_eval_step(
                self.model_cfg, attention_backend=self.attention_backend)
            self._eval_loader = self._build_eval_loader()
        self.logger.info(
            f"model {cfg.model_type}: "
            f"{to_readable_format(self.num_params)} params, "
            f"attention {self.attention_backend}, device {self.device}, "
            f"seq {cfg.sequence_length}, micro_bs {cfg.micro_batch_size}, "
            f"grad_accum {cfg.gradient_accumulation_steps}, "
            f"gc {cfg.gradient_checkpointing}, "
            f"data {cfg.dataset_name or 'synthetic'}")
        if cfg.resume != "off" and cfg.checkpoint_dir:
            self.load_checkpoint(required=cfg.resume == "must")

    @property
    def history(self) -> list:
        """The logged records, oldest first."""
        return self.metrics.history

    def step(self, batch: Optional[Dict[str, np.ndarray]] = None
             ) -> Dict[str, Any]:
        """Run ONE optimizer step on ``batch`` (default: the loader's next
        batch) and return its metrics (0-d device tensors)."""
        if batch is None:
            if self._train_iter is None:
                self._train_iter = iter(self.loader)
            batch = next(self._train_iter)
        dev_batch = device_batch(batch, self.device)
        self.params, self.opt_state, m = self.step_fn(
            self.params, self.opt_state, dev_batch)
        self.global_step += 1
        self.tokens_seen += int(np.prod(np.shape(batch["input_ids"])))
        return m

    def peak_flops(self) -> Optional[float]:
        """The card's dense peak for MFU (raises for a card without an
        entry); None on the CPU."""
        if self.device.type != "cuda":
            return None
        return get_theoretical_flops(torch.cuda.get_device_name(self.device))

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
                                         device_batch(batch, self.device)))
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
            self._ckpt_mgr = CheckpointManager(
                self.cfg.checkpoint_dir,
                keep_n=self.cfg.keep_n_checkpoints,
                async_save=self.cfg.async_checkpointing,
                retries=self.cfg.checkpoint_retries,
                retry_base_delay=self.cfg.checkpoint_retry_base_delay,
                verify=self.cfg.checkpoint_verify,
            )
        return self._ckpt_mgr

    def _stream_position(self) -> int:
        """Step batches the loader has handed out (it counts skipped
        regions too); the step count for a loader without a position."""
        position = getattr(self.loader, "position", None)
        return self.global_step if position is None else position

    def save_checkpoint(self) -> bool:
        """Save the parameters, the optimizer state and the counters
        (``tokens_seen``, the loader's ``loader_position`` and its
        ``samples_per_step``) at ``global_step``."""
        return self.checkpoint_manager.save(
            step=self.global_step, params=self.params,
            opt_state=self.opt_state,
            extra={"tokens_seen": self.tokens_seen,
                   "loader_position": self._stream_position(),
                   "samples_per_step": getattr(
                       self.loader, "samples_per_step", None)})

    def load_checkpoint(self, required: bool = False) -> bool:
        """Restore the newest readable checkpoint in place; returns
        whether one was restored. ``required`` (``--resume must``) raises
        when none restores. The loader is fast-forwarded to the saved
        ``loader_position`` (translated if the step size changed) and
        the live iterator dropped."""
        restored = self.checkpoint_manager.load_latest(
            params=self.params, opt_state=self.opt_state)
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
        if hasattr(self.loader, "set_state"):
            self.loader.set_state(position)
        self._train_iter = None
        self.logger.info(f"resumed from step {self.global_step}")
        return True

    def export_hf(self, path: str, dtype: str = "bfloat16",
                  max_shard_bytes: int = 5 * 1024 ** 3) -> str:
        """Write the parameters as a HF checkpoint directory: safetensors
        (``save_hf_params``) and its ``config.json``. Returns the
        safetensors file's path, or the index's when sharded."""
        from scaletorch_tpu_torch.utils.hf_interop import (
            hf_config_dict,
            save_hf_params,
        )

        out = save_hf_params(path, self.params, self.model_cfg, dtype=dtype,
                             max_shard_bytes=max_shard_bytes)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(hf_config_dict(self.model_cfg, dtype), f, indent=2)
        self.logger.info(f"HF weights written to {path}")
        return out

    # -- the loop -------------------------------------------------------------
    def train(self, num_steps: Optional[int] = None) -> Dict[str, Any]:
        """Run ``num_steps`` more steps (default: up to
        ``total_train_steps``, so a resumed run ends where an
        uninterrupted one would) and return the last logged record (with
        ``val_loss`` on an eval step)."""
        cfg = self.cfg
        target = (max(cfg.total_train_steps, self.global_step)
                  if num_steps is None else self.global_step + num_steps)
        last: Dict[str, Any] = {}
        self.metrics.start_window(self.global_step)
        while self.global_step < target:
            m = self.step()
            step = self.global_step
            record = self.metrics.log_step(
                step, loss=m["loss"],
                # the update just applied used the count before it advanced
                lr=float(self.schedule(step - 1)),
                grad_norm=m["grad_norm"],
                extras={k: v for k, v in m.items()
                        if k not in ("loss", "grad_norm")})
            last = record or last
            if cfg.eval_frequency and step % cfg.eval_frequency == 0:
                val = self.evaluate()
                if val is not None:
                    self.logger.info(f"step {step:>6} | val_loss {val:.4f}")
                    if record:
                        record["val_loss"] = val
                    else:
                        last = {**last, "val_loss": val}
            if (cfg.save_frequency and cfg.checkpoint_dir
                    and step % cfg.save_frequency == 0):
                self.save_checkpoint()
        if self._ckpt_mgr is not None:
            self._ckpt_mgr.wait()  # the last async save is on disk
        if cfg.performance_log_dir:
            path = self.metrics.save_json(os.path.join(
                cfg.performance_log_dir,
                f"performance_log_step{self.global_step}.json"))
            self.logger.info(f"performance log written to {path}")
        return last

    def close(self) -> None:
        """Finish any asynchronous save and release its buffers."""
        if self._ckpt_mgr is not None:
            self._ckpt_mgr.close()
            self._ckpt_mgr = None
