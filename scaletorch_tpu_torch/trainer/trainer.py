"""The single-device training loop (counterpart of the one-device subset
of scaletorch_tpu/trainer/trainer.Trainer).

``Trainer(cfg, device=None)`` builds the model config (Llama, Qwen3 or
Qwen3-MoE), the fp32 master parameters (seeded), AdamW with its schedule, the synthetic loader and
the train step; ``step(batch=None)`` runs one optimizer step and
``train(num_steps=None)`` runs the loop with a log line every
``log_frequency`` steps. ``device=None`` means the CUDA card and raises
without one; the CPU runs only when asked for by name. Checkpointing,
eval, telemetry, resilience policies and the elastic paths are still to
port (ROADMAP Queue 1).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
from scaletorch_tpu_torch.data.dataloader import (
    SyntheticDataLoader,
    device_batch,
)
from scaletorch_tpu_torch.models import llama, qwen3_moe
from scaletorch_tpu_torch.models.qwen3 import Qwen3Config
from scaletorch_tpu_torch.models.registry import resolve_attention_backend
from scaletorch_tpu_torch.trainer.optimizer import create_optimizer
from scaletorch_tpu_torch.trainer.train_step import make_train_step
from scaletorch_tpu_torch.utils.device import (
    DeviceLike,
    get_theoretical_flops,
    resolve_device,
)
from scaletorch_tpu_torch.utils.logger import get_logger
from scaletorch_tpu_torch.utils.misc import get_mfu, get_num_params

_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model_config(cfg: ScaleTorchTPUArguments):
    """``model_type`` dispatch over the config's architecture fields."""
    if cfg.param_dtype != "float32":
        raise NotImplementedError(
            f"param_dtype {cfg.param_dtype!r}: the port keeps fp32 master "
            "weights (bf16 masters are ROADMAP Queue 1)")
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
        dtype=_DTYPE[cfg.dtype],
        param_dtype=torch.float32,
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


class Trainer:
    """End-to-end single-device training loop."""

    def __init__(self, cfg: ScaleTorchTPUArguments,
                 device: DeviceLike = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.logger = get_logger(log_file=cfg.log_file)
        if cfg.eval_frequency:
            raise NotImplementedError(
                "eval_frequency > 0: the port has no eval step yet "
                "(ROADMAP Queue 1)")
        if not cfg.synthetic_data:
            raise NotImplementedError(
                "synthetic_data false: the port has no real-data loader yet "
                "(ROADMAP Queue 1); pass --synthetic_data true")
        if not cfg.donate_params:
            raise NotImplementedError(
                "donate_params false: the port always updates parameters "
                "and optimizer state in place")
        self.model_cfg = build_model_config(cfg)
        self.attention_backend = resolve_attention_backend(
            cfg.attention_backend)
        torch.manual_seed(cfg.seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed)
        self.is_moe = isinstance(self.model_cfg, qwen3_moe.Qwen3MoEConfig)
        model = qwen3_moe if self.is_moe else llama
        self.params = model.init_params(self.model_cfg, gen, self.device,
                                        requires_grad=True)
        self.optimizer, self.schedule = create_optimizer(cfg)
        self.opt_state = self.optimizer.init(self.params)
        self.loader = SyntheticDataLoader(
            vocab_size=min(self.model_cfg.vocab_size,
                           cfg.synthetic_vocab_size
                           or self.model_cfg.vocab_size),
            sequence_length=cfg.sequence_length,
            micro_batch_size=cfg.micro_batch_size,
            gradient_accumulation_steps=cfg.gradient_accumulation_steps,
            seed=cfg.seed,
        )
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
        self.global_step = 0
        self.tokens_seen = 0
        self.history: list = []
        self._train_iter = None
        self.logger.info(
            f"model {cfg.model_type}: {self.num_params / 1e6:.1f}M params, "
            f"attention {self.attention_backend}, device {self.device}, "
            f"seq {cfg.sequence_length}, micro_bs {cfg.micro_batch_size}, "
            f"grad_accum {cfg.gradient_accumulation_steps}, "
            f"gc {cfg.gradient_checkpointing}")

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

    def throughput(self, steps: int, seconds: float
                   ) -> Tuple[float, Optional[float]]:
        """(tokens/s, MFU in %) of ``steps`` steps that took ``seconds``;
        the MFU is None on the CPU."""
        tok_s = self.loader.tokens_per_step * steps / seconds
        peak = self.peak_flops()
        if peak is None:
            return tok_s, None
        cfg = self.model_cfg
        return tok_s, get_mfu(tok_s, self.mfu_params, cfg.num_hidden_layers,
                              cfg.num_attention_heads, cfg.actual_head_dim,
                              self.cfg.sequence_length, peak_flops=peak)

    def train(self, num_steps: Optional[int] = None) -> Dict[str, Any]:
        """Run ``num_steps`` more steps (default: up to
        ``total_train_steps``); log every ``log_frequency`` steps and
        return the last logged record."""
        target = (max(self.cfg.total_train_steps, self.global_step)
                  if num_steps is None else self.global_step + num_steps)
        last: Dict[str, Any] = {}
        t0, step0 = time.perf_counter(), self.global_step
        while self.global_step < target:
            m = self.step()
            if self.global_step % self.cfg.log_frequency:
                continue
            record = {k: float(v) for k, v in m.items()}  # synchronises
            now = time.perf_counter()
            steps = self.global_step - step0
            tok_s, mfu = self.throughput(steps, now - t0)
            record.update(
                step=self.global_step,
                # the update just applied used the count before it advanced
                lr=float(self.schedule(self.global_step - 1)),
                step_time=(now - t0) / steps,
                tokens_per_second=tok_s,
            )
            if mfu is not None:
                record["mfu"] = mfu
                record["peak_memory_gb"] = (
                    torch.cuda.max_memory_allocated(self.device) / 1e9)
            self.history.append(record)
            self.logger.info(" | ".join(
                [f"step {record['step']:>6}", f"loss {record['loss']:.4f}",
                 f"lr {record['lr']:.3e}",
                 f"grad_norm {record['grad_norm']:.4f}",
                 f"skipped {record.get('update_skipped', 0.0):.0f}",
                 f"step {record['step_time']:.3f}s",
                 f"tok/s {tok_s:.1f}"]
                + ([f"mfu {record['mfu']:.2f}%"] if "mfu" in record else [])))
            last = record
            t0, step0 = time.perf_counter(), self.global_step
        return last
