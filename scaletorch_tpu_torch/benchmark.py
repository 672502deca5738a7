"""The in-process training benchmark (counterpart of
scaletorch_tpu/benchmark.py): build a ``Trainer`` from a config, run
warm-up steps, time a steady window, report tokens/s, MFU, the losses
and the peak device memory. ``chip_smoke.py`` reports its training
numbers through ``benchmark_config``.

``make_bench_args`` builds the config of one row of the reference's
benchmark table for a named preset; the port runs on one card, so the
parallel sizes are not among its arguments. ``SINGLE_CHIP_ROWS`` is the
port's copy of the reference's single-chip table (model and run shape
only), and ``bench_row_args`` builds a row's config.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from scaletorch_tpu_torch.utils.device import DeviceLike

HEADLINE = "qwen3-0.6b_seq8192_bs1_gc"

# label -> (preset, make_bench_args keywords): the reference's single-chip
# rows. bf16 masters keep the optimizer state in bf16 too; the 4B row
# trains with Adafactor. The sweep row is the seq-16384 GC row again.
SINGLE_CHIP_ROWS: Dict[str, Tuple[str, Dict[str, Any]]] = {
    "qwen3-0.6b_seq2048_bs2": ("qwen3-0.6b", dict(seq=2048, micro_bs=2)),
    HEADLINE: ("qwen3-0.6b", dict(seq=8192, gc=True)),
    "qwen3-0.6b_seq16384_bs1_gc": ("qwen3-0.6b", dict(seq=16384, gc=True)),
    "qwen3-0.6b_seq16384_bf16_save_attn": (
        "qwen3-0.6b", dict(seq=16384, gc=True, remat_policy="save_attn",
                           extra={"param_dtype": "bfloat16"})),
    "qwen3-1.7b_seq2048_bs1": (
        "qwen3-1.7b", dict(seq=2048, extra={"param_dtype": "bfloat16"})),
    "qwen3-1.7b_seq8192_bs1_gc": (
        "qwen3-1.7b", dict(seq=8192, gc=True,
                           extra={"param_dtype": "bfloat16"})),
    "qwen3-4b_seq2048_bs1_gc": (
        "qwen3-4b", dict(seq=2048, gc=True,
                         extra={"param_dtype": "bfloat16",
                                "optimizer_name": "adafactor"})),
    "qwen3-0.6b_seq16384_sweep": ("qwen3-0.6b", dict(seq=16384, gc=True)),
    "qwen3-0.6b_seq2048_bs4_ga2": (
        "qwen3-0.6b", dict(seq=2048, micro_bs=4, grad_accum=2)),
}


def bench_row_args(label: str):
    """The config of the table row ``label``."""
    model, shape = SINGLE_CHIP_ROWS[label]
    return make_bench_args(model, **shape)


def benchmark_config(cfg, warmup: int = 3, steps: int = 10,
                     device: DeviceLike = None,
                     before_window: Optional[Callable[[], None]] = None
                     ) -> Dict[str, Any]:
    """One timed run: {tokens_per_second, mfu, loss, step_time_s,
    memory_gb, num_params, num_chips, device} as the reference reports
    them (tokens/s of the whole run; MFU per card; this rank's card's
    memory), plus each step's ``warmup_losses``, ``losses``,
    ``grad_norms`` and ``update_skipped`` (and, for a MoE model, each step's
    ``moe_dropped_fraction`` and ``moe_load_cv``), and the ``trainer``
    itself for a caller that goes on with it (drop it before serialising
    the result). For a MoE model the MFU counts the active parameters.

    ``device=None`` is the CUDA card (and raises without one); MFU and
    memory are reported for a card only. ``before_window`` is called once
    the warm-up steps have finished, just before the timed steps start."""
    from scaletorch_tpu_torch.trainer.trainer import Trainer

    trainer = Trainer(cfg, device=device)
    on_card = trainer.device.type == "cuda"
    warm = [trainer.step() for _ in range(warmup)]
    warmup_losses = [float(m["loss"]) for m in warm]  # completion barrier
    if on_card:
        torch.cuda.synchronize(trainer.device)
        torch.cuda.reset_peak_memory_stats(trainer.device)
    if before_window is not None:
        before_window()
    t0 = time.perf_counter()
    window = [trainer.step() for _ in range(steps)]
    # reading the losses waits for every step of the window
    losses = [float(m["loss"]) for m in window]
    if on_card:
        torch.cuda.synchronize(trainer.device)
    elapsed = time.perf_counter() - t0
    tok_s, mfu = trainer.metrics.throughput(steps, elapsed)
    return {
        "tokens_per_second": tok_s,
        "mfu": mfu,
        "loss": losses[-1],
        "step_time_s": elapsed / steps,
        "memory_gb": (torch.cuda.max_memory_allocated(trainer.device) / 1e9
                      if on_card else None),
        "num_params": trainer.num_params,
        "num_chips": trainer.world,
        "device": (torch.cuda.get_device_name(trainer.device) if on_card
                   else "cpu"),
        "warmup_losses": warmup_losses,
        "losses": losses,
        "grad_norms": [float(m["grad_norm"]) for m in window],
        "update_skipped": [float(m["update_skipped"]) for m in window],
        **{k: [float(m[k]) for m in window] for k in window[0]
           if k.startswith("moe_")},
        "trainer": trainer,
    }


def make_bench_args(
    model: str,
    *,
    seq: int,
    micro_bs: int = 1,
    grad_accum: int = 1,
    gc: bool = False,
    dtype: str = "bfloat16",
    remat_policy: str = "nothing_saveable",
    extra: Optional[Dict[str, Any]] = None,
):
    """ScaleTorchTPUArguments for a named preset and run shape, as the
    reference builds them (synthetic data, clip 1.0, quiet logging). The
    preset goes in whole: a field the config lacks raises, so no
    architecture field is dropped on the way."""
    from scaletorch_tpu_torch.config import ScaleTorchTPUArguments
    from scaletorch_tpu_torch.models.presets import preset

    kwargs = dict(
        preset(model),
        sequence_length=seq,
        micro_batch_size=micro_bs,
        gradient_accumulation_steps=grad_accum,
        gradient_checkpointing=gc,
        remat_policy=remat_policy,
        synthetic_data=True,
        dtype=dtype,
        max_grad_norm=1.0,
        log_frequency=10_000,  # silence per-step logging during timing
        total_train_steps=1_000_000,  # trainer.train(num_steps=...) drives
    )
    kwargs.update(extra or {})
    return ScaleTorchTPUArguments(**kwargs)
