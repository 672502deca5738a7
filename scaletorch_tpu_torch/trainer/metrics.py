"""Per-step training metrics: tokens/s, MFU, memory, a console line and a
history (counterpart of scaletorch_tpu/trainer/metrics.py), and each
logged record on the telemetry exporter's JSONL stream when one is
attached.

On a step that does not log nothing is read back from the card, so the
host keeps queueing work; rates are taken over the window since the
previous logged step. MFU is the reference's formula (``utils/misc.
get_mfu``) over the card's peak; it is left out where no peak is given
(the CPU). Each logged record also carries a ``SystemMonitor`` sample,
kept in its ring buffer.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

from scaletorch_tpu_torch.utils.device import DeviceLike, device_memory_stats
from scaletorch_tpu_torch.utils.logger import get_logger
from scaletorch_tpu_torch.utils.misc import get_mfu, to_readable_format
from scaletorch_tpu_torch.utils.monitor import SystemMonitor

# training-health counters that ride into the monitor's ring buffer
COUNTER_KEYS = ("anomalies", "nonfinite_losses", "loss_spikes", "rollbacks",
                "update_skipped", "straggler_flags")


@dataclass
class MetricsLogger:
    num_params: int
    num_layers: int
    num_heads: int
    head_dim: int
    seq_len: int
    tokens_per_step: int
    log_frequency: int = 1
    peak_flops: Optional[float] = None
    device: DeviceLike = None
    # optional telemetry.TelemetryExporter: every logged record also lands
    # on the JSONL event stream (kind 'train_step')
    exporter: Optional[object] = None
    history: list = field(default_factory=list)
    _window_start_time: Optional[float] = None
    _window_start_step: Optional[int] = None
    _monitor: SystemMonitor = field(default_factory=SystemMonitor)

    def start_window(self, step: int) -> None:
        """Start the rate window at ``step`` now (a loop's start)."""
        self._window_start_time = time.perf_counter()
        self._window_start_step = step

    def throughput(self, steps: int, seconds: float
                   ) -> Tuple[float, Optional[float]]:
        """(tokens/s, MFU in %) of ``steps`` steps that took ``seconds``;
        the MFU is None where no peak is given."""
        tok_s = self.tokens_per_step * steps / seconds
        if not self.peak_flops:
            return tok_s, None
        return tok_s, get_mfu(tok_s, self.num_params, self.num_layers,
                              self.num_heads, self.head_dim, self.seq_len,
                              peak_flops=self.peak_flops)

    def log_step(self, step: int, loss, lr: float, grad_norm,
                 extras: Optional[dict] = None) -> dict:
        """Call every step; reads the values (a synchronisation) and logs
        only on logging steps. Returns the record, or {} off them."""
        if step % self.log_frequency != 0:
            return {}
        record = {"step": step, "loss": float(loss), "lr": float(lr),
                  "grad_norm": float(grad_norm)}
        for k, v in (extras or {}).items():
            record[k] = float(v)
        now = time.perf_counter()
        if self._window_start_time is not None:
            elapsed = now - self._window_start_time
            steps = step - self._window_start_step
            if elapsed > 0 and steps > 0:
                tok_s, mfu = self.throughput(steps, elapsed)
                record.update(step_time=elapsed / steps,
                              tokens_per_second=tok_s)
                if mfu is not None:
                    record["mfu"] = mfu
        # the window restarts after the read-back, so the wait is not
        # charged to the next window
        self._window_start_time = time.perf_counter()
        self._window_start_step = step
        mem = device_memory_stats(self.device)
        if mem["bytes_in_use"]:
            record["memory_gb"] = mem["bytes_in_use"] / 1e9
            record["peak_memory_gb"] = mem["peak_bytes_in_use"] / 1e9
        sample = self._monitor.sample(
            step, device_stats=mem,
            counters={k: record[k] for k in COUNTER_KEYS if k in record})
        record.update((k, v) for k, v in sample.items()
                      if k not in ("time", "step", "device_mem_gb",
                                   "device_peak_mem_gb"))
        self.history.append(record)
        if self.exporter is not None:
            self.exporter.emit("train_step", record)
        parts = [f"step {step:>6}", f"loss {record['loss']:.4f}",
                 f"lr {record['lr']:.2e}", f"gnorm {record['grad_norm']:.3f}"]
        if "tokens_per_second" in record:
            parts.append(
                f"tok/s {to_readable_format(record['tokens_per_second'])}")
        if "mfu" in record:
            parts.append(f"MFU {record['mfu']:.1f}%")
        if "moe_dropped_fraction" in record:
            parts.append(f"drop {record['moe_dropped_fraction']:.2%}")
        if "moe_load_cv" in record:
            parts.append(f"load_cv {record['moe_load_cv']:.2f}")
        if record.get("update_skipped"):
            parts.append("UPDATE-SKIPPED")
        if "memory_gb" in record:
            parts.append(f"mem {record['memory_gb']:.1f}GB")
        get_logger().info(" | ".join(parts),
                          extra={"structured_record": record})
        return record

    def ring_buffer(self, last_n: Optional[int] = None) -> list:
        """The monitor's retained records, newest last."""
        return self._monitor.tail(last_n)

    def save_json(self, path: str) -> str:
        """The whole history and its summary as JSON."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        summary = {}
        rates = [r["tokens_per_second"] for r in self.history
                 if "tokens_per_second" in r]
        if rates:
            summary["mean_tokens_per_second"] = sum(rates) / len(rates)
            mfus = [r["mfu"] for r in self.history if "mfu" in r]
            if mfus:
                summary["mean_mfu"] = sum(mfus) / len(mfus)
        summary.update(self._monitor.summary())
        with open(path, "w") as f:
            json.dump({"num_params": self.num_params, "seq_len": self.seq_len,
                       "peak_flops": self.peak_flops, "summary": summary,
                       "records": self.history}, f, indent=1)
        return path
