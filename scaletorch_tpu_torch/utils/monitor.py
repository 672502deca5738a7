"""Host and device health sampled on logging steps (counterpart of
scaletorch_tpu/utils/monitor.py).

A record holds the host's memory and load and this process's CPU share
and resident memory (read from ``/proc`` and ``os``, no extra package),
the card's memory from ``torch.cuda`` (``memory_stats``,
``mem_get_info``), and the card's power, temperature and utilisation
through NVML where a package for it (``pynvml``) is installed; fields
that cannot be read are left out, never made up. Records go into a
capped ring buffer, so a long run's tail can always be read back.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Deque, Dict, Optional

from scaletorch_tpu_torch.utils.device import device_memory_stats


def read_meminfo() -> Dict[str, float]:
    """/proc/meminfo in bytes (empty where there is none)."""
    out: Dict[str, float] = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, rest = line.partition(":")
                parts = rest.split()
                if parts:
                    out[key] = float(parts[0]) * 1024.0
    except OSError:
        pass
    return out


def process_rss_bytes() -> Optional[float]:
    """This process's resident memory, from /proc/self/statm."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, IndexError, ValueError):
        return None
    return float(pages * os.sysconf("SC_PAGE_SIZE"))


def read_accelerator_environment(index: int = 0) -> Dict[str, float]:
    """Card power (W), temperature (C) and utilisation (%) through NVML,
    or {} where no NVML package is installed or the read fails."""
    try:
        import pynvml
    except ImportError:
        return {}
    try:
        pynvml.nvmlInit()
        try:
            h = pynvml.nvmlDeviceGetHandleByIndex(index)
            return {
                "accel_power_w": pynvml.nvmlDeviceGetPowerUsage(h) / 1e3,
                "accel_temp_c": float(pynvml.nvmlDeviceGetTemperature(
                    h, pynvml.NVML_TEMPERATURE_GPU)),
                "accel_util_percent": float(
                    pynvml.nvmlDeviceGetUtilizationRates(h).gpu),
            }
        finally:
            pynvml.nvmlShutdown()
    except Exception:  # a card NVML cannot read
        return {}


class SystemMonitor:
    """Capped history of host and device health records."""

    def __init__(self, max_records: int = 1024) -> None:
        self.records: Deque[Dict[str, Any]] = deque(maxlen=max_records)
        self._cpu_mark = (time.monotonic(), sum(os.times()[:2]))

    def _process_cpu_percent(self) -> float:
        """This process's CPU time over wall time since the last call."""
        now, cpu = time.monotonic(), sum(os.times()[:2])
        wall = now - self._cpu_mark[0]
        pct = 100.0 * (cpu - self._cpu_mark[1]) / wall if wall > 0 else 0.0
        self._cpu_mark = (now, cpu)
        return pct

    def sample(self, step: Optional[int] = None,
               device_stats: Optional[Dict[str, float]] = None,
               counters: Optional[Dict[str, float]] = None
               ) -> Dict[str, Any]:
        """One record. ``device_stats``: an already fetched
        ``device_memory_stats()``; ``counters``: cumulative training
        counters to keep beside the health readings."""
        record: Dict[str, Any] = {
            "time": time.time(),
            "process_cpu_percent": self._process_cpu_percent(),
            "load_avg_1m": os.getloadavg()[0],
        }
        if step is not None:
            record["step"] = step
        mem = read_meminfo()
        if mem.get("MemTotal"):
            used = mem["MemTotal"] - mem.get("MemAvailable", 0.0)
            record["host_mem_used_gb"] = used / 1e9
            record["host_mem_percent"] = 100.0 * used / mem["MemTotal"]
        rss = process_rss_bytes()
        if rss is not None:
            record["process_rss_gb"] = rss / 1e9
        dev = device_stats if device_stats is not None \
            else device_memory_stats()
        if dev.get("bytes_in_use"):
            record["device_mem_gb"] = dev["bytes_in_use"] / 1e9
            record["device_peak_mem_gb"] = dev["peak_bytes_in_use"] / 1e9
            if dev.get("bytes_limit"):
                record["device_mem_percent"] = (
                    100.0 * dev["bytes_in_use"] / dev["bytes_limit"])
            if dev.get("bytes_reserved"):
                # the allocator's cached share that holds no tensor
                record["device_fragmentation"] = max(
                    0.0, 1.0 - dev["bytes_in_use"] / dev["bytes_reserved"])
            record.update(read_accelerator_environment())
        if counters:
            record.update(counters)
        self.records.append(record)
        return record

    def tail(self, last_n: Optional[int] = None) -> list:
        records = list(self.records)
        return records if last_n is None else records[-last_n:]

    def summary(self) -> Dict[str, float]:
        """Mean and max of each numeric field over the retained records."""
        out: Dict[str, float] = {}
        keys = {k for r in self.records for k, v in r.items()
                if isinstance(v, (int, float)) and k not in ("time", "step")}
        for k in sorted(keys):
            vals = [r[k] for r in self.records if k in r]
            out[f"mean_{k}"] = sum(vals) / len(vals)
            out[f"max_{k}"] = max(vals)
        return out
