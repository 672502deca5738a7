"""System and accelerator diagnostics (counterpart of
scaletorch_tpu/utils/env_info.py): the host (OS, Python, CPUs, memory,
disk) and the card (name, count, memory, the peak MFU is measured
against, the torch and CUDA versions)."""

from __future__ import annotations

import os
import platform
import shutil
import socket
from typing import Any, Dict

import torch

from scaletorch_tpu_torch.utils.device import (
    device_memory_stats,
    get_theoretical_flops,
)
from scaletorch_tpu_torch.utils.monitor import read_meminfo


def get_system_info() -> Dict[str, Any]:
    info: Dict[str, Any] = {
        "Operating System": platform.platform(),
        "Python Version": platform.python_version(),
        "Hostname": socket.gethostname(),
        "CPU Count": os.cpu_count(),
        "PyTorch Version": torch.__version__,
    }
    mem = read_meminfo()
    if mem.get("MemTotal"):
        info["Memory Total"] = f"{mem['MemTotal'] / 1024**3:.2f}GB"
        info["Memory Available"] = (
            f"{mem.get('MemAvailable', 0.0) / 1024**3:.2f}GB")
    du = shutil.disk_usage(os.getcwd())
    info["Disk Usage"] = (f"{du.used / 1024**3:.2f}GB / "
                          f"{du.total / 1024**3:.2f}GB")
    if not torch.cuda.is_available():
        info["Device Type"] = "CPU (no CUDA device visible)"
        return info
    name = torch.cuda.get_device_name(0)
    info.update({
        "Device Type": "GPU",
        "Device Kind": name,
        "Device Count": torch.cuda.device_count(),
        "CUDA Version": torch.version.cuda,
        "Device Memory":
            f"{device_memory_stats(0)['bytes_limit'] / 1024**3:.2f}GB",
        "BF16 Support": torch.cuda.is_bf16_supported(),
    })
    try:
        info["Peak bf16 TFLOPS (registry)"] = (
            get_theoretical_flops(name) / 1e12)
    except KeyError:  # a card the table does not know
        pass
    return info


def log_system_info(logger) -> Dict[str, Any]:
    """One 'k: v' line per entry."""
    info = get_system_info()
    logger.info("System Diagnostic Information:")
    for k, v in info.items():
        logger.info(f"  {k}: {v}")
    return info
