"""Device resolution for the port's entry points, the card's identity and
its peak rate.

Every entry point (``InferenceEngine``, ``init_params``, the model
constructor) takes ``device=None``, which means the CUDA card. There is
no silent CPU path: without a card, ``resolve_device`` raises unless the
caller asked for the CPU by name, as the CPU tests do.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if the device asked for is CUDA and no
    card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible to PyTorch; the port runs on the "
            "GPU by default. Pass device='cpu' explicitly to run the "
            "plain PyTorch path on the CPU."
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def device_memory_stats(device: DeviceLike = None) -> Dict[str, float]:
    """Live memory statistics of a device in bytes, under the reference's
    keys: ``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit``
    (the card's total), plus ``bytes_reserved`` and ``bytes_free`` (free
    on the card, from ``mem_get_info``) from the caching allocator. All
    zero for the CPU or without a card."""
    dev = torch.device("cuda" if device is None else device)
    out = {"bytes_in_use": 0.0, "peak_bytes_in_use": 0.0, "bytes_limit": 0.0}
    if dev.type != "cuda" or not torch.cuda.is_available():
        return out
    stats = torch.cuda.memory_stats(dev)
    free, total = torch.cuda.mem_get_info(dev)
    out.update(
        bytes_in_use=float(stats.get("allocated_bytes.all.current", 0)),
        peak_bytes_in_use=float(stats.get("allocated_bytes.all.peak", 0)),
        bytes_limit=float(total),
        bytes_reserved=float(stats.get("reserved_bytes.all.current", 0)),
        bytes_free=float(free),
    )
    return out


def card_name_and_power_limit() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card,
    as the tool prints it (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``), or
    None where ``nvidia-smi`` is missing. Every timing the port records
    stands beside this line: a card set below its full power limit runs
    slower under load."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[0] if lines else None


# Peak dense bf16 FLOP/s per card, by substring of
# torch.cuda.get_device_name() (NVIDIA data sheets; the H100 SXM figure is
# the reference's h100 entry, its sparse 1979e12 halved).
_DEVICE_FLOPS = {
    "h100 80gb hbm3": 989.5e12,  # H100 SXM
    "h100 sxm": 989.5e12,
}


def get_theoretical_flops(name: Optional[str] = None) -> float:
    """Peak dense bf16 FLOP/s of the card called ``name`` (default: card
    0). A card the table does not know raises: there is no default
    peak."""
    if name is None:
        name = torch.cuda.get_device_name(0)
    kind = name.lower()
    for sub, flops in _DEVICE_FLOPS.items():
        if sub in kind:
            return flops
    raise KeyError(
        f"no peak bf16 FLOP/s known for {name!r}; known: "
        f"{sorted(_DEVICE_FLOPS)}")
