"""Parameter counts and MFU accounting (counterpart of the relevant part
of scaletorch_tpu/utils/misc.py)."""

from __future__ import annotations

from typing import Any, Optional

from scaletorch_tpu_torch.utils.device import get_theoretical_flops


def to_readable_format(num: float, precision: int = 2) -> str:
    """1234567 -> '1.23M'."""
    for div, suffix in ((1e12, "T"), (1e9, "B"), (1e6, "M"), (1e3, "K")):
        if abs(num) >= div:
            return f"{num / div:.{precision}f}{suffix}"
    return f"{num:.{precision}f}"


def get_num_params(params: Any) -> int:
    """Total scalar count of a (nested dict) parameter tree."""
    if isinstance(params, dict):
        return sum(get_num_params(v) for v in params.values())
    return int(params.numel())


def get_flops_per_token(num_params: int, num_layers: int, num_heads: int,
                        head_dim: int, seq_len: int) -> float:
    """6N + 12·L·h·d·s: the reference's formula, so MFU compares."""
    return 6.0 * num_params + 12.0 * num_layers * num_heads * head_dim * seq_len


def get_mfu(tokens_per_second: float, num_params: int, num_layers: int,
            num_heads: int, head_dim: int, seq_len: int, num_chips: int = 1,
            peak_flops: Optional[float] = None) -> float:
    """Model FLOPs utilisation in percent (0-100) against the card's
    dense bf16 peak."""
    if peak_flops is None:
        peak_flops = get_theoretical_flops()
    flops_per_token = get_flops_per_token(num_params, num_layers, num_heads,
                                          head_dim, seq_len)
    return 100.0 * tokens_per_second * flops_per_token / (
        peak_flops * num_chips)
