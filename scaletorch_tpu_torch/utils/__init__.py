"""Utilities of the PyTorch port: logging, device resolution, checkpoints,
Hugging Face safetensors interop, system monitoring."""

from scaletorch_tpu_torch.utils.device import (  # noqa: F401
    card_name_and_power_limit,
    resolve_device,
)
from scaletorch_tpu_torch.utils.logger import get_logger  # noqa: F401
