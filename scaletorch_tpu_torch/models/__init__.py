"""Models of the PyTorch port: the Llama-family decoder (Llama, Qwen3)."""

from scaletorch_tpu_torch.models.convert import load_numpy_params  # noqa: F401
from scaletorch_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    LlamaForCausalLM,
    init_params,
)
from scaletorch_tpu_torch.models.presets import (  # noqa: F401
    MODEL_PRESETS,
    model_config,
    preset,
)
from scaletorch_tpu_torch.models.qwen3 import Qwen3Config  # noqa: F401
