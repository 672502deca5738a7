"""Models of the PyTorch port: the Llama-family decoder (Llama, Qwen3),
Qwen3-MoE, and the examples' zoo: GPT(-MoE), LeNet, ResNet-18/34 and the
attention-variant library (MHA / MQA / GQA / MLA, ``models.attention``).

Importing the package registers the attention backends: ``sdpa``
(``llama.py``), ``flash`` (``ops/flash_attention.py``, the CUDA
kernels K1-K3), and the context-parallel ``ring``, ``ring_contiguous``,
``ring_zigzag`` (``ops/ring_attention.py``) and ``ulysses``
(``ops/ulysses.py``), all on K1-K3."""

from scaletorch_tpu_torch.models.convert import (  # noqa: F401
    load_numpy_params,
    params_from_numpy,
    params_to_numpy,
)
from scaletorch_tpu_torch.models.gpt_moe import (  # noqa: F401
    GPTMoE,
    GPTMoEConfig,
    GPTMoEForCausalLM,
)
from scaletorch_tpu_torch.models.lenet import LeNet, LeNetConfig  # noqa: F401
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
from scaletorch_tpu_torch.models.resnet import ResNet, ResNetConfig  # noqa: F401
from scaletorch_tpu_torch.models.qwen3_moe import (  # noqa: F401
    Qwen3MoEConfig,
    Qwen3MoEForCausalLM,
)

import scaletorch_tpu_torch.ops.flash_attention  # noqa: E402,F401
import scaletorch_tpu_torch.ops.ring_attention  # noqa: E402,F401
import scaletorch_tpu_torch.ops.ulysses  # noqa: E402,F401
