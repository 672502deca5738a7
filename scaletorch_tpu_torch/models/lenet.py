"""LeNet-5, the MNIST example's CNN, in PyTorch's NCHW layout.

Counterpart of scaletorch_tpu/models/lenet.py: two conv (5x5, valid) +
ReLU + 2x2 max-pool blocks and three fully connected layers. The weights
are held as torch lays them out (conv ``[O, I, kH, kW]``, linear ``[in,
out]`` as the reference multiplies ``x @ w``), and the flatten runs over
NCHW's (C, H, W) order; ``models/convert.lenet_from_jax`` carries a JAX
tree (HWIO convs, an ``fc1`` whose rows follow NHWC's (H, W, C) flatten)
across, so both compute the same function.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from scaletorch_tpu_torch.models.layers import fan_in_uniform, init_generator
from scaletorch_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@dataclass(frozen=True)
class LeNetConfig:
    num_classes: int = 10
    in_channels: int = 1


def param_shapes(cfg: LeNetConfig) -> Dict[str, tuple]:
    return {"conv1": (6, cfg.in_channels, 5, 5), "conv2": (16, 6, 5, 5),
            "fc1": (16 * 4 * 4, 120), "fc2": (120, 84),
            "fc3": (84, cfg.num_classes)}


def init_params(generator: Optional[torch.Generator] = None,
                cfg: LeNetConfig = LeNetConfig(), *,
                device: DeviceLike = None) -> Params:
    """U(±1/sqrt(fan_in)) for every leaf (the reference's init; the draws
    differ from JAX's PRNG) on ``device`` (None: the CUDA card), drawn
    from ``generator`` on its own device (default: a fresh one on
    ``device`` seeded with 0)."""
    dev = resolve_device(device)
    generator = init_generator(generator, dev)
    out = {}
    for name, shape in param_shapes(cfg).items():
        fan_in = math.prod(shape[1:]) if name.startswith("conv") else shape[0]
        out[name] = fan_in_uniform(generator, shape, fan_in, device=dev)
    return out


def _block(x: Tensor, w: Tensor) -> Tensor:
    return F.max_pool2d(F.relu(F.conv2d(x, w)), 2)


def forward(params: Params, x: Tensor) -> Tensor:
    """x: [B, C, 28, 28] -> logits [B, num_classes]."""
    x = _block(x, params["conv1"])  # [B, 6, 12, 12]
    x = _block(x, params["conv2"])  # [B, 16, 4, 4]
    x = x.flatten(1)
    x = F.relu(x @ params["fc1"])
    x = F.relu(x @ params["fc2"])
    return x @ params["fc3"]


class LeNet:
    """The reference's veneer: ``init`` draws the parameters, a call runs
    ``forward``."""

    config_cls = LeNetConfig

    def __init__(self, config: LeNetConfig = LeNetConfig()):
        self.config = config

    def init(self, generator: Optional[torch.Generator] = None, *,
             device: DeviceLike = None) -> Params:
        return init_params(generator, self.config, device=device)

    def __call__(self, params: Params, x: Tensor) -> Tensor:
        return forward(params, x)
