"""ResNet-18/34 (basic blocks), the ImageNet example's model family, in
PyTorch's NCHW layout.

Counterpart of scaletorch_tpu/models/resnet.py: the functional
``forward(params, state, images, cfg, *, train)`` with BatchNorm as
explicit state, and ``ResNet``, an ``nn.Module`` veneer that holds the
parameters and the running statistics. Convolutions are cuDNN's
(``F.conv2d``; the reference computes them with
``lax.conv_general_dilated``, outside any Pallas kernel), with weights
``[O, I, kH, kW]`` (``models/convert.resnet_from_jax`` carries a JAX tree
across from HWIO); the head multiplies ``x @ kernel`` as the reference
does.

The reference's numerics, kept here:

  * ``"SAME"`` padding is asymmetric: a k x k window of stride s over n
    pixels pads ``total = max((ceil(n/s) - 1)·s + k - n, 0)``, ``total //
    2`` before and the rest after (the stem's 7x7/2 on 224 pads (2, 3),
    a 3x3/2 on an even size (0, 1)), where torch's ``padding=`` pads both
    sides alike. Every "SAME" window pads explicitly with ``F.pad`` (with
    -inf for the 3x3/2 max pool) and runs with ``padding=0``; the 1x1
    projections are "VALID".
  * BatchNorm computes its statistics in fp32, with the BIASED variance
    (``jnp.var``, two passes), for the normalisation and for the
    running-stat EMA alike; eval mode reads the running statistics.
  * Under data parallelism (``bn_group``) the statistics are over the
    GLOBAL batch (sync-BN): each rank's sum, then its sum of squared
    deviations from the global mean, are summed over the group by an
    all-reduce whose backward is the same all-reduce of the gradient.

Parameters and state are nested dicts; a stage's blocks are keyed
``"0"``, ``"1"``, ... (the reference's lists), so the optimizers'
``tree_map`` walks them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from scaletorch_tpu_torch.models.layers import init_generator
from scaletorch_tpu_torch.utils.device import DeviceLike, resolve_device

Tensor = torch.Tensor
Params = Dict[str, Any]

_DEPTHS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


@dataclass(frozen=True)
class ResNetConfig:
    depth: int = 18
    num_classes: int = 1000
    width: int = 64          # stem channels; stages use width * (1,2,4,8)
    image_size: int = 224
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def stage_blocks(self) -> Tuple[int, ...]:
        if self.depth not in _DEPTHS:
            raise ValueError(f"depth must be one of {sorted(_DEPTHS)}")
        return _DEPTHS[self.depth]

    def num_params(self) -> int:
        """The parameters' element count (the running statistics are not
        parameters)."""
        total = 0
        for shape in param_shapes(self).values():
            total += math.prod(shape)
        return total


def _blocks(cfg: ResNetConfig):
    """(stage, block, in channels, out channels, stride) of every block."""
    cin = cfg.width
    for si, n in enumerate(cfg.stage_blocks):
        cout = cfg.width * 2 ** si
        for bi in range(n):
            yield si, bi, cin, cout, (2 if si > 0 and bi == 0 else 1)
            cin = cout


def param_shapes(cfg: ResNetConfig) -> Dict[str, Tuple[int, ...]]:
    """Flat name -> shape, in the reference's draw order (the stem, each
    block's conv1, conv2 and projection, then the head)."""
    w = cfg.width
    shapes = {"stem.conv": (w, 3, 7, 7), "stem.bn.scale": (w,),
              "stem.bn.bias": (w,)}
    for si, bi, cin, cout, stride in _blocks(cfg):
        at = f"stage{si}.{bi}."
        shapes[at + "conv1"] = (cout, cin, 3, 3)
        shapes[at + "bn1.scale"] = shapes[at + "bn1.bias"] = (cout,)
        shapes[at + "conv2"] = (cout, cout, 3, 3)
        shapes[at + "bn2.scale"] = shapes[at + "bn2.bias"] = (cout,)
        if stride != 1 or cin != cout:
            shapes[at + "down_conv"] = (cout, cin, 1, 1)
            shapes[at + "down_bn.scale"] = shapes[at + "down_bn.bias"] = (
                cout,)
    shapes["fc.kernel"] = (w * 8, cfg.num_classes)
    shapes["fc.bias"] = (cfg.num_classes,)
    return shapes


def _nest(flat: Dict[str, Tensor]) -> Params:
    out: Params = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def _bn_names(cfg: ResNetConfig):
    """The flat names of the BatchNorm layers' running statistics."""
    names = ["stem"]
    for si, bi, cin, cout, stride in _blocks(cfg):
        at = f"stage{si}.{bi}."
        names += [at + "bn1", at + "bn2"]
        if stride != 1 or cin != cout:
            names.append(at + "down_bn")
    return names


def init_params(generator: Optional[torch.Generator] = None,
                cfg: ResNetConfig = ResNetConfig(), *,
                device: DeviceLike = None) -> Tuple[Params, Params]:
    """(params, bn_state) with the reference's distributions (the draws
    differ from JAX's PRNG): Kaiming-normal fan-out convolutions
    (torchvision's), BatchNorm scale 1 and bias 0, the head's kernel
    U(±1/sqrt(fan_in)) and bias 0; running mean 0 and variance 1. On
    ``device`` (None: the CUDA card), drawn from ``generator`` on its own
    device (default: a fresh one on ``device`` seeded with 0)."""
    dev = resolve_device(device)
    generator = init_generator(generator, dev)
    flat = {}
    for name, shape in param_shapes(cfg).items():
        t = torch.empty(shape, dtype=torch.float32, device=generator.device)
        if name == "fc.kernel":
            bound = 1.0 / math.sqrt(shape[0])
            t.uniform_(-bound, bound, generator=generator)
        elif len(shape) == 4:
            t.normal_(0.0, math.sqrt(2.0 / (shape[0] * shape[2] * shape[3])),
                      generator=generator)
        else:
            t.fill_(1.0 if name.endswith("scale") else 0.0)
        flat[name] = t.to(dev)
    state = {}
    for name in _bn_names(cfg):
        c = flat[(name + ".bn" if name == "stem" else name) + ".scale"].shape[0]
        state[name + ".mean"] = torch.zeros(c, device=dev)
        state[name + ".var"] = torch.ones(c, device=dev)
    return _nest(flat), _nest(state)


# ---- the functional forward -----------------------------------------------------
def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: Tensor, k: int, stride: int, value: float = 0.0) -> Tensor:
    top, bottom = same_pads(x.shape[2], k, stride)
    left, right = same_pads(x.shape[3], k, stride)
    return F.pad(x, (left, right, top, bottom), value=value)


def _conv(x: Tensor, w: Tensor, stride: int, dtype: torch.dtype) -> Tensor:
    if w.shape[-1] > 1:
        x = _pad_same(x, w.shape[-1], stride)
    return F.conv2d(x.to(dtype), w.to(dtype), stride=stride)


class _SyncSum(torch.autograd.Function):
    """A sum over ``group``; its gradient is the same sum of the
    gradients (every rank's statistics read every rank's rows)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _batch_sum(x: Tensor, group) -> Tensor:
    """``x`` summed over the channel's positions on this rank, then over
    ``group`` (None: this rank alone)."""
    s = x.sum(dim=(0, 2, 3))
    return s if group is None else _SyncSum.apply(s, group)


def _bn(x: Tensor, p: Params, s: Params, cfg: ResNetConfig, train: bool,
        group) -> Tuple[Tensor, Params]:
    """(y, new state). Train: the batch's statistics over the whole
    (global, under ``group``) batch and the fp32 EMA of the running ones."""
    x32 = x.float()
    if train:
        world = 1 if group is None else dist.get_world_size(group)
        count = x.shape[0] * x.shape[2] * x.shape[3] * world
        mean = _batch_sum(x32, group) / count
        dev = x32 - mean[None, :, None, None]
        var = _batch_sum(dev.square(), group) / count
        m = cfg.bn_momentum
        new_s = {"mean": ((1 - m) * s["mean"] + m * mean).detach(),
                 "var": ((1 - m) * s["var"] + m * var).detach()}
    else:
        mean, var = s["mean"], s["var"]
        dev = x32 - mean[None, :, None, None]
        new_s = s
    y = dev * torch.rsqrt(var + cfg.bn_eps)[None, :, None, None]
    y = y * p["scale"][None, :, None, None] + p["bias"][None, :, None, None]
    return y.to(x.dtype), new_s


def forward(params: Params, state: Params, images: Tensor, cfg: ResNetConfig,
            *, train: bool = True, bn_group=None) -> Tuple[Tensor, Params]:
    """images [N, 3, H, W] -> (logits [N, classes] fp32, new BN state);
    ``bn_group``: the data-parallel process group whose global batch the
    train-mode statistics cover (None: this rank's batch)."""
    dt = cfg.dtype
    x = images.to(dt)
    new_state: Params = {}
    x = _conv(x, params["stem"]["conv"], 2, dt)
    x, new_state["stem"] = _bn(x, params["stem"]["bn"], state["stem"], cfg,
                               train, bn_group)
    x = F.relu(x)
    x = F.max_pool2d(_pad_same(x, 3, 2, value=-math.inf), 3, 2)
    for si in range(len(cfg.stage_blocks)):
        stage, sstate = params[f"stage{si}"], state[f"stage{si}"]
        new_stage = {}
        for bi in range(len(stage)):
            blk, bst = stage[str(bi)], sstate[str(bi)]
            stride = 2 if si > 0 and bi == 0 else 1
            nst = {}
            out = _conv(x, blk["conv1"], stride, dt)
            out, nst["bn1"] = _bn(out, blk["bn1"], bst["bn1"], cfg, train,
                                  bn_group)
            out = F.relu(out)
            out = _conv(out, blk["conv2"], 1, dt)
            out, nst["bn2"] = _bn(out, blk["bn2"], bst["bn2"], cfg, train,
                                  bn_group)
            if "down_conv" in blk:
                identity = _conv(x, blk["down_conv"], stride, dt)
                identity, nst["down_bn"] = _bn(
                    identity, blk["down_bn"], bst["down_bn"], cfg, train,
                    bn_group)
            else:
                identity = x
            x = F.relu(out + identity)
            new_stage[str(bi)] = nst
        new_state[f"stage{si}"] = new_stage
    x = x.float().mean(dim=(2, 3))  # global average pool
    logits = x @ params["fc"]["kernel"] + params["fc"]["bias"]
    return logits, new_state


# ---- the nn.Module veneer ----------------------------------------------------------
class _Tree(nn.Module):
    """A nested dict of tensors as nested modules: leaves are parameters
    (``buffers=False``) or buffers."""

    def __init__(self, tree: Params, buffers: bool) -> None:
        super().__init__()
        self._keys = list(tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, _Tree(value, buffers))
            elif buffers:
                self.register_buffer(key, value)
            else:
                self.register_parameter(key, nn.Parameter(value))

    def tree(self) -> Params:
        return {k: (getattr(self, k).tree() if isinstance(
            getattr(self, k), _Tree) else getattr(self, k))
            for k in self._keys}


class ResNet(nn.Module):
    """The functional model as a module: ``params`` holds the parameters,
    ``bn_state`` the running statistics as buffers. A call runs
    ``forward`` in train mode while ``self.training`` (and copies the new
    statistics into the buffers), in eval mode otherwise. ``init`` is
    the zoo's functional draw."""

    config_cls = ResNetConfig

    def __init__(self, config: ResNetConfig = ResNetConfig(),
                 generator: Optional[torch.Generator] = None, *,
                 device: DeviceLike = None, bn_group=None) -> None:
        super().__init__()
        self.config = config
        self.bn_group = bn_group
        params, state = init_params(generator, config, device=device)
        self.params = _Tree(params, buffers=False)
        self.bn_state = _Tree(state, buffers=True)

    def init(self, generator: Optional[torch.Generator] = None, *,
             device: DeviceLike = None) -> Tuple[Params, Params]:
        return init_params(generator, self.config, device=device)

    def forward(self, images: Tensor) -> Tensor:
        state = self.bn_state.tree()
        logits, new_state = forward(self.params.tree(), state, images,
                                    self.config, train=self.training,
                                    bn_group=self.bn_group)
        if self.training:
            with torch.no_grad():
                _copy_tree_(state, new_state)
        return logits


def _copy_tree_(dst: Params, src: Params) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_tree_(dst[k], v)
        else:
            dst[k].copy_(v)
