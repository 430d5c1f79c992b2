"""ResNet family in PyTorch, the counterpart of the JAX package's
``models/resnet.py`` (He et al. 2015, v1.5 stride placement on the 3x3).

Details kept from the JAX model so weights carry across
(``models/import_weights.py``):

- explicit pad-1 on every 3x3 conv;
- the last BatchNorm scale of each block starts at zero;
- a shortcut ``conv_proj`` / ``norm_proj`` (1x1 conv, stride of the block)
  wherever the block changes shape;
- ``stem="imagenet"``: 7x7/2 pad-3 conv and 3x3/2 pad-1 max-pool;
  ``stem="cifar"``: 3x3 pad-1 conv, no pool;
- a global mean pool and a ``head`` Linear;
- ``norm="batch"``: BatchNorm with flax's momentum 0.9 and epsilon 1e-5;
  ``norm="group"``: flax's ``GroupNorm(num_groups=32)``, epsilon 1e-6
  (torch's default is 1e-5), stateless.

``forward`` takes NHWC float input, the JAX package's layout, and permutes
it inside; the permuted view has channels-last strides, which cuDNN takes
as they are. Submodule names follow the flax ones (``blocks.{i}`` for
``{Block}_{i}``, ``conv{c}`` / ``norm{c}`` for ``Conv_{c}`` /
``BatchNorm_{c}``).

Weights are drawn on the CPU from an explicit ``torch.Generator`` (flax's
defaults: truncated-normal LeCun fan-in for conv and dense kernels, zero
biases, unit BN scales) and then moved to ``device``, so a seed gives the
same weights on every device.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import resolve_device

# flax BatchNorm(momentum=0.9) keeps 0.9 of the old running stat; torch's
# momentum is the weight of the new batch statistic
_BN_MOMENTUM = 0.1
_BN_EPS = 1e-5
# flax GroupNorm's defaults
_GN_GROUPS = 32
_GN_EPS = 1e-6


def _norm(channels: int, norm: str) -> nn.Module:
    if norm == "batch":
        return nn.BatchNorm2d(channels, eps=_BN_EPS, momentum=_BN_MOMENTUM)
    if norm == "group":
        return nn.GroupNorm(_GN_GROUPS, channels, eps=_GN_EPS)
    raise ValueError(f"unknown norm {norm!r}")


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    """2-conv residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, norm: str):
        super().__init__()
        self.conv0 = _conv(cin, filters, 3, stride)
        self.norm0 = _norm(filters, norm)
        self.conv1 = _conv(filters, filters, 3)
        self.norm1 = _norm(filters, norm)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or cin != filters:
            self.conv_proj = _conv(cin, filters, 1, stride)
            self.norm_proj = _norm(filters, norm)

    def forward(self, x):
        y = F.relu(self.norm0(self.conv0(x)))
        y = self.norm1(self.conv1(y))
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """1-3-1 bottleneck block (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, norm: str):
        super().__init__()
        cout = filters * 4
        self.conv0 = _conv(cin, filters, 1)
        self.norm0 = _norm(filters, norm)
        self.conv1 = _conv(filters, filters, 3, stride)
        self.norm1 = _norm(filters, norm)
        self.conv2 = _conv(filters, cout, 1)
        self.norm2 = _norm(cout, norm)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or cin != cout:
            self.conv_proj = _conv(cin, cout, 1, stride)
            self.norm_proj = _norm(cout, norm)

    def forward(self, x):
        y = F.relu(self.norm0(self.conv0(x)))
        y = F.relu(self.norm1(self.conv1(y)))
        y = self.norm2(self.conv2(y))
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    # flax variance_scaling(1, "fan_in", "truncated_normal"): the std of a
    # unit normal truncated to [-2, 2] is 0.8796..., hence the correction
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


class ResNet(nn.Module):
    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls,
        num_classes: int = 10,
        width: int = 64,
        norm: str = "batch",
        stem: str = "imagenet",
        device="cuda",
        seed: int = 0,
    ):
        super().__init__()
        if stem not in ("imagenet", "cifar"):
            raise ValueError(f"unknown stem {stem!r}")
        device = resolve_device(device)
        self.stem = stem
        if stem == "imagenet":
            self.conv_init = _conv(3, width, 7, 2)
        else:
            self.conv_init = _conv(3, width, 3)
        self.norm_init = _norm(width, norm)
        blocks = []
        cin = width
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, width * 2**i, stride, norm))
                cin = width * 2**i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)
        self._init_weights(torch.Generator().manual_seed(seed))
        self.to(device)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                _lecun_normal_(mod.weight, mod.weight[0].numel(), gen)
            elif isinstance(mod, nn.Linear):
                _lecun_normal_(mod.weight, mod.in_features, gen)
                mod.bias.zero_()
            elif isinstance(mod, (nn.BatchNorm2d, nn.GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for block in self.blocks:
            last = block.norm2 if isinstance(block, BottleneckBlock) else block.norm1
            last.weight.zero_()

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)
        x = F.relu(self.norm_init(self.conv_init(x)))
        if self.stem == "imagenet":
            x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))
        return self.head(x).float()


def resnet18(**kw) -> ResNet:
    return ResNet(stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock, **kw)


def resnet152(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 8, 36, 3], block_cls=BottleneckBlock, **kw)
