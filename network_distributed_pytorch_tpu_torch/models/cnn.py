"""Small CNN of the CPU-testable tier, the counterpart of the JAX package's
``models/cnn.py``: two 3x3 convolutions (same padding, with bias), each
followed by ReLU and a 2x2 average pool, then two Linear layers.

``forward`` takes NHWC input, as the JAX model does, and flattens the last
feature map in NHWC order, so the first Linear layer's weight is the flax
``Dense_0`` kernel transposed. Submodules are ``conv{i}`` and ``dense{i}``
for flax's ``Conv_{i}`` and ``Dense_{i}``. Weights are flax's defaults
(truncated-normal LeCun fan-in kernels, zero biases), drawn on the CPU from
``seed`` and moved to ``device``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import resolve_device
from .resnet import _lecun_normal_


class SmallCNN(nn.Module):
    def __init__(
        self, num_classes: int = 10, width: int = 16, image_size: int = 32, device="cuda", seed: int = 0
    ):
        super().__init__()
        device = resolve_device(device)
        self.conv0 = nn.Conv2d(3, width, 3, padding=1)
        self.conv1 = nn.Conv2d(width, width * 2, 3, padding=1)
        side = image_size // 2 // 2
        self.dense0 = nn.Linear(width * 2 * side * side, width * 4)
        self.dense1 = nn.Linear(width * 4, num_classes)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for mod in (self.conv0, self.conv1, self.dense0, self.dense1):
                _lecun_normal_(mod.weight, mod.weight[0].numel(), gen)
                mod.bias.zero_()
        self.to(device)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)
        x = F.avg_pool2d(F.relu(self.conv0(x)), 2)
        x = F.avg_pool2d(F.relu(self.conv1(x)), 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's NHWC order
        return self.dense1(F.relu(self.dense0(x)))
