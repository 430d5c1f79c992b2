"""Toy MLP, the counterpart of the JAX package's ``models/mlp.py``: the
input flattened per example (NHWC images in the JAX package's order), then
Linear layers of ``features`` widths with ReLU between them.

Submodules are ``dense{i}`` for flax's ``Dense_{i}``; ``in_features`` is
the flattened input's width, which flax infers at its first call. Weights
are flax's defaults, drawn on the CPU from ``seed`` and moved to
``device``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import resolve_device
from .resnet import _lecun_normal_


class MLP(nn.Module):
    def __init__(
        self, in_features: int = 32 * 32 * 3, features: Sequence[int] = (64, 64, 10), device="cuda", seed: int = 0
    ):
        super().__init__()
        device = resolve_device(device)
        widths = [in_features, *features]
        for i, (fan_in, fan_out) in enumerate(zip(widths, widths[1:])):
            self.add_module(f"dense{i}", nn.Linear(fan_in, fan_out))
        self.n_layers = len(features)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for mod in self.children():
                _lecun_normal_(mod.weight, mod.in_features, gen)
                mod.bias.zero_()
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_layers - 1):
            x = F.relu(getattr(self, f"dense{i}")(x))
        return getattr(self, f"dense{self.n_layers - 1}")(x)
