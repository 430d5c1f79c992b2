"""Flat-buffer packing: many small tensors ride one collective.

The JAX package's ``TensorPacker`` (reference ``tensor_buffer.py``): start
and end offsets computed once from static shapes, ``pack`` concatenates,
``unpack`` returns shaped views into the flat buffer, and
``bits() = 8 * nelement * element_size``.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch


class TensorPacker:
    def __init__(self, shapes: Sequence[Tuple[int, ...]], dtype=torch.float32):
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        self.dtype = dtype
        self.sizes = [math.prod(s) for s in self.shapes]
        self.total_size = sum(self.sizes)

    @classmethod
    def for_tensors(cls, tensors: Sequence[torch.Tensor]) -> "TensorPacker":
        dtype = tensors[0].dtype if tensors else torch.float32
        return cls([t.shape for t in tensors], dtype=dtype)

    def pack(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """One new flat buffer in the packer's dtype, holding every tensor."""
        if not tensors:
            return torch.zeros((0,), dtype=self.dtype)
        return torch.cat([t.reshape(-1).to(self.dtype) for t in tensors])

    def unpack(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Shaped views into ``flat`` (no copy)."""
        return [
            part.view(shape)
            for part, shape in zip(torch.split(flat, self.sizes), self.shapes)
        ]

    def bits(self) -> int:
        """``8 * nelement * element_size``."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return 8 * self.total_size * itemsize
