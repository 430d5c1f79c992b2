"""Gram-Schmidt of PowerSGD's P factors: the CUDA kernel and its wrapper.

Replaces ``network_distributed_pytorch_tpu/ops/pallas_orthogonalize.py::
_gram_schmidt_kernel`` (the Pallas TPU kernel behind
``orthogonalize_pallas``), which kept one (n, r) matrix resident in VMEM
across its r column steps. The Hopper kernel is ``csrc/gram_schmidt.cu``:
one thread block per matrix of a shape group, a loop over the r columns
with block-wide reductions for the norm and the projections, in place in
device memory. One launch covers a whole ``(g, n, r)`` shape group, where
the JAX package launched once per matrix.

What bounds it on an H100: bytes, 2 * n * r * 4 at the least per matrix
(one read and one write of P). At PowerSGD's shapes P is at most a few
hundred KB and sits in L2, so the launch latency and the 2 * r block
barriers per column dominate; ``PERF.md`` has the measured times.

On a CPU tensor the wrapper computes the plain version
(:func:`.orthogonalize.orthogonalize`); on a CUDA tensor it launches the
kernel or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .orthogonalize import orthogonalize


KERNEL = _build.Kernel(
    "gram_schmidt", "gram_schmidt", "gram_schmidt_f32",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float],
)


def gram_schmidt(p: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Orthonormalise the columns of ``(n, r)`` or ``(g, n, r)`` fp32 P
    factors with the reference's sequential-column recurrence."""
    if p.device.type == "cpu":
        return orthogonalize(p, eps)
    if p.device.type != "cuda":
        raise ValueError(f"gram_schmidt: unsupported device {p.device}")
    if p.dtype != torch.float32:
        raise TypeError(f"gram_schmidt: the CUDA kernel takes float32, got {p.dtype}")
    if p.dim() not in (2, 3):
        raise ValueError(f"gram_schmidt: expected (n, r) or (g, n, r), got {tuple(p.shape)}")
    if not p.is_contiguous():
        raise ValueError("gram_schmidt: the CUDA kernel takes a contiguous tensor")
    g, n, r = (1, *p.shape) if p.dim() == 2 else p.shape
    if n * r >= 2**31:
        raise ValueError(f"gram_schmidt: matrix of {n} x {r} is too large for int indexing")
    out = torch.empty_like(p)
    if out.numel() == 0:
        return out
    KERNEL.launch(p.device, p.data_ptr(), out.data_ptr(), g, n, r, eps)
    return out
