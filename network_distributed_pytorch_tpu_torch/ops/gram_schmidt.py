"""Gram-Schmidt of PowerSGD's P factors: the CUDA kernel and its wrapper.

Replaces ``network_distributed_pytorch_tpu/ops/pallas_orthogonalize.py::
_gram_schmidt_kernel`` (the Pallas TPU kernel behind
``orthogonalize_pallas``), which kept one (n, r) matrix resident in VMEM
across its r column steps. The Hopper kernel is ``csrc/gram_schmidt.cu``:
a thread-block cluster of up to 16 CTAs per matrix, each owning a range of
rows, with one reduction per column across the cluster through distributed
shared memory. One launch covers a whole ``(g, n, r)`` shape group, where
the JAX package launched once per matrix. The kernel picks its route per
shape, and the wrapper records it: ``"on_chip"`` keeps the rows in shared
memory, ``"streaming"`` (where a CTA's share of P does not fit even at 16
CTAs, e.g. r = 32 at n = 30522) works on them in place in device memory.

What bounds it on an H100: the r sequential columns, each a pass over the
CTA's rows and one cluster barrier; bytes (one read and one write of P)
and operations are far below that. ``PERF.md`` has the measured times.

On a CPU tensor the wrapper computes the plain version
(:func:`.orthogonalize.orthogonalize`); on a CUDA tensor it launches the
kernel or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .orthogonalize import orthogonalize


_INT_P = ctypes.POINTER(ctypes.c_int)
KERNEL = _build.Kernel(
    "gram_schmidt", "gram_schmidt", "gram_schmidt_f32",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _INT_P, _INT_P],
)
# the last launch's route and CTAs per matrix (the thread-block cluster size)
KERNEL.last_route, KERNEL.last_cluster = None, None
_ROUTES = {1: "on_chip", 2: "streaming"}
_MAX_GROUP = 65535  # the grid's y: one row of clusters per matrix


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
    if g > _MAX_GROUP:
        raise ValueError(f"gram_schmidt: {g} matrices in one group; the kernel's grid takes {_MAX_GROUP}")
    out = torch.empty_like(p)
    if out.numel() == 0:
        return out
    route, cluster = ctypes.c_int(0), ctypes.c_int(0)
    KERNEL.launch(p.device, p.data_ptr(), out.data_ptr(), g, n, r, eps, ctypes.byref(route), ctypes.byref(cluster))
    KERNEL.last_route, KERNEL.last_cluster = _ROUTES[route.value], cluster.value
    return out
