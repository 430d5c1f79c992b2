"""The fused PowerSGD compress pipeline: CUDA kernels, their wrappers and
their plain PyTorch versions.

Replaces the Pallas TPU kernels of the JAX package's
``ops/pallas_powersgd.py``; the wrappers keep those functions' names,
arguments and returns, on ``(g, n, m)`` shape-group stacks:

- :func:`fused_ef_compress`, ``M = G + E`` and ``P = M Q`` in one pass
  (K2a); with ``residuals=None``, ``P = M Q`` and ``M`` is ``grads``
  itself (K2b);
- :func:`fused_orthogonalize_project`, K1's Gram-Schmidt on P, then
  ``Q = M^T P-hat`` while P-hat is on chip (K3);
- :func:`fused_decompress_residual`, ``out = P-hat Q^T`` and the
  error-feedback residual ``mem = M - out`` in one read of M (K4).

The kernels are ``csrc/powersgd.cu`` (its header says how each is laid
out on Hopper and what bounds it). K3 takes one launch where K1 keeps a
matrix's P in one CTA: every CTA of a cluster runs K1's own recurrence on
the whole P and projects its share of M's rows, so P-hat is K1's bit for
bit. Elsewhere it takes two launches, K1's kernel writing P-hat and the
projection reading it back, and :data:`ORTHOGONALIZE_PROJECT` records which
route the last launch took.

On CPU tensors a wrapper computes the plain version; on CUDA tensors it
launches the kernel or raises. There is no fallback from one to the other.
The plain versions follow the Pallas bodies' dtype rules, bf16 included:
products accumulate in fp32, P and Q take the promoted dtype of their
operands, and the residual is formed in fp32 and cast once. The CUDA
kernels take fp32 only: on the reducer's path P and Q are cast back to the
gradients' dtype after each all-reduce.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .orthogonalize import orthogonalize

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

EF_COMPRESS = _build.Kernel(
    "ef_compress", "powersgd", "ef_compress_f32", [_P, _P, _P, _P, _P, _I, _I, _I, _I]
)
# K2b is K2a's kernel with no E and no write of M, counted on its own
COMPRESS = _build.Kernel(
    "compress", "powersgd", "ef_compress_f32", [_P, _P, _P, _P, _P, _I, _I, _I, _I]
)
ORTHOGONALIZE_PROJECT = _build.Kernel(
    "orthogonalize_project", "powersgd", "orthogonalize_project_f32",
    [_P, _P, _P, _P, _I, _I, _I, _I, _F, ctypes.POINTER(ctypes.c_int)],
)
ORTHOGONALIZE_PROJECT.last_route = None  # "one_launch" or "two_launch"
DECOMPRESS_RESIDUAL = _build.Kernel(
    "decompress_residual", "powersgd", "decompress_residual_f32",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I],
)
KERNELS = (EF_COMPRESS, COMPRESS, ORTHOGONALIZE_PROJECT, DECOMPRESS_RESIDUAL)

_ROUTES = {1: "one_launch", 2: "two_launch"}
_MAX_GROUP = 65535  # K3's grid.y and K4's grid.z


# ---- plain versions ------------------------------------------------------


def ef_compress_reference(grads: torch.Tensor, q: torch.Tensor, residuals: torch.Tensor):
    """``M = grads + residuals`` in grads' dtype, ``P = M Q`` accumulated in
    fp32 and returned in the promoted grads/q dtype."""
    m = (grads + residuals).to(grads.dtype)
    return m, compress_reference(m, q)


def compress_reference(m: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``P = M Q`` accumulated in fp32, in the promoted m/q dtype."""
    return torch.bmm(m.float(), q.float()).to(torch.result_type(m, q))


def orthogonalize_project_reference(p: torch.Tensor, m: torch.Tensor, eps: float = 1e-8):
    """``P-hat`` (K1's recurrence in fp32, returned in p's dtype) and
    ``Q = M^T P-hat`` (contracting n, fp32, in the promoted m/p dtype)."""
    phat = orthogonalize(p.float(), eps)
    q = torch.bmm(m.float().transpose(1, 2), phat).to(torch.result_type(m, p))
    return phat.to(p.dtype), q


def decompress_residual_reference(p: torch.Tensor, q: torch.Tensor, m: torch.Tensor):
    """``out = P-hat Q^T`` and ``mem = M - out``, both formed in fp32 and
    cast once to m's dtype."""
    approx = torch.bmm(p.float(), q.float().transpose(1, 2))
    return approx.to(m.dtype), (m.float() - approx).to(m.dtype)


# ---- wrappers ------------------------------------------------------------


def _on_cpu(name: str, *tensors: Optional[torch.Tensor]) -> bool:
    """True when every operand lies on the CPU, False when every one lies on
    one CUDA device; anything else raises."""
    devices = {t.device for t in tensors if t is not None}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"{name}: operands on {sorted(map(str, devices))}; need one CPU or CUDA device")


def _check(name: str, **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got {arg} in {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name}: {arg} must be a (g, rows, cols) stack, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes a contiguous {arg}")
        if t.shape[1] * t.shape[2] >= 2**31:
            raise ValueError(f"{name}: {arg} matrix of {tuple(t.shape[1:])} is too large for int indexing")


def _expect(name: str, arg: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def fused_ef_compress(
    grads: torch.Tensor, q: torch.Tensor, residuals: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``M = grads (+ residuals)``, ``P = M Q``; grads and residuals are
    ``(g, n, m)``, q ``(g, m, r)``. Returns ``(m, p)``, m in grads' dtype
    (grads itself when ``residuals`` is None) and p ``(g, n, r)``."""
    if _on_cpu("fused_ef_compress", grads, q, residuals):
        if residuals is None:
            return grads, compress_reference(grads, q)
        return ef_compress_reference(grads, q, residuals)
    _check("fused_ef_compress", grads=grads, q=q)
    (g, n, m), r = grads.shape, q.shape[2]
    _expect("fused_ef_compress", "q", q, (g, m, r))
    p = torch.empty((g, n, r), dtype=torch.float32, device=grads.device)
    if residuals is None:
        if p.numel():
            COMPRESS.launch(grads.device, grads.data_ptr(), None, q.data_ptr(), None, p.data_ptr(), g, n, m, r)
        return grads, p
    _check("fused_ef_compress", residuals=residuals)
    _expect("fused_ef_compress", "residuals", residuals, grads.shape)
    m_out = torch.empty_like(grads)
    if p.numel():
        EF_COMPRESS.launch(
            grads.device, grads.data_ptr(), residuals.data_ptr(), q.data_ptr(),
            m_out.data_ptr(), p.data_ptr(), g, n, m, r,
        )
    return m_out, p


def fused_orthogonalize_project(
    p: torch.Tensor, m: torch.Tensor, eps: float = 1e-8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gram-Schmidt on P ``(g, n, r)``, then ``Q = M^T P-hat`` with M
    ``(g, n, m)``. Returns ``(p_hat, q)``: ``(g, n, r)`` and ``(g, m, r)``."""
    if _on_cpu("fused_orthogonalize_project", p, m):
        return orthogonalize_project_reference(p, m, eps)
    _check("fused_orthogonalize_project", p=p, m=m)
    (g, n, r), mm = p.shape, m.shape[2]
    _expect("fused_orthogonalize_project", "m", m, (g, n, mm))
    if g > _MAX_GROUP:
        raise ValueError(f"fused_orthogonalize_project: a group of {g} matrices is above {_MAX_GROUP}")
    phat = torch.empty_like(p)
    q = torch.empty((g, mm, r), dtype=torch.float32, device=p.device)
    if phat.numel() and q.numel():
        route = ctypes.c_int(0)
        ORTHOGONALIZE_PROJECT.launch(
            p.device, p.data_ptr(), m.data_ptr(), phat.data_ptr(), q.data_ptr(),
            g, n, mm, r, eps, ctypes.byref(route),
        )
        ORTHOGONALIZE_PROJECT.last_route = _ROUTES[route.value]
    return phat, q


def fused_decompress_residual(
    p: torch.Tensor, q: torch.Tensor, m: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``out = P-hat Q^T`` and ``mem = M - out``; p ``(g, n, r)``, q
    ``(g, m, r)``, m ``(g, n, m)``. Returns ``(out, mem)`` in m's dtype."""
    if _on_cpu("fused_decompress_residual", p, q, m):
        return decompress_residual_reference(p, q, m)
    _check("fused_decompress_residual", p=p, q=q, m=m)
    (g, n, r), mm = p.shape, m.shape[2]
    _expect("fused_decompress_residual", "q", q, (g, mm, r))
    _expect("fused_decompress_residual", "m", m, (g, n, mm))
    if g > _MAX_GROUP:
        raise ValueError(f"fused_decompress_residual: a group of {g} matrices is above {_MAX_GROUP}")
    out, mem = torch.empty_like(m), torch.empty_like(m)
    if out.numel():
        DECOMPRESS_RESIDUAL.launch(
            m.device, p.data_ptr(), q.data_ptr(), m.data_ptr(), out.data_ptr(),
            mem.data_ptr(), g, n, mm, r,
        )
    return out, mem
