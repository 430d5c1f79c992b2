"""Column-sequential Gram-Schmidt, the plain PyTorch version.

The same recurrence as the JAX package's ``ops/orthogonalize.py`` (and the
reference ``reducer.py:183-191``), batched over a leading group axis: for
each column i, normalise it by ``sqrt(sum(col**2)) + eps``, then subtract
its projection from every LATER column. Not QR and not CholeskyQR, which
differ in column signs and rounding.

This is the CPU path of :func:`..ops.gram_schmidt.gram_schmidt` and the
version ``chip_smoke.py`` holds the CUDA kernel against on the card.
"""

from __future__ import annotations

import torch


def orthogonalize(matrix: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Orthonormalise the columns of ``(n, r)`` or ``(g, n, r)`` matrices.

    Returns a new tensor; the input is left unchanged."""
    if matrix.dim() not in (2, 3):
        raise ValueError(f"expected (n, r) or (g, n, r), got {tuple(matrix.shape)}")
    # the working copy is updated column by column in place
    mat = matrix.clone()
    r = mat.shape[-1]
    for i in range(r):
        col = mat[..., i : i + 1]
        col.div_(torch.sqrt(torch.sum(col * col, dim=-2, keepdim=True)) + eps)
        if i + 1 < r:
            rest = mat[..., i + 1 :]
            rest.sub_(torch.sum(col * rest, dim=-2, keepdim=True) * col)
    return mat
