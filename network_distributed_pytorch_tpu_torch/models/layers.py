"""flax's cast points for a compute dtype, applied to ``torch.nn`` layers
whose parameters stay fp32.

The JAX package's transformers take ``dtype`` (``compute_dtype``) as flax
does: parameters are fp32 and each layer casts at its own call.
``torch.autocast`` casts at other points, so the port's models call these
instead of the layers themselves:

- :func:`dense`: ``nn.Dense(dtype=...)``: the input, the kernel and the
  bias cast to ``dtype``, the product rounded to ``dtype``, then the bias
  added in ``dtype``;
- :func:`layer_norm`: ``nn.LayerNorm(dtype=...)``: statistics and
  normalisation in fp32, the result cast to ``dtype``;
- :func:`embed`: ``nn.Embed(dtype=...)``: the table cast to ``dtype``
  before the gather;
- :func:`attend`: ``nn.Embed.attend``: ``x`` and the table cast to
  ``dtype``, ``x @ table^T`` in ``dtype`` (a tied LM head);
- :func:`conv`: ``nn.Conv(dtype=...)``: the input and the kernel cast to
  ``dtype``, the convolution returned in ``dtype`` (cuDNN's bf16
  convolution accumulates in fp32 and rounds once);
- :func:`norm`: ``nn.BatchNorm(dtype=...)`` and ``nn.GroupNorm(dtype=...)``
  (flax's ``force_float32_reductions``): the input widened to fp32, the
  statistics and the normalisation in fp32 with the fp32 parameters (and
  BatchNorm's fp32 running statistics, updated in training), the result
  cast to ``dtype``.

And :func:`remat_call`, the transformers' rematerialisation of a block.

At ``dtype=torch.float32`` each is its layer's own forward: no cast copies.
Gradients come back to the fp32 parameters in fp32.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.config import COMPUTE_DTYPES as _NAMES

COMPUTE_DTYPES = tuple(getattr(torch, name) for name in _NAMES)


def check_compute_dtype(dtype: torch.dtype) -> None:
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype must be one of {COMPUTE_DTYPES}, got {dtype!r}")


def score_scale(head_dim: int, dtype: torch.dtype) -> float:
    """``jnp.sqrt(head_dim).astype(dtype)``: the einsum attention's divisor
    of the scores."""
    return float(torch.tensor(math.sqrt(head_dim)).to(dtype))


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float32:  # one fused call: the same sum, to fp32 rounding
        return F.linear(x.to(dtype), layer.weight, layer.bias)
    # flax rounds the product to dtype, then adds the bias in dtype
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


def layer_norm(layer: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight, layer.bias, layer.eps).to(dtype)


def embed(table: nn.Embedding, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.embedding(ids, table.weight.to(dtype))


def attend(table: nn.Embedding, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), table.weight.to(dtype))


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return layer(x)
    y = layer._conv_forward(x.to(dtype), layer.weight.to(dtype), None)
    return y if layer.bias is None else y + layer.bias.to(dtype)[:, None, None]


def norm(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return layer(x)
    return layer(x.float()).to(dtype)


def remat_call(remat: bool, fn: Callable[..., torch.Tensor], *args) -> torch.Tensor:
    """``fn(*args)``, under ``remat`` through a non-reentrant
    ``torch.utils.checkpoint`` that restores the RNG state for the replay:
    the forward keeps only ``args``, the backward recomputes ``fn`` (the
    same dropout masks) and differentiates the replay, whose saved tensors
    (``ctx.save_for_backward``) are the ones the backward reads."""
    if not remat:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=True)
