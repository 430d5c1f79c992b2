"""Tensor parallelism: Megatron's sharded linear layers over a ``model``
mesh axis, the JAX package's ``parallel/tensor.py``.

- **column-parallel**: the weight's OUTPUT features are sharded; each rank
  computes its slice of the activations, with no communication;
- **row-parallel**: the weight's INPUT features are sharded; each rank
  holds the matching slice of the feature-sharded activations, computes a
  partial product, and ONE all-reduce (:func:`..comm.reduce_from_axis`)
  restores the replicated result.

A column -> row pair (an MLP's up and down projections, attention's q/k/v
and out projections) costs one all-reduce forward and one backward, where
the replicated input's gradient is summed over the shards
(:func:`..comm.copy_to_axis`, JAX's implicit ``pvary``).

Weights are in torch's ``nn.Linear`` layout, ``(out, in)``: a column shard
is ``(out / N, in)``, a row shard ``(out, in / N)``. The products promote
their operands as ``jnp.matmul`` does (a bf16 activation times an fp32
shard runs in fp32), which is how the JAX package's TP functions compute in
either dtype: they multiply by the parameters as stored.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .comm import copy_to_axis, reduce_from_axis

MODEL_AXIS = "model"


def promoted_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T (+ bias)`` in the promoted dtype of the operands, as
    ``jnp`` promotes ``x @ kernel + bias``."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    if bias is not None:
        dt = torch.promote_types(dt, bias.dtype)
    return F.linear(x.to(dt), weight.to(dt), None if bias is None else bias.to(dt))


def column_parallel_dense(
    x: torch.Tensor, weight_shard: torch.Tensor, bias_shard: Optional[torch.Tensor] = None, group=None
) -> torch.Tensor:
    """``x`` ``(..., in)`` replicated, ``weight_shard`` ``(out / N, in)``
    this rank's rows of the weight -> ``(..., out / N)``, feature-sharded,
    with no communication. With ``group``, ``x`` first passes through
    :func:`..comm.copy_to_axis`, so its gradient is the sum of every
    shard's part; a caller that feeds one input to several projections
    applies it once itself and passes no group."""
    return promoted_linear(copy_to_axis(x, group), weight_shard, bias_shard)


def row_parallel_dense(
    x_shard: torch.Tensor, weight_shard: torch.Tensor, bias: Optional[torch.Tensor] = None, group=None
) -> torch.Tensor:
    """``x_shard`` ``(..., in / N)``, ``weight_shard`` ``(out, in / N)``:
    the partial products summed over ``group`` by one all-reduce; the bias
    is added once, after the sum."""
    y = reduce_from_axis(promoted_linear(x_shard, weight_shard), group)
    return y if bias is None else y + bias


def tp_mlp(
    x: torch.Tensor,
    w_up_shard: torch.Tensor,
    b_up_shard: torch.Tensor,
    w_down_shard: torch.Tensor,
    b_down: torch.Tensor,
    group=None,
    activation: Callable[[torch.Tensor], torch.Tensor] = F.relu,
) -> torch.Tensor:
    """The canonical TP block: column-parallel up projection, the
    activation on the local features, row-parallel down projection (one
    all-reduce)."""
    h = activation(column_parallel_dense(x, w_up_shard, b_up_shard, group))
    return row_parallel_dense(h, w_down_shard, b_down, group)
