"""L2: collectives over ``torch.distributed`` with bits-on-wire accounting.

As in the JAX package, every collective takes the group it runs over, and
``group=None`` is the single-process fallback: the wrappers return their
input and nothing goes on the wire. With a group, the reduction is done IN
PLACE on the tensor passed, which is always a fresh packed payload that the
caller owns, so no second buffer of the payload's size is allocated.

Bits are counted per logical payload, ``8 * nelement * element_size``,
whatever the world size (reference ``reducer.py:197-198``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


def n_bits(x: torch.Tensor) -> int:
    """Payload size in bits: ``8 * nelement * element_size``."""
    return 8 * x.numel() * x.element_size()


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``dist.all_reduce(SUM)`` on ``x`` in place; identity without a group."""
    if group is None:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce then divide by the world size (reference
    ``reducer.py:126-128``), in place on ``x``."""
    if group is None:
        return x
    all_reduce_sum(x, group)
    return x.div_(world_size(group))


def chunk_bounds(total: int, n_chunks: int) -> List[Tuple[int, int]]:
    """``(start, end)`` bounds splitting ``total`` elements into
    ``min(n_chunks, total)`` balanced, non-empty chunks; the first
    ``total % k`` chunks carry one extra element."""
    total = int(total)
    if total <= 0:
        return []
    k = max(1, min(int(n_chunks), total))
    base, rem = divmod(total, k)
    bounds = []
    start = 0
    for i in range(k):
        end = start + base + (1 if i < rem else 0)
        bounds.append((start, end))
        start = end
    return bounds


def chunked_all_reduce_mean(
    flat: torch.Tensor,
    group,
    n_chunks: Optional[int],
    strategy: str = "interleave",
) -> torch.Tensor:
    """All-reduce-mean of a flat buffer as K collectives, one per chunk of
    :func:`chunk_bounds`, in place. ``n_chunks=None`` is one collective.

    The ``"interleave"`` strategy reduces each chunk on its own. An
    all-reduce is elementwise, so for two ranks (where a sum of two values
    does not depend on order) the result is bitwise equal to one collective
    over the whole buffer; wire bytes do not depend on K."""
    if strategy != "interleave":
        raise NotImplementedError(f"comm strategy {strategy!r} is not ported yet")
    if group is None:
        return flat
    bounds = chunk_bounds(flat.numel(), n_chunks if n_chunks is not None else 1)
    for start, end in bounds:
        # a contiguous slice is a view: each chunk is reduced in place
        all_reduce_sum(flat[start:end], group)
    return flat.div_(world_size(group))
