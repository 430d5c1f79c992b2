"""L2: collectives over ``torch.distributed`` with bits-on-wire accounting.

As in the JAX package, every collective takes the group it runs over, and
``group=None`` is the single-process fallback: the wrappers return their
input and nothing goes on the wire. With a group, the reduction is done IN
PLACE on the tensor passed, which is always a fresh packed payload that the
caller owns, so no second buffer of the payload's size is allocated.

Bits are counted per logical payload, ``8 * nelement * element_size``,
whatever the world size (reference ``reducer.py:197-198``).

A mean is the sum times the reciprocal of the world size in the payload's
dtype: the JAX package's ``pmean`` and its ring's ``/ W`` compile to that
product (XLA turns a division by a constant into it), so the port's means
are the JAX package's bit for bit; at 2 and 4 ranks it is the division.

A flat payload can ride K collectives (:func:`chunked_all_reduce_mean`),
either as K all-reduces (``"interleave"``) or as K explicit rings of
point-to-point sends (``"ring"``, :func:`ring_all_reduce_mean`), and the
exact reducer's DDP-style buckets come from :func:`bucket_assignments`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.config import COMM_STRATEGIES


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


def _scale_to_mean_(x: torch.Tensor, world: int) -> torch.Tensor:
    """A sum over ``world`` ranks, in place, times ``1 / world``."""
    return x.mul_(1.0 / world)


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce then scale by the world size (reference
    ``reducer.py:126-128``), in place on ``x``."""
    if group is None:
        return x
    all_reduce_sum(x, group)
    return _scale_to_mean_(x, world_size(group))


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


def bucket_assignments(sizes_bytes: Sequence[int], bucket_bytes: int) -> List[List[int]]:
    """Leaf indices in buckets of about ``bucket_bytes``, walking the leaves
    in REVERSE order and closing a bucket once it reaches the target (the
    reference's ``comm.py:247-280``). Over ``model.parameters()`` order the
    reverse is the order in which the backward pass produces gradients,
    torch DDP's bucket order. Every bucket is non-empty and keeps its
    indices ascending; the target clamps to at least 1 byte, and one at or
    above the total gives one bucket."""
    target = max(1, int(bucket_bytes))
    buckets: List[List[int]] = []
    cur: List[int] = []
    acc = 0
    for i in reversed(range(len(sizes_bytes))):
        cur.append(i)
        acc += int(sizes_bytes[i])
        if acc >= target:
            buckets.append(sorted(cur))
            cur, acc = [], 0
    if cur:
        buckets.append(sorted(cur))
    return buckets


def _exchange(send: torch.Tensor, recv: torch.Tensor, group, rank: int, world: int) -> None:
    """Send ``send`` to the next rank of the ring and receive ``recv`` from
    the previous one, both in flight at once (a blocking send before a
    receive, in the same order on every rank, would deadlock)."""
    nxt = dist.get_global_rank(group, (rank + 1) % world)
    prev = dist.get_global_rank(group, (rank - 1) % world)
    ops = [dist.P2POp(dist.isend, send, nxt, group), dist.P2POp(dist.irecv, recv, prev, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def ring_all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce-mean as the explicit ring of the reference
    (``comm.py:373-414``), in place on ``x``: a reduce-scatter of W-1
    steps, then an all-gather of W-1 steps, each step a send to rank
    ``(rank + 1) % W`` and a receive from ``(rank - 1) % W``. The payload is
    padded to ``W * ceil(n / W)`` and cut back.

    Every rank follows the reference's schedule step for step: shard ``s``
    starts on rank ``s`` and each rank round the ring adds its own part to
    the partial sum it receives, so the sums are the reference's bit for
    bit. Against one all-reduce the sum is reassociated: exact on dyadic
    values, about 1 ulp off otherwise. Identity without a group, at world 1
    or on an empty payload."""
    world = world_size(group)
    if world == 1 or x.numel() == 0:
        return x
    rank = dist.get_rank(group)
    n = x.numel()
    shard = -(-n // world)
    buf = torch.zeros(world * shard, dtype=x.dtype, device=x.device)
    buf[:n] = x.reshape(-1)
    buf = buf.view(world, shard)
    recv = torch.empty(shard, dtype=x.dtype, device=x.device)
    # reduce-scatter: at step t rank i sends its running shard (i - t) and
    # adds the received shard (i - t - 1) to its own; after W - 1 steps
    # shard (i + 1) % W is complete on rank i
    for t in range(world - 1):
        _exchange(buf[(rank - t) % world], recv, group, rank, world)
        buf[(rank - t - 1) % world].add_(recv)
    # all-gather: pass the completed shards on; at step t rank i receives
    # shard (i - t) % W
    cur = buf[(rank + 1) % world].clone()
    for t in range(world - 1):
        _exchange(cur, recv, group, rank, world)
        buf[(rank - t) % world].copy_(recv)
        cur, recv = recv, cur
    x.copy_(_scale_to_mean_(buf.view(-1)[:n], world).view(x.shape))
    return x


def chunked_all_reduce_mean(
    flat: torch.Tensor,
    group,
    n_chunks: Optional[int],
    strategy: str = "interleave",
) -> torch.Tensor:
    """All-reduce-mean of a flat buffer as K collectives, one per chunk of
    :func:`chunk_bounds`, in place. ``n_chunks=None`` is one collective.

    ``"interleave"`` all-reduces each chunk on its own. An all-reduce is
    elementwise, so where the collective's summation order does not depend
    on the payload's size (two ranks, or dyadic values) the result is
    bitwise equal to one collective over the whole buffer. ``"ring"`` runs
    :func:`ring_all_reduce_mean` on each chunk. Wire bytes do not depend on
    K or the strategy."""
    if strategy not in COMM_STRATEGIES:
        raise ValueError(f"comm strategy must be one of {COMM_STRATEGIES}, got {strategy!r}")
    if group is None:
        return flat
    bounds = chunk_bounds(flat.numel(), n_chunks if n_chunks is not None else 1)
    # a contiguous slice is a view: each chunk is reduced in place
    if strategy == "ring":
        for start, end in bounds:
            ring_all_reduce_mean(flat[start:end], group)
        return flat
    for start, end in bounds:
        all_reduce_sum(flat[start:end], group)
    return _scale_to_mean_(flat, world_size(group))
