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
:func:`all_gather` stacks the ranks' payloads, as the gather-based
compressors of :mod:`.compression` send them.

The model-parallel layers (``parallel/tensor.py``, ``sequence.py``,
``pipeline.py``, ``moe.py``) differentiate through their collectives, as
the JAX package differentiates through ``shard_map``. Each such collective
is a ``torch.autograd.Function`` here, with the backward that JAX's
transpose gives it:

- :func:`copy_to_axis` (identity; backward all-reduce) and
  :func:`reduce_from_axis` (all-reduce; backward identity), the conjugate
  pair of a sum over an axis. A replicated value that meets a sharded
  weight passes through :func:`copy_to_axis`, where JAX's implicit
  ``pvary`` transposes to a ``psum``; a ``psum`` of partial results is
  :func:`reduce_from_axis`, whose transpose hands each rank the
  replicated cotangent;
- :func:`ppermute` (``lax.ppermute``: ``batch_isend_irecv`` pairs; backward
  the inverse permutation) and :func:`exchange`, its one-sided form for a
  schedule whose ranks are at different steps (the 1F1B pipeline);
- :func:`all_to_all` (``lax.all_to_all`` tiled; backward the inverse
  all-to-all);
- :func:`all_gather_tiled` (``lax.all_gather`` tiled; backward a
  reduce-scatter), and :func:`chunked_all_gather_tiled`, the same gather
  of a flat shard as K collectives (FSDP's ``comm_chunks``), each with its
  own reduce-scatter backward.

Every collective of the port is issued here, and :func:`record_collectives`
records each one (its kind, the group's ranks and its payload bytes): the
port's counterpart of the JAX package's HLO audit
(``utils/hlo_audit.collective_summary``). With no recorder open, recording
costs one test of an empty list a collective.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.config import COMM_STRATEGIES


def n_bits(x: torch.Tensor) -> int:
    """Payload size in bits: ``8 * nelement * element_size``."""
    return 8 * x.numel() * x.element_size()


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


@dataclass(frozen=True)
class CollectiveRecord:
    """One collective as :func:`record_collectives` saw it. ``kind`` is
    ``"all-reduce"``, ``"all-gather"``, ``"reduce-scatter"``,
    ``"all-to-all"``, ``"collective-permute"`` (a :func:`ppermute`, or one
    tensor an :func:`exchange` sends) or ``"send/recv"`` (one step of the
    explicit ring: a send to the next rank and a receive from the previous
    one), or the kind an :func:`agree` was given (a flag or a number the
    ranks agree on, outside any step's payload); ``ranks`` are the group's
    global ranks. ``payload_bytes`` follows the JAX audit's conventions: an
    all-reduce, an all-to-all and a permute count their payload, an
    all-gather its gathered result (the group's size times each rank's
    contribution), a reduce-scatter the buffer it reduces, a ring step the
    shard it sends."""

    kind: str
    ranks: Tuple[int, ...]
    payload_bytes: int

    @property
    def group_size(self) -> int:
        return len(self.ranks)


_RECORDERS: List[List[CollectiveRecord]] = []


@contextlib.contextmanager
def record_collectives() -> Iterator[List[CollectiveRecord]]:
    """Record every collective issued through this module while the context
    is open, in issue order, into the list it yields. Contexts nest: each
    open one records every collective."""
    records: List[CollectiveRecord] = []
    _RECORDERS.append(records)
    try:
        yield records
    finally:
        _RECORDERS.remove(records)


def recorded_bits(records: Sequence[CollectiveRecord]) -> int:
    """Bits on the wire of ``records``: ``8 * sum(payload_bytes)``."""
    return 8 * sum(r.payload_bytes for r in records)


def _record(kind: str, group, payload_bytes: int) -> None:
    if _RECORDERS:
        rec = CollectiveRecord(kind, tuple(dist.get_process_group_ranks(group)), int(payload_bytes))
        for records in _RECORDERS:
            records.append(rec)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``dist.all_reduce(SUM)`` on ``x`` in place; identity without a group."""
    if group is None:
        return x
    _record("all-reduce", group, x.numel() * x.element_size())
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` stacked on a new leading axis, ``(W,) + x.shape``,
    in rank order (the JAX package's ``all_gather_replicated``): the same
    tensor on every rank. Without a group, ``x[None]``. The payload is sent
    in its own dtype (uint8 bitmaps, int8 levels, int32 indices), never
    widened."""
    if group is None:
        return x[None]
    world = world_size(group)
    out = torch.empty((world,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    _record("all-gather", group, out.numel() * out.element_size())
    # the list form, into views of one buffer: Gloo has no all_gather_into_tensor
    dist.all_gather(list(out.unbind(0)), x.contiguous(), group=group)
    return out


def agree(value: int, group, op: str = "max", kind: str = "agree") -> int:
    """The ranks' max (or ``op="min"``) of one int32 each, the same on every
    rank: how the ranks agree on a flag (a preemption one rank was sent, a
    write that failed on one) or a number (rank 0's pid). On a NCCL group
    the int rides a tensor on the current CUDA device. The result is read
    on the host, so every rank has passed the call once any has returned.
    Recorded under ``kind``, apart from the reducers' all-reduces; without
    a group, ``value``."""
    if group is None:
        return int(value)
    if op not in ("max", "min"):
        raise ValueError(f"op must be 'max' or 'min', got {op!r}")
    on_nccl = "nccl" in str(dist.get_backend(group))
    device = torch.device("cuda", torch.cuda.current_device()) if on_nccl else torch.device("cpu")
    x = torch.tensor([int(value)], dtype=torch.int32, device=device)
    _record(kind, group, x.numel() * x.element_size())
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.MIN, group=group)
    return int(x.item())


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
    _record("send/recv", group, send.numel() * send.element_size())
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


# ---- differentiable collectives (the model-parallel layers) -------------------


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: the sum of ``x`` over ``group``."""
    return all_reduce_sum(x.contiguous().clone(), group)


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_axis(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the cotangent over ``group``.
    Where a value that is the same on every rank of the axis feeds a
    sharded computation, its gradient is the sum of the shards' parts."""
    return x if group is None else _CopyToAxis.apply(x, group)


def reduce_from_axis(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (``lax.psum``), into a new tensor;
    the backward passes the cotangent through, since the sum is the same
    on every rank and each rank's part reaches it once."""
    return x if group is None else _ReduceFromAxis.apply(x, group)


def _p2p(sends, recvs, group) -> None:
    """Post every send ``(tensor, group rank)`` and receive ``(buffer,
    group rank)`` of this rank in one ``batch_isend_irecv`` and wait for
    all: a send that waited for its receive before the next was posted
    could deadlock a ring."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), dist.get_global_rank(group, r), group) for t, r in sends]
    ops += [dist.P2POp(dist.irecv, b, dist.get_global_rank(group, r), group) for b, r in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _permute(x: torch.Tensor, perm, group) -> torch.Tensor:
    world = world_size(group)
    me = 0 if group is None else dist.get_rank(group)
    x = x.contiguous()
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    sends, recvs = [], []
    for src, dst in perm:
        if not (0 <= src < world and 0 <= dst < world):
            raise ValueError(f"permutation pair {(src, dst)} outside a group of {world}")
        if src == dst == me:
            out.copy_(x)
        elif src == me:
            sends.append((x, dst))
        elif dst == me:
            recvs.append((out, src))
    if group is not None:
        _record("collective-permute", group, x.numel() * x.element_size())
        _p2p(sends, recvs, group)
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _permute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, [(d, s) for s, d in ctx.perm], ctx.group), None, None


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]], group) -> torch.Tensor:
    """``lax.ppermute``: rank ``src`` of ``group`` sends ``x`` to rank
    ``dst`` for each ``(src, dst)`` of ``perm``; a rank that receives
    nothing gets zeros. Every rank of the group calls it with the same
    ``perm``; its sends and receives are posted together. The backward
    sends the cotangent along the inverse permutation. ``group=None`` is a
    group of one."""
    return _Ppermute.apply(x, tuple(tuple(p) for p in perm), group)


def exchange(sends, recvs, group) -> None:
    """The one-sided form of :func:`ppermute`, for a schedule whose ranks
    are at different steps: send each ``(tensor, group rank)`` of
    ``sends`` and receive into each ``(buffer, group rank)`` of ``recvs``,
    all posted in one ``batch_isend_irecv``. Each send is recorded as one
    ``"collective-permute"`` on the sending rank."""
    for t, _ in sends:
        _record("collective-permute", group, t.numel() * t.element_size())
    _p2p([(t.detach(), r) for t, r in sends], recvs, group)


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    world = world_size(group)
    if x.shape[split_dim] % world:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not split over {world} ranks")
    if group is None:
        return x
    _record("all-to-all", group, x.numel() * x.element_size())
    send = torch.stack(x.chunk(world, dim=split_dim)).contiguous()  # (world, ...): chunk j goes to rank j
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)  # rank i's chunk at place i


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, concat_dim, split_dim, ctx.group), None, None, None


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: ``x`` is cut into ``W`` equal
    chunks along ``split_dim``, chunk ``j`` goes to rank ``j``, and the
    chunks a rank receives are concatenated along ``concat_dim`` in rank
    order. The backward is the inverse all-to-all."""
    split_dim %= x.dim()
    concat_dim %= x.dim()
    return _AllToAll.apply(x, split_dim, concat_dim, group)


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(all_gather(x.contiguous(), group).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        world = world_size(ctx.group)
        chunks = g.chunk(world, dim=ctx.dim)
        flat = torch.cat([c.reshape(-1) for c in chunks])  # rank r's slice at place r
        out = torch.empty(flat.numel() // world, dtype=g.dtype, device=g.device)
        _record("reduce-scatter", ctx.group, flat.numel() * flat.element_size())
        dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM, group=ctx.group)
        return out.view(chunks[0].shape), None, None


def all_gather_tiled(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)``: the ranks' ``x`` concatenated
    along ``dim`` in rank order. The backward reduce-scatters the
    cotangent: rank ``r`` gets the sum over ranks of its own slice."""
    return x if group is None else _AllGatherTiled.apply(x, dim % x.dim(), group)


def chunked_all_gather_tiled(x: torch.Tensor, group, n_chunks: Optional[int]) -> torch.Tensor:
    """:func:`all_gather_tiled` of a flat ``x`` (the reference FSDP's
    chunked parameter gather, its ``parallel/fsdp.py:215-230``): ``x`` is
    cut into the pieces of :func:`chunk_bounds` and each piece is gathered
    by a collective of its own; the ``(W, piece)`` results are laid side by
    side as ``(W, n)`` and flattened, so the result is the monolithic
    gather's, in rank order. Each piece's backward is its own
    reduce-scatter. ``n_chunks=None`` (or one piece) is one collective.

    The JAX package fences each piece to the previous gather so that XLA
    keeps the pieces in order; eager PyTorch issues collectives in program
    order on one stream, so nothing here needs a fence."""
    if group is None:
        return x
    bounds = chunk_bounds(x.numel(), n_chunks if n_chunks is not None else 1)
    if len(bounds) <= 1:
        return all_gather_tiled(x, 0, group)
    world = world_size(group)
    # split's backward concatenates the pieces' gradients: no sum of zeros
    pieces = x.split([end - start for start, end in bounds])
    gathered = [all_gather_tiled(p, 0, group).view(world, p.numel()) for p in pieces]
    return torch.cat(gathered, dim=1).reshape(-1)
