"""Deterministic cross-rank dataset partitioning (reference
``partition_helper.py``): shuffle all indices with a fixed local RNG (seed
1234, not the run's seed) so every rank computes the same permutation with
no communication, then cut it into ``int(frac * len)`` chunks.

The elastic re-split of a degraded restart: :func:`elastic_assignments`
cuts the same seed-1234 permutation at any world size, and its stream form
(:class:`StreamedPermutation`, :class:`ElasticIndexStream`,
:func:`streamed_elastic_assignments`) addresses any window of a shuffled
index stream in O(1) memory from a checkpointed cursor, whatever the world
size that recorded it.

A copy of the JAX package's ``data/partition.py``; the port imports nothing
of that package. Pure integer code: every index equals the JAX package's.
"""

from __future__ import annotations

import hashlib
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class Partition:
    """Index-remapped view of a dataset."""

    def __init__(self, data, index: Sequence[int]):
        self.data = data
        self.index = list(index)

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int):
        return self.data[self.index[i]]


def split_indices(data_len: int, sizes: Sequence[float], seed: int = 1234) -> List[List[int]]:
    """Shuffle ``range(data_len)`` with ``random.Random(seed)`` and cut it
    into ``int(frac * data_len)``-long chunks."""
    rng = random.Random()
    rng.seed(seed)
    indexes = list(range(data_len))
    rng.shuffle(indexes)
    partitions: List[List[int]] = []
    for frac in sizes:
        part_len = int(frac * data_len)
        partitions.append(indexes[:part_len])
        indexes = indexes[part_len:]
    return partitions


class DataPartitioner:
    def __init__(self, data, sizes: Sequence[float] = (0.7, 0.2, 0.1), seed: int = 1234):
        self.data = data
        self.partitions = split_indices(len(data), sizes, seed=seed)

    def use(self, partition: int) -> Partition:
        return Partition(self.data, self.partitions[partition])


def partition_dataset(data, world_size: int, rank: int, seed: int = 1234) -> Partition:
    """The equal split ``sizes=[1/W]*W``, then ``use(rank)``."""
    sizes = [1.0 / world_size for _ in range(world_size)]
    return DataPartitioner(data, sizes, seed=seed).use(rank)


def elastic_assignments(
    data_len: int, world_size: int, seed: int = 1234
) -> List[List[int]]:
    """Per-rank index assignments for the equal split at ANY world size,
    all cut from the same seed-``seed`` permutation — the elastic-recovery
    re-split. When the supervisor shrinks W → W', the W' survivors call
    this with the new world and, with no reshuffle and no coordination,
    cover the same ``world_size * (data_len // world_size)`` permutation
    prefix disjointly (the whole dataset when ``world_size`` divides
    ``data_len``)."""
    return split_indices(
        data_len, [1.0 / world_size] * world_size, seed=seed
    )


def per_worker_batch_size(global_batch: int, world_size: int) -> int:
    """``bsz = int(global / float(world))``."""
    return int(global_batch / float(world_size))


# ---------------------------------------------------------------------------
# The STREAMED elastic index.
#
# ``elastic_assignments`` materializes the full Fisher-Yates permutation —
# O(data_len) memory per rank per call, fine for CIFAR, absurd for a
# billion-sample corpus. The stream form below replaces the materialized
# list with an O(1)-memory *cursor-addressable* bijection: any window of the
# shuffled index sequence is computed on demand, so a rank can resume
# mid-shard from a checkpointed cursor without replaying (or storing) the
# prefix.
#
# Guarantee class (see DESIGN.md): the streamed order is deterministic in
# (seed, data_len, epoch) and identical at every world size — but it is NOT
# bitwise-equal to the seed-1234 ``random.Random`` shuffle that
# ``split_indices`` materializes (a lazily-invertible permutation cannot be
# produced by Fisher-Yates without materializing it). Streamed runs are in
# the merge-tolerance class: sample *sets* per epoch are identical, visit
# order differs from the materialized path.
# ---------------------------------------------------------------------------

_SPLITMIX_C1 = np.uint64(0xBF58476D1CE4E5B9)
_SPLITMIX_C2 = np.uint64(0x94D049BB133111EB)


class StreamedPermutation:
    """A keyed bijection on ``[0, data_len)`` with O(1) random access.

    4-round Feistel network over the smallest even-bit-width domain
    covering ``data_len``, cycle-walked back into range (Black & Rogaway's
    format-preserving trick: out-of-range outputs are re-permuted until
    they land in range — a bijection composed with itself restricted to a
    subset is still a bijection on that subset). The domain is at most
    ``4 * data_len`` so the walk takes < 4 expected rounds; round keys are
    derived from (seed, data_len) via SHA-256 so the order is stable
    across platforms and process incarnations.

    Both directions are exposed: :meth:`apply` (position -> dataset index)
    drives the loader, :meth:`invert` (index -> position) is what lets the
    zero-drop property test verify bijectivity over a billion-element
    domain without materializing it.
    """

    ROUNDS = 4  # 4-round Feistel: PRP-strength keyed mixing (Luby-Rackoff)

    def __init__(self, data_len: int, seed: int = 1234):
        if data_len <= 0:
            raise ValueError(f"data_len must be positive, got {data_len}")
        self.data_len = int(data_len)
        self.seed = int(seed)
        bits = max((self.data_len - 1).bit_length(), 2)
        if bits % 2:
            bits += 1
        self.bits = bits
        self._hb = np.uint64(bits // 2)
        self._mask = np.uint64((1 << (bits // 2)) - 1)
        self.domain = 1 << bits
        digest = hashlib.sha256(
            f"ndp-stream-perm:{self.seed}:{self.data_len}".encode()
        ).digest()
        self._keys: Tuple[np.uint64, ...] = tuple(
            np.uint64(int.from_bytes(digest[8 * r: 8 * r + 8], "little"))
            for r in range(self.ROUNDS)
        )

    @staticmethod
    def _mix(v: np.ndarray) -> np.ndarray:
        # splitmix64 finalizer; uint64 arithmetic wraps mod 2^64 by design
        v = (v ^ (v >> np.uint64(30))) * _SPLITMIX_C1
        v = (v ^ (v >> np.uint64(27))) * _SPLITMIX_C2
        return v ^ (v >> np.uint64(31))

    def _permute(self, v: np.ndarray) -> np.ndarray:
        left, right = v >> self._hb, v & self._mask
        for key in self._keys:
            f = self._mix(right ^ key) & self._mask
            left, right = right, left ^ f
        return (left << self._hb) | right

    def _unpermute(self, v: np.ndarray) -> np.ndarray:
        left, right = v >> self._hb, v & self._mask
        for key in reversed(self._keys):
            f = self._mix(left ^ key) & self._mask
            left, right = right ^ f, left
        return (left << self._hb) | right

    def _walk(self, v: np.ndarray, step) -> np.ndarray:
        n = np.uint64(self.data_len)
        out = step(v)
        bad = out >= n
        while bad.any():
            out[bad] = step(out[bad])
            bad = out >= n
        return out

    def apply(self, offsets: np.ndarray) -> np.ndarray:
        """Dataset indices for epoch offsets (each in ``[0, data_len)``)."""
        offsets = np.asarray(offsets)
        if offsets.size and (
            offsets.min() < 0 or int(offsets.max()) >= self.data_len
        ):
            raise ValueError("offset out of range")
        with np.errstate(over="ignore"):
            return self._walk(
                offsets.astype(np.uint64), self._permute
            ).astype(np.int64)

    def invert(self, indices: np.ndarray) -> np.ndarray:
        """Epoch offsets that :meth:`apply` maps to ``indices``."""
        indices = np.asarray(indices)
        if indices.size and (
            indices.min() < 0 or int(indices.max()) >= self.data_len
        ):
            raise ValueError("index out of range")
        with np.errstate(over="ignore"):
            return self._walk(
                indices.astype(np.uint64), self._unpermute
            ).astype(np.int64)

    def window(self, start: int, stop: int) -> np.ndarray:
        """``apply`` over the contiguous offset range ``[start, stop)``."""
        return self.apply(np.arange(start, stop, dtype=np.int64))


class ElasticIndexStream:
    """The cursor-addressable stream form of :func:`elastic_assignments`.

    One global, world-size-independent stream of dataset indices: position
    ``p`` of the stream maps to epoch ``p // data_len`` shuffled with a
    per-epoch :class:`StreamedPermutation` (re-keyed with ``seed + epoch``,
    mirroring ``data.loader.epoch_order``'s reshuffle convention). A world
    of size W owns the stream by residue — position ``p`` belongs to rank
    ``p % W`` — and the only mutable coordinate is the single global
    ``cursor`` (= number of stream positions consumed by committed steps).

    That residue ownership is the whole zero-drop/zero-dup argument: for
    any cursor c and any window [c, c+G), the union of the W per-rank
    position sets is EXACTLY [c, c+G), disjointly — for every W. So a
    reshape W -> W' mid-shard needs no migration protocol at all: the
    survivors re-derive ownership from (cursor, W') and the stream
    continues with the exact sample multiset an uninterrupted run would
    have consumed (``tests/test_torch_stream_index.py``). The cursor
    is checkpointed next to ``_TOPOLOGY.json`` as ``_LOADER_STATE.json``
    (:func:`utils.checkpoint.save_checkpoint`'s ``loader_state`` tag).
    """

    STATE_SCHEMA = 1
    STATE_KIND = "elastic_index_stream"

    def __init__(self, data_len: int, seed: int = 1234):
        if data_len <= 0:
            raise ValueError(f"data_len must be positive, got {data_len}")
        self.data_len = int(data_len)
        self.seed = int(seed)
        self._perms: Dict[int, StreamedPermutation] = {}

    def _perm(self, epoch: int) -> StreamedPermutation:
        perm = self._perms.get(epoch)
        if perm is None:
            if len(self._perms) > 8:  # a stream only ever straddles 2
                self._perms.clear()
            perm = self._perms[epoch] = StreamedPermutation(
                self.data_len, seed=self.seed + epoch
            )
        return perm

    def indices_at(self, positions: np.ndarray) -> np.ndarray:
        """Dataset indices at absolute stream positions (epoch-wrapping)."""
        positions = np.asarray(positions, dtype=np.int64)
        if positions.size and positions.min() < 0:
            raise ValueError("stream positions are non-negative")
        epochs = positions // self.data_len
        offsets = positions % self.data_len
        out = np.empty(positions.shape, dtype=np.int64)
        for e in np.unique(epochs):
            m = epochs == e
            out[m] = self._perm(int(e)).apply(offsets[m])
        return out

    def shard_positions(
        self, cursor: int, world_size: int, rank: int, count: int
    ) -> np.ndarray:
        """The next ``count`` stream positions rank ``rank`` owns at or
        after ``cursor`` in a world of ``world_size`` (``p % W == rank``)."""
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world {world_size}")
        if cursor < 0:
            raise ValueError("cursor is non-negative")
        first = cursor + ((rank - cursor) % world_size)
        return first + world_size * np.arange(count, dtype=np.int64)

    def shard_indices(
        self, cursor: int, world_size: int, rank: int, count: int
    ) -> np.ndarray:
        """Dataset indices for :meth:`shard_positions` — the per-rank read."""
        return self.indices_at(
            self.shard_positions(cursor, world_size, rank, count)
        )

    # ---- checkpointable loader state ------------------------------------

    def state(self, cursor: int) -> Dict[str, Any]:
        """The ``_LOADER_STATE.json`` payload: everything a restarted (or
        resharded) world needs to resume this stream mid-shard."""
        return {
            "schema": self.STATE_SCHEMA,
            "kind": self.STATE_KIND,
            "data_len": self.data_len,
            "seed": self.seed,
            "cursor": int(cursor),
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> Tuple["ElasticIndexStream", int]:
        """Rebuild (stream, cursor) from a :meth:`state` payload."""
        if state.get("kind") != cls.STATE_KIND:
            raise ValueError(f"not an index-stream state: {state.get('kind')!r}")
        if int(state.get("schema", 0)) > cls.STATE_SCHEMA:
            raise ValueError(f"loader state schema {state['schema']} too new")
        stream = cls(int(state["data_len"]), seed=int(state["seed"]))
        return stream, int(state["cursor"])


def streamed_elastic_assignments(
    data_len: int,
    world_size: int,
    seed: int = 1234,
    cursor: int = 0,
    count: Optional[int] = None,
) -> List[np.ndarray]:
    """``elastic_assignments``'s signature, stream semantics: the next
    ``count`` dataset indices per rank starting at global stream
    ``cursor`` (default: one epoch-equal share each, the materialized
    split's shape). Unlike the materialized form this is O(count) in both
    memory and time regardless of ``data_len``, and is resumable at any
    cursor — including one recorded under a *different* world size."""
    stream = ElasticIndexStream(data_len, seed=seed)
    if count is None:
        count = data_len // world_size
    return [
        stream.shard_indices(cursor, world_size, rank, count)
        for rank in range(world_size)
    ]
