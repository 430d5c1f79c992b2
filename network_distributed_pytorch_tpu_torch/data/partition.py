"""Deterministic cross-rank dataset partitioning (reference
``partition_helper.py``): shuffle all indices with a fixed local RNG (seed
1234, not the run's seed) so every rank computes the same permutation with
no communication, then cut it into ``int(frac * len)`` chunks.

A copy of the JAX package's ``data/partition.py`` (lines 24-95); the port
imports nothing of that package.
"""

from __future__ import annotations

import random
from typing import List, Sequence


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


def per_worker_batch_size(global_batch: int, world_size: int) -> int:
    """``bsz = int(global / float(world))``."""
    return int(global_batch / float(world_size))
