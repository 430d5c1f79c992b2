"""Batch iteration over in-memory numpy datasets: a seeded, epoch-keyed
shuffle and static batch shapes (the trailing partial batch is dropped by
default), as in the JAX package's ``data/loader.py``. Batches stay numpy;
the training loop moves them to the device."""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np


def epoch_order(
    n: int,
    batch_size: int,
    seed: int = 0,
    epoch: int = 0,
    shuffle: bool = True,
    drop_last: bool = True,
) -> np.ndarray:
    """The epoch's example order, truncated to whole batches when ``drop_last``."""
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(idx)
    end = (n // batch_size) * batch_size if drop_last else n
    return idx[:end]


def iterate_batches(
    arrays: Sequence[np.ndarray],
    batch_size: int,
    seed: int = 0,
    epoch: int = 0,
    shuffle: bool = True,
    drop_last: bool = True,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Yield aligned minibatch tuples from equal-length arrays."""
    n = len(arrays[0])
    for a in arrays:
        if len(a) != n:
            raise ValueError("batch arrays must be aligned")
    idx = epoch_order(n, batch_size, seed, epoch, shuffle, drop_last)
    for start in range(0, len(idx), batch_size):
        sel = idx[start : start + batch_size]
        yield tuple(a[sel] for a in arrays)


def steps_per_epoch(n: int, batch_size: int, drop_last: bool = True) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)
