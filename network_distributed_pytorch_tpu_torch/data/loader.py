"""Batch iteration over in-memory numpy datasets: a seeded, epoch-keyed
shuffle and static batch shapes (the trailing partial batch is dropped by
default), as in the JAX package's ``data/loader.py``; and
:func:`device_prefetch`, which stages upcoming batches on the device
through pinned host memory and a side stream while the step runs."""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observe.spans import span


def epoch_order(
    n: int,
    batch_size: int,
    seed: int = 0,
    epoch: int = 0,
    shuffle: bool = True,
    drop_last: bool = True,
) -> np.ndarray:
    """The epoch's example order, truncated to whole batches when
    ``drop_last``: the one source of the batch order, which both
    :func:`iterate_batches` and the native loader
    (``native.NativeBatchLoader``) consume."""
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
        # the gather of one batch on the host; it runs inside the consumer's
        # next(), so it nests under the training loop's data_load span
        with span("data_load/assemble"):
            batch = tuple(a[sel] for a in arrays)
        yield batch


def steps_per_epoch(n: int, batch_size: int, drop_last: bool = True) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


def _slots_match(host, leaves) -> bool:
    """Whether a slot's staging buffers can take ``leaves``: one buffer of
    the same shape and dtype a numpy leaf, the other leaves passed by."""
    if len(host) != len(leaves):
        return False
    for buf, a in zip(host, leaves):
        if isinstance(a, np.ndarray) != isinstance(buf, torch.Tensor):
            return False
        if isinstance(a, np.ndarray) and (tuple(buf.shape) != a.shape or buf.numpy().dtype != a.dtype):
            return False
    return True


def device_prefetch(batches, device, depth: int = 2, label: str = "train"):
    """Stage the batches of ``batches`` on ``device`` up to ``depth`` ahead
    of the consumer, the JAX package's ``device_prefetch`` on CUDA.

    Each batch (a tuple or list of numpy arrays; other leaves pass through)
    is copied into one of ``depth + 1`` staging slots of host buffers,
    reused while the shapes and dtypes match. On a ``cuda`` device:

    - the slots are **pinned** (``pin_memory=True``), and each leaf's copy
      to the card is issued with ``non_blocking=True`` on a dedicated
      ``torch.cuda.Stream``, with an event recorded after the batch's
      copies: the copy of a later batch runs off the step's stream while
      the host goes on (a loop that waits for each step's loss before it
      fetches, as ``train_loop`` does, issues it between two steps);
    - a slot is rewritten only after the event of its last copy has
      completed (the ring guarantee: no copy reads a torn buffer);
    - before a batch is yielded, the consumer's current stream waits on its
      event, and each of its tensors is ``record_stream``-ed on that stream,
      so that the caching allocator cannot hand out its memory while the
      step still reads it;
    - a failure to pin or to copy raises: nothing falls back to a
      synchronous copy.

    On a ``cpu`` device the slots are unpinned and the yielded tensors are
    copies, never views of a slot that a later batch rewrites.

    ``NDP_PREFETCH_DEPTH`` overrides ``depth`` (0: stage and yield, no
    lookahead). Each staging is a ``data_load/stage`` span. When
    ``batches`` is exhausted, one :class:`..observe.events.LoaderEvent`
    goes through the ambient recorder: batches, samples (the first array
    leaf's rows), end-to-end samples a second, the depth, and ``wait_s``,
    the time spent blocked on the upstream producer. Closing the generator
    early closes ``batches`` and waits for the copies in flight."""
    from ..observe.events import LoaderEvent
    from ..observe.spans import ambient

    env_depth = os.environ.get("NDP_PREFETCH_DEPTH")
    if env_depth:
        try:
            depth = int(env_depth)
        except ValueError:
            pass
    depth = max(int(depth), 0)
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_cuda else None
    n_slots = depth + 1
    slots: List[Optional[Tuple[list, Optional[torch.cuda.Event]]]] = [None] * n_slots

    def stage(batch, slot_i):
        with span("data_load/stage"):
            leaves = list(batch)
            slot = slots[slot_i]
            if slot is not None and slot[1] is not None:
                slot[1].synchronize()  # the ring guarantee
            if slot is None or not _slots_match(slot[0], leaves):
                host = [
                    torch.from_numpy(np.empty(0, a.dtype)).new_empty(a.shape, pin_memory=on_cuda)
                    if isinstance(a, np.ndarray) else a
                    for a in leaves
                ]
            else:
                host = slot[0]
            for j, a in enumerate(leaves):
                if isinstance(a, np.ndarray):
                    np.copyto(host[j].numpy(), a)
                else:
                    host[j] = a
            if on_cuda:
                with torch.cuda.stream(copy_stream):
                    staged = [
                        b.to(device, non_blocking=True) if isinstance(b, torch.Tensor) else b for b in host
                    ]
                    event = torch.cuda.Event()
                    event.record(copy_stream)
            else:
                staged = [b.clone() if isinstance(b, torch.Tensor) else b for b in host]
                event = None
            slots[slot_i] = (host, event)
            rows = next((len(a) for a in leaves if isinstance(a, np.ndarray)), 0)
            return type(batch)(staged), event, rows

    def hand_over(item):
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            for t in batch:
                if isinstance(t, torch.Tensor):
                    t.record_stream(consumer)
        return batch

    queue: deque = deque()
    it = iter(batches)
    slot_i = n_batches = n_samples = 0
    wait_s = 0.0
    t_start = time.monotonic()
    try:
        while True:
            t0 = time.monotonic()
            try:
                batch = next(it)
            except StopIteration:
                break
            wait_s += time.monotonic() - t0
            staged, event, rows = stage(batch, slot_i)
            slot_i = (slot_i + 1) % n_slots
            queue.append((staged, event))
            n_batches += 1
            n_samples += rows
            if len(queue) > depth:
                yield hand_over(queue.popleft())
        while queue:
            yield hand_over(queue.popleft())
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
        if copy_stream is not None:
            copy_stream.synchronize()  # no copy left in flight
    recorder = ambient()
    if recorder is not None and n_batches:
        elapsed = max(time.monotonic() - t_start, 1e-9)
        recorder.emit(
            LoaderEvent(
                label=label, batches=n_batches, samples=n_samples, samples_per_s=n_samples / elapsed,
                prefetch_depth=depth, wait_s=wait_s,
            )
        )
