"""Shared experiment machinery: batches, the loss, the epoch/step loop and
the run summary."""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..data.loader import iterate_batches
from ..parallel.trainer import TrainState, TrainStep
from ..utils.losses import cross_entropy_loss
from ..utils.metrics import MetricsLogger


def accumulated_batches(
    arrays, config, max_steps_per_epoch: Optional[int] = None
) -> Callable[[int], Iterator[Tuple[np.ndarray, ...]]]:
    """Per-epoch generator of global batches honouring ``config.accum_steps``:
    ``(global_batch, ...)`` arrays, or ``(accum, global_batch / accum, ...)``
    when accumulating."""
    k = config.accum_steps
    if k < 1:
        raise ValueError(f"accum_steps must be >= 1, got {k}")
    if config.global_batch_size % k != 0:
        raise ValueError(
            f"global_batch_size {config.global_batch_size} is not divisible by accum_steps {k}"
        )

    def gen(epoch: int):
        it = iterate_batches(arrays, config.global_batch_size, seed=config.seed, epoch=epoch)
        for i, batch in enumerate(it):
            if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                return
            if k > 1:
                batch = tuple(a.reshape((k, a.shape[0] // k) + a.shape[1:]) for a in batch)
            yield batch

    return gen


def local_shard(batch, rank: int, world_size: int, accum_steps: int = 1):
    """This rank's contiguous slice of a global batch, as the JAX package's
    mesh shards the batch axis (axis 1 behind the accumulation axis)."""
    axis = 0 if accum_steps == 1 else 1
    out = []
    for a in batch:
        if a.shape[axis] % world_size:
            raise ValueError(f"batch of {a.shape[axis]} does not split over {world_size} ranks")
        b = a.shape[axis] // world_size
        out.append(a[rank * b : (rank + 1) * b] if axis == 0 else a[:, rank * b : (rank + 1) * b])
    return tuple(out)


def image_classifier_loss():
    """The trainer's loss for NHWC image classifiers: cross-entropy of
    ``model(x)`` against integer labels."""

    def loss_fn(model, batch):
        x, y = batch
        return cross_entropy_loss(model(x), y)

    return loss_fn


def train_loop(
    step: TrainStep,
    state: TrainState,
    batches_for_epoch: Callable[[int], Iterator[Any]],
    epochs: int,
    device: torch.device,
    rank: int = 0,
    world_size: int = 1,
    log_every: int = 0,
) -> Tuple[TrainState, MetricsLogger]:
    """Run ``epochs`` passes over the global batches, each rank stepping on
    its own slice. Logs loss, step time and cumulative bits per step; the
    host clock spans the step until its loss is on the host, and on CUDA a
    pair of events around the step gives its device time."""
    logger = MetricsLogger(bits_per_step=step.bits_per_step, log_every=log_every)
    on_cuda = device.type == "cuda"
    for epoch in range(epochs):
        for batch in batches_for_epoch(epoch):
            batch = local_shard(batch, rank, world_size, step.accum_steps)
            batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in batch)
            logger.start_step()
            if on_cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            state, loss = step(state, batch)
            if on_cuda:
                end.record()
            loss = loss.item()  # waits for the step
            logger.end_step(epoch, loss, start.elapsed_time(end) if on_cuda else None)
        logger.end_epoch(epoch, rank=rank)
    return state, logger


def summarize(name: str, logger: MetricsLogger, extra: Optional[Dict] = None) -> Dict:
    out = {"experiment": name, **logger.summary()}
    if extra:
        out.update(extra)
    return out
