"""Shared experiment machinery: the reducers' keyword arguments, batches,
the loss, the epoch/step loop, evaluation and the run summary."""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..data.cifar10 import load_cifar10_or_synthetic
from ..data.loader import iterate_batches
from ..parallel.comm import all_reduce_mean, world_size
from ..parallel.mesh import DistributedConfig, initialize_distributed, shutdown_distributed
from ..parallel.packing import TensorPacker
from ..parallel.trainer import TrainState, TrainStep
from ..utils.losses import cross_entropy_loss
from ..utils.metrics import MetricsLogger


@contextlib.contextmanager
def process_group(config, device: torch.device):
    """The default process group of a run: the one that exists, or a new
    one of ``config.num_processes`` ranks (a world of one included), which
    is destroyed when the run ends."""
    own = not dist.is_initialized()
    if own:
        initialize_distributed(
            DistributedConfig(
                process_id=config.process_id,
                num_processes=config.num_processes,
                coordinator_address=config.coordinator_address,
                timeout_seconds=config.timeout_seconds,
            ),
            device,
        )
    try:
        yield dist.group.WORLD
    finally:
        if own:
            shutdown_distributed()


def require_defaults(config, names, experiment: str) -> None:
    """Raise ``ValueError`` where a field of ``config`` in ``names`` that
    ``experiment`` does not use is set to other than its default, rather
    than ignore it."""
    defaults = type(config)()
    for name in names:
        if getattr(config, name) != getattr(defaults, name):
            raise ValueError(f"{experiment} runs the default {name}={getattr(defaults, name)!r}")


def reducer_comm_kwargs(config) -> Dict[str, Any]:
    """The chunking knobs every reducer takes, from ``config``; empty when
    chunking is off (the reference's ``common.py:78-89``)."""
    if config.comm_chunks is None:
        return {}
    return {"comm_chunks": config.comm_chunks, "comm_strategy": config.comm_strategy}


def exact_reducer_kwargs(config) -> Dict[str, Any]:
    """``ExactReducer`` keyword arguments from ``config``: the chunking
    knobs and the DDP bucket target."""
    kw = reducer_comm_kwargs(config)
    if config.bucket_bytes is not None:
        kw["bucket_bytes"] = config.bucket_bytes
    return kw


def powersgd_reducer_kwargs(config) -> Dict[str, Any]:
    """``PowerSGDReducer`` keyword arguments from ``config``: the chunking
    knobs and the kernel pipelines (``compress_impl``,
    ``orthogonalize_impl``)."""
    kw = reducer_comm_kwargs(config)
    kw["compress_impl"] = config.compress_impl
    kw["orthogonalize_impl"] = config.orthogonalize_impl
    return kw


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


@torch.no_grad()
def average_model_state(model: nn.Module, group) -> None:
    """All-reduce-mean the model's floating-point buffers (BatchNorm running
    statistics) in place, before an evaluation: each rank kept the
    statistics of its own batches, and the reference evaluates their mean
    (``eval_model_state(reduce="mean")``). ``num_batches_tracked`` stays
    as it is. Nothing changes on one rank."""
    if world_size(group) == 1:
        return
    bufs = [b for b in model.buffers() if b.is_floating_point()]
    if not bufs:
        return
    packer = TensorPacker.for_tensors(bufs)
    for b, mean in zip(bufs, packer.unpack(all_reduce_mean(packer.pack(bufs), group))):
        b.copy_(mean)


@torch.no_grad()
def _accuracy(model: nn.Module, arrays, batch_size: int, predict) -> float:
    """Top-1 accuracy of ``predict(*inputs)`` over every example of
    ``arrays`` (inputs..., labels), in eval mode. ``drop_last=False``: the
    ragged last batch is scored too."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    correct = total = 0
    try:
        for batch in iterate_batches(arrays, batch_size, shuffle=False, drop_last=False):
            *inputs, labels = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in batch)
            correct += int((predict(*inputs).argmax(dim=-1) == labels).sum())
            total += len(labels)
    finally:
        model.train(was_training)
    return correct / max(total, 1)


def evaluate_image_classifier(model: nn.Module, images, labels, batch_size: int = 256) -> float:
    """Top-1 accuracy of an NHWC image classifier on every example, in eval
    mode (BatchNorm from its running statistics); the reference's
    ``common.py:491-520``."""
    return _accuracy(model, [images, labels], batch_size, model)


def evaluate_on_test_split(model: nn.Module, group, data_dir: str = "./data") -> float:
    """``evaluate_image_classifier`` on the CIFAR-10 test split (synthetic
    when it is not on disk), after the ranks' BatchNorm statistics are
    averaged (:func:`average_model_state`)."""
    average_model_state(model, group)
    images, labels, _ = load_cifar10_or_synthetic(data_dir, train=False)
    return evaluate_image_classifier(model, images, labels)


def evaluate_text_classifier(model: nn.Module, split, batch_size: int = 64) -> float:
    """Top-1 accuracy of the DistilBERT classifier on an encoded split
    (``input_ids``, ``attention_mask``, ``labels``), in eval mode with
    dropout off; the reference's ``common.py:523-544``."""
    arrays = [split["input_ids"], split["attention_mask"], split["labels"]]
    return _accuracy(model, arrays, batch_size, lambda ids, mask: model(ids, mask, deterministic=True))


def summarize(name: str, logger: MetricsLogger, extra: Optional[Dict] = None) -> Dict:
    out = {"experiment": name, **logger.summary()}
    if extra:
        out.update(extra)
    return out
