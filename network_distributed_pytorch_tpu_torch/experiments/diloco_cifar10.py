"""DiLoCo and local SGD on the CIFAR-10 workload: communication avoidance,
the other answer to the slow network the reference meets with compression
(the JAX package's ``experiments/diloco_cifar10.py``).

The model and data of ``powersgd_cifar10`` (preset ``full``: ResNet-152
with the ImageNet stem, synthetic CIFAR-10 unless it is on disk, global
batch 512), trained in sync rounds: each rank takes ``sync_every`` local
SGD steps on its slice of each global batch, then the round's parameter
delta is reduced and applied by an outer Nesterov step
(:func:`..parallel.localsgd.make_diloco_train_fn`). ``reducer="powersgd"``
compresses the outer delta at rank ``config.reducer_rank`` under error
feedback (its Gram-Schmidt is the CUDA kernel K1 on the card, once a shape
group a round); ``fragments > 1`` is streaming DiLoCo.

Only whole rounds run under ``max_steps_per_epoch`` (it floors to
``max_steps_per_epoch // sync_every`` rounds). A trailing partial round is
padded with zero batches of weight 0, not dropped; a malformed batch is
skipped, emitted as a ``DataDropEvent`` and counted in the summary's
``skipped_batches``. Every round is a ``StepEvent`` of the run's registry
(``telemetry_from_config``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.cifar10 import load_cifar10_or_synthetic
from ..data.loader import iterate_batches
from ..observe.events import DataDropEvent
from ..observe.telemetry import telemetry_from_config
from ..parallel.localsgd import make_diloco_train_fn, make_streaming_diloco_train_fn
from ..parallel.mesh import resolve_device
from ..parallel.reducers import ExactReducer, PowerSGDReducer
from ..utils.config import ExperimentConfig
from ..utils.metrics import MetricsLogger
from .common import (
    evaluate_image_classifier,
    image_classifier_loss,
    local_shard,
    compute_dtype,
    process_group,
    summarize,
)
from .powersgd_cifar10 import build_model

REDUCERS = ("exact", "powersgd")


def default_config() -> ExperimentConfig:
    return ExperimentConfig(training_epochs=1, global_batch_size=512, reducer_rank=4)


def build(config: ExperimentConfig, preset: str, device, group, sync_every: int = 8, reducer: str = "exact",
          fragments: int = 1, inner_learning_rate: float = 0.05, outer_learning_rate: float = 0.7,
          outer_momentum: float = 0.9):
    """The model, the round (DiLoCo, or streaming DiLoCo where
    ``fragments > 1``) and its initial state."""
    if reducer not in REDUCERS:
        raise ValueError(f"reducer must be one of {REDUCERS}, got {reducer!r}")
    model = build_model(preset, device, seed=config.seed, dtype=compute_dtype(config))
    red = (
        PowerSGDReducer(random_seed=config.seed, compression_rank=config.reducer_rank, matricize="last")
        if reducer == "powersgd" else ExactReducer()
    )
    common = dict(
        inner_learning_rate=inner_learning_rate, outer_learning_rate=outer_learning_rate,
        outer_momentum=outer_momentum, inner_momentum=config.momentum, sync_every=sync_every,
        reducer=red, group=group,
    )
    if fragments > 1:
        diloco = make_streaming_diloco_train_fn(image_classifier_loss(), model, num_fragments=fragments, **common)
    else:
        diloco = make_diloco_train_fn(image_classifier_loss(), model, **common)
    return model, diloco, diloco.init_state()


def run(
    config: Optional[ExperimentConfig] = None,
    preset: str = "small",
    data_dir: str = "./data",
    device="cuda",
    sync_every: int = 8,
    reducer: str = "exact",
    fragments: int = 1,
    inner_learning_rate: float = 0.05,
    outer_learning_rate: float = 0.7,
    outer_momentum: float = 0.9,
    max_steps_per_epoch: Optional[int] = None,
    eval_after: bool = False,
) -> Dict:
    """Train in rounds and return the run summary: one logged step a round,
    its loss the mean over the round's real steps, charged the round's bits
    (a streaming phase its own). ``inner_learning_rate`` is its own
    argument (the launcher's ``--lr``): local steps need a hotter rate than
    DDP's default. On CUDA, events around each round give its device time."""
    config = config or default_config()
    if max_steps_per_epoch is not None and max_steps_per_epoch < sync_every:
        raise ValueError(
            f"max_steps_per_epoch={max_steps_per_epoch} < sync_every={sync_every}: not even one sync round would run"
        )
    device = resolve_device(device)
    with process_group(config, device) as group:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        images, labels, is_real = load_cifar10_or_synthetic(data_dir, train=True)
        model, diloco, state = build(
            config, preset, device, group, sync_every, reducer, fragments,
            inner_learning_rate, outer_learning_rate, outer_momentum,
        )
        phase_bits = list(diloco.bits_per_phase) if fragments > 1 else [diloco.bits_per_round]
        telemetry = telemetry_from_config(config)
        logger = MetricsLogger(log_every=config.log_every, telemetry=telemetry)
        on_cuda = device.type == "cuda"
        max_rounds = None if max_steps_per_epoch is None else max_steps_per_epoch // sync_every
        skipped_batches = padded_slots = rounds_done = 0
        round_ms = []

        def one_round(epoch, pending, n_real):
            nonlocal rounds_done
            pad = sync_every - n_real
            zero = tuple(np.zeros_like(a) for a in pending[0])
            batches = [
                tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in local_shard(b, rank, world))
                for b in pending + [zero] * pad
            ]
            weights = [1.0] * n_real + [0.0] * pad
            logger.bits_per_step = phase_bits[rounds_done % len(phase_bits)]
            logger.start_step()
            if on_cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            _, losses = diloco(state, batches, weights=weights)
            if on_cuda:
                end.record()
            loss = float(losses.sum()) / n_real  # waits for the round
            device_ms = start.elapsed_time(end) if on_cuda else None
            if device_ms is not None:
                round_ms.append(device_ms)
            logger.end_step(epoch, loss, device_ms)
            rounds_done += 1
            return pad

        try:
            for epoch in range(config.training_epochs):
                pending, epoch_rounds = [], 0
                for bx, by in iterate_batches(
                    [images, labels], config.global_batch_size, seed=config.seed, epoch=epoch
                ):
                    if max_rounds is not None and epoch_rounds >= max_rounds:
                        pending = []
                        break
                    if len(bx) != len(by) or len(by) == 0:
                        # a malformed batch is the only one dropped (and tallied)
                        skipped_batches += 1
                        telemetry.emit(DataDropEvent(
                            label="diloco_cifar10", epoch=epoch, dropped_batches=1,
                            dropped_samples=max(len(bx), len(by)),
                            reason=f"malformed batch: {len(bx)} images vs {len(by)} labels", rank=config.process_id,
                        ))
                        continue
                    pending.append((bx, by))
                    if len(pending) == sync_every:
                        one_round(epoch, pending, sync_every)
                        pending, epoch_rounds = [], epoch_rounds + 1
                if pending:
                    padded_slots += one_round(epoch, pending, len(pending))
                logger.end_epoch(epoch, rank=rank)
        finally:
            telemetry.close()

        params = list(model.parameters())
        extra = {
            "preset": preset,
            "real_data": is_real,
            "device": torch.cuda.get_device_name(device) if on_cuda else "cpu",
            "num_devices": world,
            "global_batch": config.global_batch_size,
            "sync_every": sync_every,
            "fragments": fragments,
            "reducer": reducer,
            "reducer_rank": config.reducer_rank if reducer == "powersgd" else None,
            "rounds": rounds_done,
            "bits_per_round": max(phase_bits),  # streaming: the peak phase's
            "bits_per_step": diloco.bits_per_step,
            "shape_groups": diloco.reducer.n_shape_groups(params) if reducer == "powersgd" else None,
            "losses": [r.loss for r in logger.records],
            "round_time_s": [r.step_time_s for r in logger.records],
            "round_device_ms": round_ms,
            "padded_slots": padded_slots,
            "skipped_batches": skipped_batches,
        }
        if eval_after:
            params_now = diloco.eval_params(state)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(params_now[name])
                for name, b in diloco.eval_model_state(state).items():
                    dict(model.named_buffers())[name].copy_(b)
            test_x, test_y, _ = load_cifar10_or_synthetic(data_dir, train=False)
            extra["eval_accuracy"] = evaluate_image_classifier(model, test_x, test_y)
        return summarize("diloco_cifar10", logger, extra)
