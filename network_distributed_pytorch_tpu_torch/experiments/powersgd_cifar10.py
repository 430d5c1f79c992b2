"""PowerSGD-compressed data-parallel training of a ResNet on CIFAR-10, the
reference's flagship (``ddp_powersgd_guide_cifar10``) and the port's main
path.

Preset ``full`` is the reference configuration: ResNet-152 with the
ImageNet stem at width 64, global batch 512, PowerSGD rank 4,
error-feedback SGD with momentum 0.9, lr 0.001. Preset ``small`` is
ResNet-18 with the CIFAR stem at width 16. Without CIFAR-10 on disk the
data is the deterministic synthetic stand-in; weights come from the seed.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..data.cifar10 import load_cifar10_or_synthetic
from ..models.resnet import resnet18, resnet152
from ..parallel.mesh import resolve_device
from ..parallel.reducers import PowerSGDReducer
from ..parallel.trainer import make_train_step
from ..utils.config import ExperimentConfig
from .common import (
    accumulated_batches,
    evaluate_on_test_split,
    image_classifier_loss,
    powersgd_reducer_kwargs,
    process_group,
    require_defaults,
    summarize,
    train_loop,
)


def default_config() -> ExperimentConfig:
    return ExperimentConfig(
        training_epochs=1, global_batch_size=512, learning_rate=0.001, reducer_rank=4
    )


def build_model(preset: str, device="cuda", seed: int = 0):
    if preset == "full":
        return resnet152(num_classes=10, norm="batch", stem="imagenet", device=device, seed=seed)
    if preset == "small":
        return resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device=device, seed=seed)
    raise ValueError(f"unknown preset {preset!r}")


def build(config: ExperimentConfig, preset: str, device, group):
    """The model, the training step and its initial state."""
    require_defaults(config, ("bucket_bytes",), "powersgd_cifar10")  # the exact reducer's knob
    model = build_model(preset, device, seed=config.seed)
    reducer = PowerSGDReducer(
        random_seed=config.seed,
        compression_rank=config.reducer_rank,
        reuse_query=config.reuse_query,
        matricize="last",  # the JAX package's matrices: output features last
        **powersgd_reducer_kwargs(config),
    )
    step = make_train_step(
        image_classifier_loss(),
        reducer,
        model,
        learning_rate=config.learning_rate,
        momentum=config.momentum,  # lambda of Algorithm 2
        algorithm="ef_momentum",
        group=group,
        accum_steps=config.accum_steps,
        max_grad_norm=config.max_grad_norm,
    )
    return model, step, step.init_state()


def run(
    config: Optional[ExperimentConfig] = None,
    preset: str = "small",
    data_dir: str = "./data",
    device="cuda",
    max_steps_per_epoch: Optional[int] = None,
    eval_after: bool = False,
) -> Dict:
    """Train and return the run summary. Joins the default process group
    (creating one, of ``config.num_processes`` ranks, if none exists; a
    world of one included), and leaves it as it found it. ``eval_after``
    adds ``eval_accuracy`` on the test split, from the ranks' mean BatchNorm
    statistics."""
    config = config or default_config()
    device = resolve_device(device)
    with process_group(config, device) as group:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        images, labels, is_real = load_cifar10_or_synthetic(data_dir, train=True)
        model, step, state = build(config, preset, device, group)
        batches = accumulated_batches([images, labels], config, max_steps_per_epoch)
        state, logger = train_loop(
            step, state, batches, config.training_epochs, device,
            rank=rank, world_size=world, log_every=config.log_every,
        )
        params = [p for p in model.parameters()]
        extra = {
            "preset": preset,
            "real_data": is_real,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "num_devices": world,
            "reducer_rank": config.reducer_rank,
            "bits_per_step": step.bits_per_step,
            "shape_groups": step.reducer.n_shape_groups(params),
            "losses": [r.loss for r in logger.records],
            "step_time_s": [r.step_time_s for r in logger.records],
            "device_time_ms": [r.device_time_ms for r in logger.records],
        }
        if eval_after:
            extra["eval_accuracy"] = evaluate_on_test_split(model, group, data_dir)
        return summarize("powersgd_cifar10", logger, extra)
