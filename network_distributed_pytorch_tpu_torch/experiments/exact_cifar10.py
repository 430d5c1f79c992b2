"""Exact all-reduce DDP of a ResNet on CIFAR-10, the reference's
``ddp_guide_cifar10`` and the JAX package's ``experiments/exact_cifar10.py``:
the uncompressed baseline that PowerSGD is compared against.

Preset ``full`` is the reference configuration: ResNet-50 with the ImageNet
stem at width 64 (23,528,522 parameters in 161 tensors), global batch 256,
torch-style SGD with lr 0.001 and momentum 0.9, the gradients averaged by
the exact reducer after every backward. Preset ``small`` is ResNet-18 with
the CIFAR stem at width 16. The reducer takes the configuration's
``comm_chunks``, ``comm_strategy`` and ``bucket_bytes``. Without CIFAR-10
on disk the data is the deterministic synthetic stand-in; weights come from
the seed.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..data.cifar10 import load_cifar10_or_synthetic
from ..models.resnet import resnet18, resnet50
from ..parallel.mesh import resolve_device
from ..parallel.reducers import ExactReducer
from ..parallel.trainer import make_train_step
from ..utils.config import ExperimentConfig
from .common import (
    accumulated_batches,
    evaluate_on_test_split,
    exact_reducer_kwargs,
    image_classifier_loss,
    process_group,
    summarize,
    train_loop,
)

STRATEGIES = ("ddp", "fsdp")


def default_config() -> ExperimentConfig:
    return ExperimentConfig(training_epochs=1, global_batch_size=256, learning_rate=0.001)


def build_model(preset: str, device="cuda", seed: int = 0):
    if preset == "full":
        return resnet50(num_classes=10, norm="batch", stem="imagenet", device=device, seed=seed)
    if preset == "small":
        return resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device=device, seed=seed)
    raise ValueError(f"unknown preset {preset!r}")


def build(config: ExperimentConfig, preset: str, device, group, pretrained_state_dict=None):
    """The model (from ``pretrained_state_dict`` where one is given, e.g.
    from ``models.import_weights``, else from the seed), the training step
    and its initial state."""
    model = build_model(preset, device, seed=config.seed)
    if pretrained_state_dict is not None:
        model.load_state_dict(pretrained_state_dict)
    step = make_train_step(
        image_classifier_loss(),
        ExactReducer(**exact_reducer_kwargs(config)),
        model,
        learning_rate=config.learning_rate,
        momentum=config.momentum,
        algorithm="sgd",  # the reference's optim.SGD(lr, momentum=0.9)
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
    strategy: str = "ddp",
    checkpoint_dir: Optional[str] = None,
    pretrained_state_dict=None,
) -> Dict:
    """Train and return the run summary. Joins the default process group
    (creating one, of ``config.num_processes`` ranks, if none exists; a
    world of one included), and leaves it as it found it. ``eval_after``
    adds ``eval_accuracy`` on the test split, from the ranks' mean BatchNorm
    statistics.

    ``strategy="ddp"`` is the reference's replicated exact DDP. The JAX
    package's ``strategy="fsdp"``, ``checkpoint_dir`` (the checkpointed
    loop), ``config.adaptive_comm`` and ``config.chaos_plan`` are not
    ported yet and raise."""
    config = config or default_config()
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {strategy!r}")
    if strategy == "fsdp":
        raise NotImplementedError("strategy='fsdp' is not ported yet")
    if checkpoint_dir is not None:
        raise NotImplementedError("checkpoint_dir (the checkpointed training loop) is not ported yet")
    if config.adaptive_comm or config.chaos_plan:
        raise NotImplementedError("adaptive_comm and chaos_plan are not ported yet")
    device = resolve_device(device)
    with process_group(config, device) as group:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        images, labels, is_real = load_cifar10_or_synthetic(data_dir, train=True)
        model, step, state = build(config, preset, device, group, pretrained_state_dict)
        batches = accumulated_batches([images, labels], config, max_steps_per_epoch)
        state, logger = train_loop(
            step, state, batches, config.training_epochs, device,
            rank=rank, world_size=world, log_every=config.log_every,
        )
        extra = {
            "preset": preset,
            "real_data": is_real,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "num_devices": world,
            "strategy": strategy,
            "bits_per_step": step.bits_per_step,
            "n_collectives": step.reducer.n_collectives(list(model.parameters())),
            "losses": [r.loss for r in logger.records],
            "step_time_s": [r.step_time_s for r in logger.records],
            "device_time_ms": [r.device_time_ms for r in logger.records],
        }
        if eval_after:
            extra["eval_accuracy"] = evaluate_on_test_split(model, group, data_dir)
        return summarize("exact_cifar10", logger, extra)
