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

``checkpoint_dir`` runs the training through
:func:`.common.resilient_train_loop`: a committed checkpoint at every
epoch, resume on entry, a topology record of the world, and a
``PreemptionGuard`` that turns a SIGTERM into an emergency checkpoint and
an exit with ``PREEMPT_EXIT_CODE`` (75).

``strategy="fsdp"`` runs the same workload with parameters, gradients and
momenta sharded over the ranks (ZeRO-3, :mod:`..parallel.fsdp`): the same
exact data-parallel SGD, each rank's model and optimizer memory about
``1 / world`` of DDP's.

Every path emits through the registry of ``telemetry_from_config``
(``event_log``), with ``trace_dir``, ``audit_wire`` and ``health_every``
as :func:`.common.train_loop` takes them (the FSDP step has no health
probe, as the JAX package's has none).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..data.cifar10 import load_cifar10_or_synthetic
from ..models.resnet import resnet18, resnet50
from ..observe.telemetry import audit_from_config, telemetry_from_config
from ..parallel.comm import recorded_bits
from ..parallel.fsdp import make_fsdp_train_step
from ..parallel.mesh import resolve_device
from ..parallel.reducers import ExactReducer
from ..parallel.trainer import make_train_step
from ..utils.config import ExperimentConfig
from .common import (
    RecordedStep,
    accumulated_batches,
    collective_audit,
    evaluate_image_classifier,
    evaluate_on_test_split,
    exact_reducer_kwargs,
    image_classifier_loss,
    compute_dtype,
    process_group,
    resilient_train_loop,
    summarize,
    train_loop,
)

STRATEGIES = ("ddp", "fsdp")


def default_config() -> ExperimentConfig:
    return ExperimentConfig(training_epochs=1, global_batch_size=256, learning_rate=0.001)


def build_model(preset: str, device="cuda", seed: int = 0, dtype=torch.float32):
    if preset == "full":
        return resnet50(num_classes=10, norm="batch", stem="imagenet", device=device, seed=seed, dtype=dtype)
    if preset == "small":
        return resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device=device, seed=seed, dtype=dtype)
    raise ValueError(f"unknown preset {preset!r}")


def check_fsdp(config: ExperimentConfig, checkpoint_dir: Optional[str] = None) -> None:
    """The reference's refusals under ``strategy="fsdp"``, with its
    messages (its ``exact_cifar10.py:102-123``)."""
    if config.adaptive_comm:
        raise ValueError(
            "adaptive_comm requires strategy='ddp' (the fallback ladder swaps reducers; the FSDP step has no"
            " reducer to swap)"
        )
    if config.accum_steps > 1:
        raise ValueError("accum_steps is not supported with strategy='fsdp'")
    if config.max_grad_norm is not None:
        raise ValueError("max_grad_norm is not supported with strategy='fsdp'")
    if checkpoint_dir is not None:
        raise ValueError(
            "checkpoint_dir requires strategy='ddp' (the FSDP carry restores via restore_checkpoint_sharded,"
            " not this loop)"
        )
    if config.comm_strategy != "interleave":
        raise ValueError("strategy='fsdp' pipelines via chunked gathers; only comm_strategy='interleave' applies")


def build(config: ExperimentConfig, preset: str, device, group, pretrained_state_dict=None, strategy: str = "ddp"):
    """The model (from ``pretrained_state_dict`` where one is given, e.g.
    from ``models.import_weights``, else from the seed), the training step
    of ``strategy`` and its initial state. Under ``"fsdp"`` the state holds
    this rank's shards and the model's own parameters are released."""
    model = build_model(preset, device, seed=config.seed, dtype=compute_dtype(config))
    if pretrained_state_dict is not None:
        model.load_state_dict(pretrained_state_dict)
    if strategy == "fsdp":
        check_fsdp(config)
        step = make_fsdp_train_step(
            image_classifier_loss(), model, learning_rate=config.learning_rate, momentum=config.momentum,
            algorithm="sgd", group=group, comm_chunks=config.comm_chunks,
        )
        return model, step, step.init_state()
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
    keep_last: Optional[int] = None,
) -> Dict:
    """Train and return the run summary. Joins the default process group
    (creating one, of ``config.num_processes`` ranks, if none exists; a
    world of one included), and leaves it as it found it. ``eval_after``
    adds ``eval_accuracy`` on the test split, from the ranks' mean BatchNorm
    statistics.

    ``strategy="ddp"`` is the reference's replicated exact DDP;
    ``strategy="fsdp"`` shards parameters, gradients and momenta over the
    ranks (the reference's refusals under it in :func:`check_fsdp`, before
    any rendezvous), and its summary's ``bits_per_step`` and
    ``collectives`` are what the first step issued
    (``comm.record_collectives``); it evaluates the unsharded parameters
    with the ranks' mean BatchNorm statistics.

    ``checkpoint_dir`` trains through the checkpointed loop (the
    reference's ``:200-245``): every epoch committed there (``keep_last``
    keeps the newest K), the newest resumed on entry (the summary's
    ``start_epoch``), each checkpoint tagged with ``make_topology`` of the
    world, and under a ``PreemptionGuard``: a SIGTERM saves at the next
    step and exits with ``SystemExit(PREEMPT_EXIT_CODE)``. The JAX
    package's ``config.adaptive_comm`` and ``config.chaos_plan`` are not
    ported yet and raise."""
    config = config or default_config()
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {strategy!r}")
    if strategy == "fsdp":
        check_fsdp(config, checkpoint_dir)
    if config.adaptive_comm or config.chaos_plan:
        raise NotImplementedError("adaptive_comm and chaos_plan are not ported yet")
    device = resolve_device(device)
    with process_group(config, device) as group:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        images, labels, is_real = load_cifar10_or_synthetic(data_dir, train=True)
        model, step, state = build(config, preset, device, group, pretrained_state_dict, strategy)
        if strategy == "fsdp":
            step = RecordedStep(step)
        batches = accumulated_batches([images, labels], config, max_steps_per_epoch)
        extra = {}
        telemetry = telemetry_from_config(config)
        loop_kw = dict(
            rank=rank, world_size=world, log_every=config.log_every, telemetry=telemetry,
            trace_dir=config.trace_dir, audit=audit_from_config(config), run_name="exact_cifar10",
            health_every=config.health_every,
        )
        try:
            if checkpoint_dir is not None:
                from ..resilience import PREEMPT_EXIT_CODE, PreemptionGuard, incarnation_from_env, make_topology

                incarnation = incarnation_from_env()
                with PreemptionGuard(
                    telemetry=telemetry, rank=rank, incarnation=incarnation, label="exact_cifar10"
                ) as guard:
                    state, logger, extra["start_epoch"] = resilient_train_loop(
                        step, state, batches, config.training_epochs, checkpoint_dir, device,
                        incarnation=incarnation, keep_last=keep_last,
                        # a restart at another world reshards instead of mis-resuming
                        topology=make_topology(
                            world, global_batch=config.global_batch_size, accum_steps=config.accum_steps,
                            data_seed=config.seed, bits_per_step=step.bits_per_step, rng_seed=config.seed,
                            incarnation=incarnation,
                        ),
                        preemption_guard=guard, **loop_kw,
                    )
                if guard.requested:
                    # the emergency checkpoint is committed: die with the
                    # graceful code (the finally still closes the telemetry)
                    raise SystemExit(PREEMPT_EXIT_CODE)
            else:
                state, logger = train_loop(step, state, batches, config.training_epochs, device, **loop_kw)
        finally:
            telemetry.close()
        extra.update({
            "preset": preset,
            "real_data": is_real,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "num_devices": world,
            "strategy": strategy,
            "compute_dtype": config.compute_dtype,
            "losses": [r.loss for r in logger.records],
            "step_time_s": [r.step_time_s for r in logger.records],
            "device_time_ms": [r.device_time_ms for r in logger.records],
        })
        if strategy == "fsdp":
            audit = collective_audit(step.records)
            extra.update(bits_per_step=recorded_bits(step.records), n_collectives=audit["count"], collectives=audit)
        else:
            extra.update(
                bits_per_step=step.bits_per_step, n_collectives=step.reducer.n_collectives(list(model.parameters()))
            )
        if eval_after and strategy == "fsdp":
            # the reference's :333: the unsharded parameters, the ranks' mean statistics
            tensors = {**step.unshard(state), **step.eval_model_state(state)}
            test_x, test_y, _ = load_cifar10_or_synthetic(data_dir, train=False)
            extra["eval_accuracy"] = evaluate_image_classifier(model, test_x, test_y, tensors=tensors)
        elif eval_after:
            extra["eval_accuracy"] = evaluate_on_test_split(model, group, data_dir)
        return summarize("exact_cifar10", logger, extra)
