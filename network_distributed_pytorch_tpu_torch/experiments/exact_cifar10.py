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
an exit with ``PREEMPT_EXIT_CODE`` (75). ``config.chaos_plan`` (a
``resilience.chaos.ChaosPlan`` JSON file, which needs ``checkpoint_dir``)
injects its faults into that loop, with two step retries and the batch
guard on, as in the JAX package; ``heartbeat_dir`` beats a heartbeat after
every step for a supervisor's hang detection.

``strategy="fsdp"`` runs the same workload with parameters, gradients and
momenta sharded over the ranks (ZeRO-3, :mod:`..parallel.fsdp`): the same
exact data-parallel SGD, each rank's model and optimizer memory about
``1 / world`` of DDP's.

``config.adaptive_comm`` trains through :func:`.common.adaptive_train_loop`
instead: a deadline watchdog around every chunk collective and the
``FallbackController`` walking the reducer fallback ladder at epoch
boundaries (``config.plan_path`` reorders the ladder for
``config.comm_fabric``; ``config.chaos_plan`` then drives the comm faults
in process, with no checkpoint directory).

Every path emits through the registry of ``telemetry_from_config``
(``event_log``), with ``trace_dir``, ``audit_wire`` and ``health_every``
as :func:`.common.train_loop` takes them (the FSDP step has no health
probe, as the JAX package's has none).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..data.cifar10 import load_cifar10_or_synthetic
from ..models.resnet import resnet18, resnet50
from ..observe.telemetry import audit_from_config, telemetry_from_config
from ..parallel.comm import recorded_bits
from ..parallel.fsdp import make_fsdp_train_step
from ..parallel.mesh import resolve_device
from ..parallel.reducers import ExactReducer, PowerSGDReducer
from ..parallel.trainer import make_train_step
from ..utils.config import ExperimentConfig
from .common import (
    RecordedStep,
    accumulated_batches,
    adaptive_train_loop,
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


def adaptive_step_factory(config: ExperimentConfig, model, group):
    """``build(overrides)``: the training step of one fallback-ladder rung
    over ``model`` (the JAX package's ``_build_step``): PowerSGD for
    ``reducer == "powersgd"`` and the exact reducer otherwise (the
    hierarchical rungs included, whose ``sync_every`` this synchronous
    entry ignores, as the JAX package's does), always under
    ``ef_momentum``, so that the momenta carry over a switch of reducer."""

    def build(overrides: Dict) -> object:
        comm = {
            "comm_chunks": overrides.get("comm_chunks", config.comm_chunks),
            "comm_strategy": overrides.get("comm_strategy", config.comm_strategy),
        }
        if overrides.get("reducer") == "powersgd":
            reducer = PowerSGDReducer(
                random_seed=config.seed, compression_rank=overrides.get("reducer_rank", config.reducer_rank),
                reuse_query=config.reuse_query, compress_impl=config.compress_impl,
                orthogonalize_impl=config.orthogonalize_impl, **comm,
            )
        else:
            reducer = ExactReducer(bucket_bytes=overrides.get("bucket_bytes", config.bucket_bytes), **comm)
        return make_train_step(
            image_classifier_loss(), reducer, model, learning_rate=config.learning_rate, momentum=config.momentum,
            algorithm="ef_momentum", group=group, accum_steps=config.accum_steps,
            max_grad_norm=config.max_grad_norm,
        )

    return build


def adaptive_controller(config: ExperimentConfig, telemetry=None, rank: int = 0):
    """The ``FallbackController`` of an adaptive run: the default ladder,
    or with ``config.plan_path`` the plan's ranking for
    ``config.comm_fabric`` first (``ladder_from_plan``; a plan that cannot
    be read leaves the default ladder)."""
    import json

    from ..resilience import FallbackController, ladder_from_plan

    ladder = None
    if config.plan_path:
        try:
            with open(config.plan_path, "r", encoding="utf-8") as fh:
                plan_doc = json.load(fh)
        except (OSError, ValueError):
            plan_doc = None
        if plan_doc is not None:
            ladder = ladder_from_plan(plan_doc, config.comm_fabric)
    return FallbackController(ladder=ladder, telemetry=telemetry, rank=rank)


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
    heartbeat_dir: Optional[str] = None,
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
    step and exits with ``SystemExit(PREEMPT_EXIT_CODE)``.
    ``config.chaos_plan`` adds the plan's faults to that loop
    (``step_retries=2``, ``guard_batches`` against the global batch's
    leading dimension).

    ``config.adaptive_comm`` trains through the adaptive loop
    (:func:`adaptive_step_factory`, :func:`adaptive_controller`), and the
    summary adds ``final_rung`` and ``policy_decisions``; under a
    supervised run dir (``observe.runlog.ENV_RUN_DIR`` set) the loop reads
    the run's alert feed. The reference's
    refusals, before any rendezvous: ``adaptive_comm`` with
    ``checkpoint_dir`` or under ``"fsdp"``, and ``chaos_plan`` with neither
    ``checkpoint_dir`` nor ``adaptive_comm``."""
    config = config or default_config()
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {strategy!r}")
    adaptive = bool(config.adaptive_comm)
    if adaptive and checkpoint_dir is not None:
        raise ValueError(
            "adaptive_comm rebuilds the step per fallback-ladder rung; the checkpointed resilient loop carries one"
            " fixed step — pick one (checkpoint_dir or adaptive_comm)"
        )
    if config.chaos_plan and not (checkpoint_dir is not None or adaptive):
        raise ValueError("config.chaos_plan requires checkpoint_dir or adaptive_comm")
    if strategy == "fsdp":
        check_fsdp(config, checkpoint_dir)
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
                from ..resilience import (
                    PREEMPT_EXIT_CODE,
                    ChaosPlan,
                    PreemptionGuard,
                    incarnation_from_env,
                    make_topology,
                )
                from ..utils.failure import HeartbeatMonitor

                plan = ChaosPlan.load(config.chaos_plan) if config.chaos_plan else None
                incarnation = incarnation_from_env()
                heartbeat = (
                    HeartbeatMonitor(heartbeat_dir, rank, world, incarnation=incarnation)
                    if heartbeat_dir is not None else None
                )
                with PreemptionGuard(
                    telemetry=telemetry, rank=rank, incarnation=incarnation, label="exact_cifar10"
                ) as guard:
                    state, logger, extra["start_epoch"] = resilient_train_loop(
                        step, state, batches, config.training_epochs, checkpoint_dir, device,
                        incarnation=incarnation, keep_last=keep_last, heartbeat=heartbeat,
                        chaos_plan=plan, step_retries=2 if plan is not None else 0,
                        guard_batches=plan is not None,
                        # a short batch would skew the accounting (or not split over the ranks)
                        expected_batch=config.global_batch_size if config.accum_steps == 1 else config.accum_steps,
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
            elif adaptive:
                from ..resilience import ChaosPlan, CommFaultInjector

                del state  # each rung builds its own state over the model
                plan = ChaosPlan.load(config.chaos_plan) if config.chaos_plan else None
                injector = CommFaultInjector(plan, rank=rank, telemetry=telemetry) if plan is not None else None
                controller = adaptive_controller(config, telemetry, rank)
                # under a supervised run dir, the live plane's alerts.jsonl
                # nudges the controller between epochs' verdicts
                from ..observe import live, runlog

                run_dir = os.environ.get(runlog.ENV_RUN_DIR)
                state, logger, controller = adaptive_train_loop(
                    adaptive_step_factory(config, model, group), batches, config.training_epochs, controller, device,
                    injector=injector, fabric=config.comm_fabric,
                    alert_feed=live.AlertFeed(run_dir) if run_dir else None, **loop_kw,
                )
                extra.update(final_rung=controller.rung.name, policy_decisions=len(controller.decisions))
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
        elif adaptive:
            extra["bits_per_step"] = logger.bits_per_step  # the final rung's
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
