"""Shared experiment machinery: the reducers' keyword arguments, batches,
the loss, the epoch/step loop, its checkpointed form
(:func:`resilient_train_loop`) and its degraded-fabric form
(:func:`adaptive_train_loop`), the model-parallel experiments' loop over a
hand-written step (:func:`carry_loop`), evaluation and the run summary."""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..data.cifar10 import load_cifar10_or_synthetic
from ..data.loader import device_prefetch, iterate_batches
from ..observe.events import FailureEvent, TrainHealthEvent
from ..observe.fidelity import FidelityTracker
from ..observe.ledger import audit_recorded_step, count_flops
from ..observe.memory import MemorySampler, tree_bytes
from ..observe.spans import recording, span
from ..parallel.comm import CollectiveRecord, agree, record_collectives, world_size
from ..parallel.localsgd import mean_model_state
from ..parallel.mesh import DistributedConfig, initialize_distributed, shutdown_distributed
from ..parallel.trainer import TrainState, TrainStep
from ..utils.checkpoint import restore_latest, save_checkpoint
from ..utils.losses import cross_entropy_loss
from ..utils.metrics import MetricsLogger
from ..utils.profiling import step_annotation, trace


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


def require_float32(config, experiment: str) -> None:
    """Raise ``NotImplementedError`` for a ``compute_dtype`` other than
    float32 where the JAX package builds its model in fp32 whatever the
    config says (``bandwidth_study``)."""
    if config.compute_dtype != "float32":
        raise NotImplementedError(
            f"{experiment}: compute_dtype={config.compute_dtype!r} is not supported: it builds fp32 models,"
            " as the JAX package's does"
        )


def compute_dtype(config) -> torch.dtype:
    """``config.compute_dtype`` as a torch dtype."""
    return getattr(torch, config.compute_dtype)


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
    when accumulating.

    As in the JAX package, the plain ``(image, label)`` epochs (every CIFAR
    experiment) run through the native loader
    (``native.NativeBatchLoader.maybe_create``: a float32 and an integer
    array, no accumulation): the same batches as :func:`iterate_batches`,
    assembled on a C++ worker thread up to two batches ahead of the loop.
    Other batches keep the numpy path."""
    k = config.accum_steps
    if k < 1:
        raise ValueError(f"accum_steps must be >= 1, got {k}")
    if config.global_batch_size % k != 0:
        raise ValueError(
            f"global_batch_size {config.global_batch_size} is not divisible by accum_steps {k}"
        )

    native_loader = None
    if k == 1:
        from ..native import NativeBatchLoader

        native_loader = NativeBatchLoader.maybe_create(arrays, config.global_batch_size, seed=config.seed)

    def gen(epoch: int):
        it = (
            native_loader.epoch(epoch)
            if native_loader is not None
            else iterate_batches(arrays, config.global_batch_size, seed=config.seed, epoch=epoch)
        )
        try:
            for i, batch in enumerate(it):
                if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                    return
                if k > 1:
                    batch = tuple(a.reshape((k, a.shape[0] // k) + a.shape[1:]) for a in batch)
                yield batch
        finally:
            it.close()  # an epoch left early joins the native loader's thread now

    gen.loader = native_loader  # its last_stats say which path ran
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


class _Probes:
    """The memory and health probes of a training loop, every
    ``health_every`` completed steps (with a ``telemetry``): a
    ``MemoryEvent`` from the card, then the step's health probe
    (``step.health_fn``) on the step's own batch, a ``TrainHealthEvent``
    and a ``FidelityEvent`` a fidelity group. An error in the probe is a
    ``FailureEvent(kind="health_probe_error")``."""

    def __init__(self, telemetry, health_every: int, run_name: str, rank: int, device: torch.device):
        self.telemetry, self.every, self.run_name, self.rank = telemetry, health_every, run_name, rank
        self.on = health_every > 0 and telemetry is not None
        self.memory_sampler = MemorySampler(telemetry, label=run_name, rank=rank, device=device) if self.on else None
        self.fidelity_tracker = None

    def after_step(self, n: int, epoch: int, step, state, batch) -> None:
        """Probe after the ``n``-th completed step, if it is due."""
        if not self.on or n % self.every:
            return
        if self.memory_sampler.enabled:
            with span("memory_probe", step=n):
                self.memory_sampler.sample(n)
        health_fn = getattr(step, "health_fn", None)
        if health_fn is None:
            return
        with span("health_probe", step=n):
            try:
                stats = health_fn(state, batch)
                self.telemetry.emit(
                    TrainHealthEvent(
                        step=n, epoch=epoch, grad_norm=stats["grad_norm"], ef_memory_norm=stats["ef_memory_norm"],
                        powersgd_rel_error=stats["powersgd_rel_error"], loss=stats["loss"], rank=self.rank,
                        label=self.run_name,
                    )
                )
                fid = stats.get("fidelity")
                if fid:
                    if self.fidelity_tracker is None:
                        reducer = getattr(step, "reducer", None)
                        tags = (
                            reducer.fidelity_group_tags(list(state.params.values()))
                            if hasattr(reducer, "fidelity_group_tags") else {}
                        )
                        self.fidelity_tracker = FidelityTracker(tags, rank=self.rank, label=self.run_name)
                    for ev in self.fidelity_tracker.events(n, fid, epoch=epoch):
                        self.telemetry.emit(ev)
            except Exception as e:  # advisory, never fatal
                self.telemetry.emit(
                    FailureEvent(kind="health_probe_error", label=self.run_name, message=f"{type(e).__name__}: {e}")
                )


def buffer_classes(state) -> Dict[str, float]:
    """The bytes of each class of a training state's tensors, for the OOM
    report (``GuardedStep(buffers_fn=...)``): the leaves never change shape,
    so their sizes attribute the live bytes."""
    return {
        "params": float(tree_bytes(getattr(state, "params", None))),
        "momenta": float(tree_bytes(getattr(state, "momenta", None))),
        "ef_memory": float(tree_bytes(getattr(state, "memories", None))),
        "reducer_state": float(tree_bytes(getattr(state, "reducer_state", None))),
        "model_state": float(tree_bytes(getattr(state, "model_state", None))),
    }


def _device_batch(batch, rank: int, world_size: int, accum_steps: int, device: torch.device):
    """This rank's slice of a global batch (:func:`local_shard`), on
    ``device``: a synchronous copy, the loop's path at ``prefetch=0``."""
    batch = local_shard(batch, rank, world_size, accum_steps)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in batch)


def _run_step(call, state, batch, n: int, run_name: str, on_cuda: bool, record: bool, watch=None):
    """Step ``n`` of a training loop, ``call(state, batch)``, inside
    ``watch`` (a ``StepWatchdog``'s context, or None), the profiler range
    ``"{run_name}#{n}"`` and the span ``step``, which holds
    ``step/compute`` (the call, between two CUDA events on the card, under
    ``record_collectives`` and ``observe.ledger.count_flops`` when
    ``record``) and ``step/loss_sync`` (the loss as a host float). Returns
    ``(state, loss, device_ms, records, flops)``: ``device_ms`` None off
    the card, ``records`` and ``flops`` None unless ``record``."""
    recorder = record_collectives() if record else contextlib.nullcontext()
    counter = count_flops() if record else contextlib.nullcontext()
    with watch or contextlib.nullcontext(), step_annotation(run_name, n), span("step", step=n):
        with span("step/compute", step=n), recorder as records, counter as counted:
            if on_cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            state, loss = call(state, batch)
            if on_cuda:
                end.record()
        with span("step/loss_sync", step=n):
            # waits for the step; a chaos step_nan reports a host float
            loss = float(loss)
    flops = counted["flops"] if record else None
    return state, loss, start.elapsed_time(end) if on_cuda else None, records, flops


def _audit_step(step, records, run_name: str, telemetry, device: torch.device, flops: Optional[float] = None) -> None:
    """Reconcile ``step``'s wire ledger against the collectives it issued
    and record the FLOPs its call counted
    (``observe.ledger.audit_recorded_step``). Advisory: an error in it is a
    ``FailureEvent(kind="audit_error")`` and the run goes on."""
    try:
        audit_recorded_step(
            step, records, label=run_name, telemetry=telemetry,
            device_kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu", flops_per_step=flops,
        )
    except Exception as e:  # the audit is advisory, never fatal
        if telemetry is not None:
            telemetry.emit(FailureEvent(kind="audit_error", label=run_name, message=f"{type(e).__name__}: {e}"))


def train_loop(
    step: TrainStep,
    state: TrainState,
    batches_for_epoch: Callable[[int], Iterator[Any]],
    epochs: int,
    device: torch.device,
    rank: int = 0,
    world_size: int = 1,
    log_every: int = 0,
    start_epoch: int = 0,
    skip_steps: int = 0,
    watchdog: Any = None,
    heartbeat: Any = None,
    on_epoch_end: Optional[Callable[[int, TrainState], None]] = None,
    on_step_end: Optional[Callable[[int, int, TrainState], bool]] = None,
    telemetry: Any = None,
    trace_dir: Optional[str] = None,
    audit: bool = False,
    run_name: str = "train",
    health_every: int = 0,
    prefetch: int = 2,
) -> Tuple[TrainState, MetricsLogger]:
    """Run epochs ``start_epoch..epochs-1`` over the global batches, each
    rank stepping on its own slice, the JAX package's loop of the same
    name.

    ``prefetch``: stage that many upcoming batches on the device ahead of
    the step (``data.loader.device_prefetch``: pinned slots, a side
    stream), so that a batch's copy is issued ahead of its step and off
    the step's stream; the rank's slice (:func:`local_shard`) is cut before staging, so only
    this rank's rows are copied. 0 copies each batch synchronously when it
    is fetched. Every step emits a ``StepEvent`` and every epoch an
    ``EpochEvent`` through ``telemetry`` (None: the banner-only default
    registry); the host clock spans the step until its loss is on the
    host, and on CUDA a pair of events around the step gives its device
    time.

    Observability, all off by default:

    - ``telemetry`` is the ambient span recorder for the loop: spans
      ``data_load`` (the fetch of a staged batch; at ``prefetch=0`` the
      fetch and the copy to the device) with ``data_load/assemble`` (the
      numpy gather) and ``data_load/stage`` inside it, one ``LoaderEvent``
      an epoch from the staging, ``step`` with
      ``step/compute`` and ``step/loss_sync`` inside it, ``memory_probe``,
      ``health_probe`` and ``epoch_hook``;
    - ``trace_dir``: a ``torch.profiler`` trace of the loop
      (``utils.profiling.trace``), every step a range ``"{run_name}#{n}"``;
    - ``audit``: the first step runs under ``record_collectives`` and
      ``observe.ledger.count_flops``, and its wire ledger is reconciled
      against what it issued (``observe.ledger.audit_recorded_step``: a
      ``CollectiveEvent`` a ledger line and a ``CompileEvent`` carrying
      the step's FLOPs, before the step's ``StepEvent``). The audit is
      advisory: an error in it is a ``FailureEvent(kind="audit_error")``
      and the run goes on;
    - ``health_every > 0`` (with a ``telemetry``): every N completed steps
      a ``MemoryEvent`` from the card (``observe.memory.MemorySampler``,
      which turns itself off after one empty read on the CPU), then the
      step's health probe (``step.health_fn``) on the step's own batch: a
      ``TrainHealthEvent`` and a ``FidelityEvent`` a fidelity group. An
      error in the probe is a ``FailureEvent(kind="health_probe_error")``.

    The hooks, also off by default (:func:`resilient_train_loop` sets
    them): ``skip_steps`` leaves out the first steps of ``start_epoch``
    (already in a restored state); a ``utils.failure.StepWatchdog``
    watches every step; a ``utils.failure.HeartbeatMonitor`` beats after
    each; ``on_step_end(epoch, steps_done, state) -> stop?`` runs after
    each (``steps_done`` counts this call's steps of the epoch), and True
    ends the loop there; ``on_epoch_end(epoch, state)`` runs after each
    epoch."""
    logger = MetricsLogger(bits_per_step=step.bits_per_step, log_every=log_every, telemetry=telemetry)
    on_cuda = device.type == "cuda"
    probes = _Probes(telemetry, health_every, run_name, rank, device)
    audit_pending = audit
    trace_ctx = trace(trace_dir) if trace_dir else contextlib.nullcontext()
    with trace_ctx, recording(telemetry):
        for epoch in range(start_epoch, epochs):
            batches = iter(batches_for_epoch(epoch))
            if skip_steps and epoch == start_epoch:
                # ahead of the staging: skipped batches are never copied
                batches = itertools.islice(batches, skip_steps, None)
            if prefetch:
                batches = device_prefetch(
                    (local_shard(b, rank, world_size, step.accum_steps) for b in batches), device, depth=prefetch
                )
            steps_done = 0
            while True:
                with span("data_load", step=logger._step):
                    batch = next(batches, None)
                    if batch is not None and not prefetch:
                        batch = _device_batch(batch, rank, world_size, step.accum_steps, device)
                if batch is None:
                    break
                logger.start_step()
                watch = watchdog.watch(f"epoch {epoch}") if watchdog is not None else None
                state, loss, device_ms, records, flops = _run_step(
                    step, state, batch, logger._step, run_name, on_cuda, audit_pending, watch
                )
                if audit_pending:
                    audit_pending = False
                    _audit_step(step, records, run_name, telemetry, device, flops)
                logger.end_step(epoch, loss, device_ms)
                steps_done += 1
                probes.after_step(logger._step, epoch, step, state, batch)
                if heartbeat is not None:
                    heartbeat.beat(epoch=epoch)
                if on_step_end is not None and on_step_end(epoch, steps_done, state):
                    if prefetch:  # an epoch left mid-way: no copy in flight, the loader's thread joined
                        batches.close()
                    return state, logger
            logger.end_epoch(epoch, rank=rank)
            if on_epoch_end is not None:
                with span("epoch_hook", step=epoch):
                    on_epoch_end(epoch, state)
    return state, logger


@dataclasses.dataclass
class Carry:
    """The state a model-parallel experiment's step threads from step to
    step. Every field is this rank's own (a stage, a shard, local experts,
    this data worker's error memories), so each rank checkpoints all of it
    in its own file."""

    PER_RANK_FIELDS = ("params", "momenta", "memories", "reducer_state")
    params: Dict[str, torch.Tensor]
    momenta: Dict[str, torch.Tensor]
    memories: Dict[str, torch.Tensor]
    reducer_state: Any


class RecordedStep:
    """A training step whose first call runs under
    :func:`..parallel.comm.record_collectives`: ``records`` holds what that
    step issued (None before it), so a run can report the bits it put on
    the wire. Every other attribute is the step's."""

    def __init__(self, step):
        self.step = step
        self.records: Optional[List[CollectiveRecord]] = None

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, state, batch):
        if self.records is not None:
            return self.step(state, batch)
        with record_collectives() as records:
            out = self.step(state, batch)
        self.records = records
        return out


def collective_audit(records: Sequence[CollectiveRecord]) -> Dict[str, Any]:
    """The JAX package's ``collective_summary`` of one step, from what
    :func:`..parallel.comm.record_collectives` saw: the count and payload
    bytes of each kind, and their total."""
    kinds = sorted({r.kind for r in records})
    return {
        "count": len(records),
        "by_kind": {k: sum(1 for r in records if r.kind == k) for k in kinds},
        "bytes_by_kind": {k: sum(r.payload_bytes for r in records if r.kind == k) for k in kinds},
        "total_payload_bytes": sum(r.payload_bytes for r in records),
    }


def carry_loop(
    step_fn: Callable[[Any, torch.Tensor, torch.Tensor], Tuple[Any, torch.Tensor]],
    carry: Any,
    batches_for_epoch: Callable[[int], Iterator[Tuple[np.ndarray, np.ndarray]]],
    epochs: int,
    local_batch: Callable[[Tuple[np.ndarray, np.ndarray]], Tuple[np.ndarray, np.ndarray]],
    device: torch.device,
    rank: int = 0,
    log_every: int = 0,
    checkpoint_dir: Optional[str] = None,
    group=None,
) -> Tuple[Any, MetricsLogger, Optional[Dict[str, Any]]]:
    """The loop of a hand-written ``step_fn(carry, x, y) -> (carry, loss)``
    (the model-parallel experiments), the JAX package's
    ``audited_carry_loop``. ``local_batch`` cuts this rank's part out of a
    global batch. The first step runs under
    :func:`..parallel.comm.record_collectives`, and its records are the
    audit (:func:`collective_audit`) and the bits a step, in place of the
    compiled step's HLO. The loss reaches the host once a step; on CUDA a
    pair of events around the step gives its device time.

    With ``checkpoint_dir`` the carry (a :class:`Carry`) is saved at every
    epoch boundary through ``utils.checkpoint.save_checkpoint`` by every
    rank of ``group``, and the newest committed checkpoint is restored on
    entry (``restore_latest``), so a run that stops between epochs resumes
    where it stopped. Returns ``(carry, logger, audit)``; the audit is None
    when no step ran."""
    start_epoch = 0
    if checkpoint_dir is not None:
        resumed = restore_latest(checkpoint_dir, carry, group=group)
        if resumed is not None:
            carry, done = resumed
            start_epoch = done + 1
    logger = MetricsLogger(log_every=log_every)
    audit = None
    on_cuda = device.type == "cuda"
    for epoch in range(start_epoch, epochs):
        for batch in batches_for_epoch(epoch):
            x, y = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in local_batch(batch))
            logger.start_step()
            if on_cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            with record_collectives() if audit is None else contextlib.nullcontext() as records:
                carry, loss = step_fn(carry, x, y)
            if on_cuda:
                end.record()
            loss = loss.item()  # waits for the step
            if audit is None:
                audit = collective_audit(records)
                logger.bits_per_step = 8 * audit["total_payload_bytes"]
            logger.end_step(epoch, loss, start.elapsed_time(end) if on_cuda else None)
        logger.end_epoch(epoch, rank=rank)
        if checkpoint_dir is not None:
            save_checkpoint(checkpoint_dir, carry, step=epoch, group=group)
    return carry, logger, audit


def resilient_train_loop(
    step: TrainStep,
    init_state: TrainState,
    batches_for_epoch: Callable[[int], Iterator[Any]],
    epochs: int,
    checkpoint_dir: str,
    device: torch.device,
    rank: int = 0,
    world_size: int = 1,
    log_every: int = 0,
    watchdog_timeout_s: Optional[float] = None,
    heartbeat: Any = None,
    telemetry: Any = None,
    trace_dir: Optional[str] = None,
    audit: bool = False,
    run_name: str = "train",
    health_every: int = 0,
    chaos_plan: Any = None,
    incarnation: int = 0,
    step_retries: int = 0,
    guard_batches: bool = False,
    expected_batch: Optional[int] = None,
    keep_last: Optional[int] = None,
    topology: Optional[Dict] = None,
    preemption_guard: Any = None,
    loader_state_fn: Optional[Callable[[int, int], Optional[Dict]]] = None,
) -> Tuple[TrainState, MetricsLogger, int]:
    """:func:`train_loop` with checkpoints, the JAX package's loop of the
    same name (its ``common.py:872``). Every rank of ``step.group`` calls
    it:

    - on entry, resume from the newest committed checkpoint under
      ``checkpoint_dir`` that passes verification (a torn or bit-flipped
      directory is skipped with a ``checkpoint_fallback`` event), into
      ``init_state``'s own tensors: the whole state, so the EF chain
      continues exactly;
    - after every epoch, save through the atomic commit protocol
      (``keep_last`` keeps the newest K);
    - a ``utils.failure.StepWatchdog`` (``watchdog_timeout_s``, the first
      step spared) and a ``heartbeat`` beat per step;
    - ``topology`` (``resilience.reshard.make_topology`` of THIS run's
      world) tags every checkpoint; on resume a checkpoint of another world
      goes through the resharder (memories fold by summation, BN statistics
      merge), with ``resumed``, ``resharded`` and a ``note`` of the
      accounting in ``telemetry``;
    - ``preemption_guard`` (``resilience.guards.PreemptionGuard``): after
      each step the ranks agree on its flag (one int32 max, recorded as
      ``"preempt-flag"``, outside the step's bits), so a SIGTERM that
      reached one rank stops all of them at the same step, with an
      emergency committed checkpoint whose topology carries
      ``epoch_cursor``; the next resume re-enters that epoch past the
      steps done;
    - ``loader_state_fn(epoch, batches_done)`` gives the loader-state
      record committed with each checkpoint (``(epoch + 1, 0)`` at an
      epoch's end, the cursor on a preemption save);
    - ``step_retries > 0`` wraps the step in
      :class:`resilience.guards.GuardedStep` (transient-error retry and
      non-finite-loss rejection, each attempt from a snapshot of the state,
      and the OOM forensics report, ``buffers_fn`` sizing the state's
      classes); ``guard_batches`` drops malformed batches
      (:func:`resilience.guards.guarded_batches`: a leading dim other than
      ``expected_batch``, non-finite values), the ranks agreeing on each
      verdict;
    - ``chaos_plan`` (a :class:`resilience.chaos.ChaosPlan`) threads its
      faults into all of the above: the step's and the process's
      (``ChaosStep``, every rank raising the twin of a peer's step fault),
      the loader's (``chaos_batches``, on the host batch before it is cut
      and copied) and the checkpoint's (``apply_checkpoint_fault`` after
      each epoch's save), in this run's ``incarnation``.

    A save that the directory keeps refusing emits
    ``checkpoint_unwritable`` and exits with ``CKPT_UNWRITABLE_EXIT_CODE``.
    ``telemetry``, ``trace_dir``, ``audit``, ``run_name`` and
    ``health_every`` reach :func:`train_loop`. Returns ``(state, logger,
    start_epoch)``."""
    from ..observe import NoteEvent
    from ..resilience.guards import CKPT_UNWRITABLE_EXIT_CODE, CheckpointUnwritableError
    from ..utils.checkpoint import read_topology
    from ..utils.failure import StepWatchdog

    group = step.group
    state = init_state
    start_epoch = 0
    resume_skip = 0  # steps of start_epoch already in the restored state
    reshard_note: Dict[str, Any] = {}

    def _resharder(path, saved_topo):
        from ..resilience.reshard import reshard_from_checkpoint

        reshard_note["old"] = saved_topo or {}
        return reshard_from_checkpoint(
            path, init_state, saved_topology=saved_topo, mesh_axes=(topology or {}).get("mesh_axes"), group=group
        )

    resumed = restore_latest(
        checkpoint_dir, init_state, telemetry=telemetry, label=run_name,
        resharder=_resharder if topology is not None else None, group=group,
    )
    if resumed is not None:
        state, resumed_epoch = resumed
        restored_topo = read_topology(os.path.join(os.path.abspath(checkpoint_dir), f"step_{resumed_epoch}"))
        cursor = (restored_topo or {}).get("epoch_cursor")
        if cursor and cursor.get("batches_done"):
            # a mid-epoch preemption save: re-enter that epoch past the steps
            # already in the state (the epoch's batches are deterministic)
            start_epoch = int(cursor["epoch"])
            resume_skip = int(cursor["batches_done"])
        else:
            start_epoch = resumed_epoch + 1
        if telemetry is not None:
            mid = f" (+{resume_skip} steps)" if resume_skip else ""
            telemetry.emit(
                FailureEvent(
                    kind="resumed", label=run_name, rank=rank, step=resumed_epoch, incarnation=incarnation,
                    message=f"resumed from step_{resumed_epoch}, starting epoch {start_epoch}{mid}",
                )
            )
        if reshard_note and telemetry is not None:
            old, new = reshard_note["old"], topology or {}
            new_bits = new.get("bits_per_step")
            if new_bits is None:
                new_bits = step.bits_per_step
            mesh = f" (mesh {old.get('mesh_axes')} -> {new.get('mesh_axes')})" if old.get("mesh_axes") or new.get("mesh_axes") else ""
            telemetry.emit(
                FailureEvent(
                    kind="resharded", label=run_name, rank=rank, step=resumed_epoch, incarnation=incarnation,
                    message=f"world {old.get('world_size')} -> {new.get('world_size')}{mesh}: EF memories folded"
                            f" by summation, per-worker stats merged, partitions re-split from the fixed"
                            f" permutation",
                )
            )
            telemetry.emit(
                NoteEvent(
                    message=f"reshard accounting: global_batch {old.get('global_batch')} ->"
                            f" {new.get('global_batch')} (preserved), accum_steps {old.get('accum_steps')} ->"
                            f" {new.get('accum_steps')}, bits_per_step {old.get('bits_per_step')} -> {new_bits}",
                )
            )

    if chaos_plan is not None:
        from ..resilience.chaos import ChaosStep, chaos_batches

        step = ChaosStep(
            step, chaos_plan, rank=rank, incarnation=incarnation, telemetry=telemetry, world_size=world_size
        )
        batches_for_epoch = chaos_batches(
            batches_for_epoch, chaos_plan, rank=rank, incarnation=incarnation, telemetry=telemetry
        )
    if step_retries > 0:
        from ..resilience.guards import GuardedStep

        step = GuardedStep(
            step, retries=step_retries, telemetry=telemetry, label=run_name, rank=rank,
            buffers_fn=lambda: buffer_classes(state),
        )
    if guard_batches:
        from ..resilience.guards import guarded_batches

        batches_for_epoch = guarded_batches(
            batches_for_epoch, expected_batch=expected_batch, telemetry=telemetry, label=run_name, group=group
        )

    def _topo(cursor: Optional[Dict] = None) -> Optional[Dict]:
        if topology is None:
            return {"epoch_cursor": cursor} if cursor else None
        return {**topology, "epoch_cursor": cursor}

    def _loader_state(epoch: int, cursor: Optional[Dict]) -> Optional[Dict]:
        if loader_state_fn is None:
            return None
        if cursor is None:  # an epoch-end save: the next epoch starts clean
            return loader_state_fn(epoch + 1, 0)
        return loader_state_fn(int(cursor["epoch"]), int(cursor["batches_done"]))

    def _commit_save(st, epoch: int, cursor: Optional[Dict] = None) -> None:
        # a small retry budget for a transient refusal, then the typed fail-fast
        # exit: restarting into a read-only root is a restart storm
        last = None
        for attempt in range(2):
            try:
                save_checkpoint(
                    checkpoint_dir, st, step=epoch, keep_last=keep_last, topology=_topo(cursor),
                    loader_state=_loader_state(epoch, cursor), group=group,
                )
                return
            except CheckpointUnwritableError as e:
                last = e
                time.sleep(0.05 * (attempt + 1))
        if telemetry is not None:
            telemetry.emit(
                FailureEvent(
                    kind="checkpoint_unwritable", label=run_name, rank=rank, step=epoch, incarnation=incarnation,
                    message=f"save retry budget exhausted: {last}",
                )
            )
        raise SystemExit(CKPT_UNWRITABLE_EXIT_CODE) from last

    def _save(epoch: int, st) -> None:
        _commit_save(st, epoch)
        if chaos_plan is not None:
            from ..resilience.chaos import apply_checkpoint_fault

            apply_checkpoint_fault(
                chaos_plan, checkpoint_dir, epoch, rank=rank, incarnation=incarnation, telemetry=telemetry,
                world_size=world_size,
            )

    def _on_step_end(epoch: int, steps_done: int, st) -> bool:
        # the ranks agree on the flag: a SIGTERM may have reached one of them
        if not agree(int(preemption_guard.requested), group, "max", kind="preempt-flag"):
            return False
        if not preemption_guard.requested:
            preemption_guard.peer_request()
        done = steps_done + (resume_skip if epoch == start_epoch else 0)
        _commit_save(st, epoch, cursor={"epoch": epoch, "batches_done": done})
        preemption_guard.checkpoint_saved = True
        if telemetry is not None:
            telemetry.emit(
                FailureEvent(
                    kind="preempt_checkpoint", label=run_name, rank=rank, step=epoch, incarnation=incarnation,
                    message=f"emergency checkpoint committed at epoch {epoch} after {done} steps; stopping for"
                            f" preemption",
                )
            )
        return True

    # the first step is spared: it builds the kernels and warms the allocator
    wd = StepWatchdog(watchdog_timeout_s, compile_grace=1) if watchdog_timeout_s is not None else None
    state, logger = train_loop(
        step, state, batches_for_epoch, epochs, device, rank=rank, world_size=world_size, log_every=log_every,
        start_epoch=start_epoch, skip_steps=resume_skip, watchdog=wd, heartbeat=heartbeat,
        on_epoch_end=_save,
        on_step_end=_on_step_end if preemption_guard is not None else None,
        telemetry=telemetry, trace_dir=trace_dir, audit=audit, run_name=run_name, health_every=health_every,
    )
    return state, logger, start_epoch


def adaptive_train_loop(
    step_factory: Callable[[Dict[str, Any]], TrainStep],
    batches_for_epoch: Callable[[int], Iterator[Any]],
    epochs: int,
    controller: Any,
    device: torch.device,
    injector: Any = None,
    telemetry: Any = None,
    rank: int = 0,
    world_size: int = 1,
    log_every: int = 0,
    run_name: str = "train",
    fabric: str = "NVLink4(H100)",
    deadline_slack: float = 4.0,
    deadline_floor_s: float = 0.05,
    escalate_after: int = 3,
    step_retries: int = 2,
    stragglers_for_epoch: Optional[Callable[[int], int]] = None,
    health_every: int = 0,
    alert_feed: Any = None,
    trace_dir: Optional[str] = None,
    audit: bool = False,
) -> Tuple[TrainState, MetricsLogger, Any]:
    """The degraded-fabric loop, the JAX package's function of the same
    name (its ``common.py:569``): :func:`train_loop`'s epochs and steps
    over a step that is rebuilt at each move of the
    :class:`resilience.controller.FallbackController`.

    ``step_factory(overrides)`` builds the training step of one ladder rung
    (``reducer``, ``reducer_rank``, ``comm_chunks``, ``comm_strategy``,
    ``sync_every``) over the same model, whose parameters are the state.
    Around every step: a :class:`resilience.guards.CollectiveWatchdog`
    fence hook arms a deadline at each chunk (registered FIRST, so that it
    is armed when an injected stall sleeps), the optional
    :class:`resilience.chaos.CommFaultInjector` is advanced on the host and
    registered second, and the step runs as
    ``CommDeadlineGuard(GuardedStep(step))``: a transient error retries
    inside, an expired deadline retries once from the state the step began
    with, then marks the step degraded, and ``escalate_after`` degraded
    steps in a row raise :class:`resilience.guards.CommEscalationError`.

    At each epoch's end the loop builds an ``EpochHealth`` (the host p50 of
    the step times, the first two steps after each build left out; the
    bytes a step over that p50; the watchdog's expiries and degraded
    steps; ``stragglers_for_epoch(epoch)``) and hands it to
    ``controller.observe``. Over more than one rank each number is first
    agreed (the max; the p50 in microseconds), so every rank makes the
    same decision and the next collectives match. A decision rebuilds the
    step once: the parameters and momenta carry over exactly (the same
    tensors), the BatchNorm buffers are averaged over the ranks
    (:func:`average_model_state`), the EF memories restart at 0, and
    ``controller.record`` gets the new rung's bytes a step (predicted) and
    the old one's (realised).

    ``health_every`` runs the memory and health probes and ``trace_dir``
    the ``torch.profiler`` trace as :func:`train_loop` does; ``audit``
    audits the first step of each rung that ran once (its collectives
    against its ledger, the deadline guard's agreements left out). No
    deadline watches an audited step (``CollectiveWatchdog.unwatched``):
    its FLOPs count (``observe.ledger.count_flops``) runs every op through
    Python dispatch, inside the chunks' windows, a host cost the JAX
    package's compile-time count does not pay.

    ``alert_feed`` (an ``observe.live.AlertFeed`` on the run's
    ``alerts.jsonl``) is read after every step, and each new alert record
    goes to ``controller.nudge``: a critical or comm-shaped alert descends
    one rung at once (a rebuild as at an epoch's end), a fidelity-shaped
    one ascends, another warn pre-charges the epoch's verdict; the nudged
    epoch's verdict is then spent. Each rank reads the file at its own
    moment, so over more than one rank the ranks first agree (one int32
    max a step, kind ``"alert-nudge"``, outside the step and its audit) on
    how many records to take, and each takes the same records at the same
    step: every rank rebuilds at the same step.

    Returns ``(state, logger, controller)``."""
    import statistics

    from ..resilience.controller import EpochHealth
    from ..resilience.guards import CollectiveWatchdog, CommDeadlineGuard, GuardedStep
    from ..parallel import comm

    base = step_factory(controller.overrides)
    state = base.init_state()
    group = base.group
    watchdog = CollectiveWatchdog(
        n_workers=comm.world_size(group), fabric=fabric, slack=deadline_slack, floor_s=deadline_floor_s,
        escalate_after=escalate_after, telemetry=telemetry, rank=rank, label=run_name,
    )
    on_cuda = device.type == "cuda"
    probes = _Probes(telemetry, health_every, run_name, rank, device)

    def _guard(inner: TrainStep):
        return CommDeadlineGuard(
            GuardedStep(
                inner, retries=step_retries, telemetry=telemetry, label=run_name, rank=rank,
                memory_sampler=probes.memory_sampler, buffers_fn=lambda: buffer_classes(state),
            ),
            watchdog, telemetry=telemetry, label=run_name, rank=rank, group=group,
        )

    def _agreed(value: int) -> int:
        if comm.world_size(group) == 1:
            return int(value)
        return agree(int(value), group, "max", kind="epoch-health")

    guard = _guard(base)
    alerts = _AgreedAlerts(alert_feed, group) if alert_feed is not None else None
    logger = MetricsLogger(bits_per_step=base.bits_per_step, log_every=log_every, telemetry=telemetry)
    # the first steps after every build pay the kernels' builds and the
    # allocator's warm-up, which would poison the p50 the controller
    # compares against: left out of the step times (still logged)
    compile_grace = 2
    audit_pending = audit

    def _rebuild(decision) -> None:
        # ONE rebuild a decision, the state carried across the switch
        nonlocal base, state, guard, compile_grace, audit_pending
        probes.fidelity_tracker = None  # new reducer, new fidelity groups
        realized = base.bits_per_step / 8
        average_model_state(base.model, group)
        new_base = step_factory(controller.overrides)
        new_state = new_base.init_state()
        new_state.momenta = state.momenta
        base, state = new_base, new_state
        guard = _guard(base)
        logger.bits_per_step = base.bits_per_step
        compile_grace = 2
        audit_pending = audit
        controller.record(decision, predicted_bytes_per_step=base.bits_per_step / 8, realized_bytes_per_step=realized)

    # a NCCL group sets its communicator up at its first collective: done
    # here, or the first step's deadline window would hold it
    if group is not None:
        agree(0, group, "max", kind="warm-up")
    # the watchdog BEFORE the injector: arm the deadline, then let the fault sleep
    comm.add_fence_hook(watchdog)
    if injector is not None:
        comm.add_fence_hook(injector)
    gstep = 0
    try:
        with trace(trace_dir) if trace_dir else contextlib.nullcontext(), recording(telemetry):
            for epoch in range(epochs):
                step_times: List[float] = []
                for batch in batches_for_epoch(epoch):
                    with span("data_load", step=gstep):
                        batch = _device_batch(batch, rank, world_size, base.accum_steps, device)
                    if injector is not None:
                        injector.advance(gstep)
                    logger.start_step()
                    t0 = time.monotonic()
                    # no deadline watches the audited step (its FLOPs count)
                    with watchdog.unwatched() if audit_pending else contextlib.nullcontext():
                        state, loss, device_ms, records, flops = _run_step(
                            guard, state, batch, gstep, run_name, on_cuda, audit_pending
                        )
                    if compile_grace > 0:
                        compile_grace -= 1
                    else:
                        step_times.append(time.monotonic() - t0)
                    # a retried step issued its collectives twice: the audit
                    # waits for a step of one attempt
                    if audit_pending and guard.last_attempts == 1:
                        audit_pending = False
                        issued = [r for r in records if r.kind not in ("comm-deadline-flag", "alert-nudge")]
                        _audit_step(base, issued, run_name, telemetry, device, flops)
                    logger.end_step(epoch, loss, device_ms)
                    gstep += 1
                    probes.after_step(gstep, epoch, base, state, batch)
                    if alerts is not None:
                        for rec in alerts.take():
                            decision = controller.nudge(
                                rec.get("alert", ""), epoch, severity=rec.get("severity", "warn")
                            )
                            if decision is not None:
                                _rebuild(decision)
                logger.end_epoch(epoch, rank=rank)
                if not step_times:
                    continue
                # the ranks agree on every number of the verdict (the max), or
                # two of them could pick different rungs
                p50 = statistics.median(step_times)
                if comm.world_size(group) > 1:
                    p50 = _agreed(round(p50 * 1e6)) / 1e6
                counters = watchdog.take_epoch()
                bytes_per_step = base.bits_per_step / 8
                health = EpochHealth(
                    epoch=epoch,
                    step_p50_s=p50,
                    achieved_bytes_per_s=bytes_per_step / p50 if p50 > 0 else 0.0,
                    deadline_expiries=_agreed(counters["deadline_expiries"]),
                    degraded_steps=_agreed(counters["degraded_steps"]),
                    stragglers=_agreed(stragglers_for_epoch(epoch) if stragglers_for_epoch is not None else 0),
                )
                decision = controller.observe(health)
                if decision is not None:
                    _rebuild(decision)
    finally:
        if injector is not None:
            comm.remove_fence_hook(injector)
        comm.remove_fence_hook(watchdog)
        watchdog.stop()
    return state, logger, controller


class _AgreedAlerts:
    """The alert feed as every rank takes it: the records read so far, in
    the file's order; :meth:`take` returns the ones no earlier call
    returned, up to the count the ranks agree on (the max of what each has
    read: the file is append-only, so a rank that has read fewer reads on
    until it has them all)."""

    # how long a rank reads on for the records a peer has read: the file
    # is local and append-only, so this only bounds a broken feed
    TIMEOUT_S = 60.0

    def __init__(self, feed, group):
        self.feed, self.group = feed, group
        self.read: List[Dict] = []
        self.taken = 0

    def take(self) -> List[Dict]:
        self.read += self.feed.poll()
        n = len(self.read)
        if world_size(self.group) > 1:
            n = agree(n, self.group, "max", kind="alert-nudge")
            deadline = time.monotonic() + self.TIMEOUT_S
            while len(self.read) < n:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"alert feed: {len(self.read)} records read, a peer read {n}")
                time.sleep(0.005)
                self.read += self.feed.poll()
        out = self.read[self.taken:n]
        self.taken = n
        return out


@torch.no_grad()
def average_model_state(model: nn.Module, group) -> None:
    """All-reduce-mean the model's floating-point buffers (BatchNorm running
    statistics) in place, before an evaluation: each rank kept the
    statistics of its own batches, and the reference evaluates their mean
    (``eval_model_state(reduce="mean")``). ``num_batches_tracked`` stays
    as it is. Nothing changes on one rank."""
    if world_size(group) == 1:
        return
    buffers = dict(model.named_buffers())
    for name, mean in mean_model_state(buffers, group).items():
        if mean is not buffers[name]:
            buffers[name].copy_(mean)


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


def evaluate_image_classifier(
    model: nn.Module, images, labels, batch_size: int = 256, tensors: Optional[Dict[str, torch.Tensor]] = None
) -> float:
    """Top-1 accuracy of an NHWC image classifier on every example, in eval
    mode (BatchNorm from its running statistics); the reference's
    ``common.py:491-520``. ``tensors`` (parameters and buffers by name)
    stand in for the model's own, as FSDP's unsharded parameters do."""
    predict = model if tensors is None else (lambda x: torch.func.functional_call(model, tensors, (x,)))
    return _accuracy(model, [images, labels], batch_size, predict)


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


def summarize(
    name: str, logger: MetricsLogger, extra: Optional[Dict] = None, perplexity: bool = False
) -> Dict:
    """The run summary. ``perplexity=True`` (the LM experiments) adds
    ``final_perplexity = exp(min(final_loss, 30))``, None where no step was
    recorded."""
    out = {"experiment": name, **logger.summary()}
    if perplexity:
        final = out.get("final_loss")
        out["final_perplexity"] = math.exp(min(final, 30.0)) if final is not None else None
    if extra:
        out.update(extra)
    return out
