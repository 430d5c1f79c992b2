"""The recovery guards of the checkpointed training loop, the step's part
of the JAX package's ``resilience/guards.py``:

- :class:`GuardedStep` retries a step that raised a transient
  ``RuntimeError`` (a blip, an injected ``ChaosTransientError``) and
  rejects a step whose loss came back non-finite, re-running it. The
  port's step writes the state IN PLACE (parameters, momenta, BatchNorm
  statistics), so with ``retries > 0`` the guard copies what a step writes
  before each attempt (:class:`StateSnapshot`, one ``_foreach_copy_``) and
  puts it back when the attempt fails: a replay starts from the state the
  failed attempt started from, as the JAX package's replays from inputs it
  never donated. A device out-of-memory is never retried: the guard
  writes the post-mortem (``observe.memory.build_oom_report``) and raises
  :class:`OutOfMemoryError`, which no transient-retry wrapper catches;
- :func:`guarded_batches` drops a batch with non-finite values or the
  wrong leading dimension, the ranks of a group agreeing on the verdict;
- :class:`PreemptionGuard` turns a SIGTERM into an emergency committed
  checkpoint at the next step boundary;
- the typed errors of a failed save and of a non-finite loss, and the exit
  codes a worker dies with (also importable from :mod:`.chaos`).

And the degraded-fabric side, the adaptive loop's:

- :func:`derive_collective_deadline` and :func:`derive_outer_deadline`: a
  collective's time budget from its bytes on the fabric model of
  ``utils.bandwidth``, floored by the measured p50 of recent chunks times
  a slack;
- :class:`CollectiveWatchdog`: a ``parallel.comm`` fence hook that arms a
  deadline at every chunk launch on one monitor thread; an expiry emits
  ``FailureEvent(kind="comm_deadline")`` and marks the attempt, and never
  stops the step;
- :class:`CommDeadlineGuard`: around ``GuardedStep``, one retry of an
  expired step from the state it started from, then the step is marked
  degraded, and K degraded steps in a row raise
  :class:`CommEscalationError`;
- :class:`PartitionPolicy` and :class:`OuterSyncDriver`: the partition
  state machine of the hierarchical round (local rounds charged against a
  divergence budget, the rejoin).

Nothing here imports torch at import time: the supervising parent imports
this package.
"""

from __future__ import annotations

import math
import signal
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional

from ..utils.bandwidth import allreduce_time_s

# exit code of a worker that honoured SIGTERM and committed its emergency
# checkpoint (EX_TEMPFAIL: restartable); the supervisor counts it, like a
# bare SIGTERM death, as a graceful death
PREEMPT_EXIT_CODE = 75
# exit code of a worker whose checkpoint directory refused writes past the
# save retry budget: a hard death, since a restart would die at the same
# commit
CKPT_UNWRITABLE_EXIT_CODE = 44


class NonFiniteLossError(RuntimeError):
    """A step reported a NaN or infinite loss: treated as transient, the
    state it produced is discarded and the step re-run."""


class CommDeadlineError(RuntimeError):
    """A collective overran its derived deadline (shaped as a transient
    error: retryable)."""


class CommEscalationError(Exception):
    """K steps in a row were degraded by collective deadlines: the fabric
    is persistently sick and the supervisor should take over. Deliberately
    not a ``RuntimeError``, so that ``GuardedStep`` and ``retry_transient``
    let it pass."""


class OutOfMemoryError(Exception):
    """The device allocator failed under the guarded step. Deliberately not
    a ``RuntimeError`` (``torch.cuda.OutOfMemoryError`` is one, and
    ``retry_transient`` would replay it): replaying an allocation that just
    exhausted the card reproduces the failure. :class:`GuardedStep` writes
    the forensics report, then raises this so the failure reaches the
    worker's top level."""


# the messages a device out-of-memory arrives with: the CUDA caching
# allocator's, cuBLAS's workspace failure, and the XLA status text that the
# injected ``ChaosOutOfMemoryError`` carries
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "CUDA out of memory", "CUBLAS_STATUS_ALLOC_FAILED")


def is_oom_error(exc: BaseException) -> bool:
    """Whether a raised exception is a device out-of-memory: a
    ``torch.cuda.OutOfMemoryError`` (only looked for where torch is already
    imported), or one of the allocators' messages."""
    torch = sys.modules.get("torch")
    oom_type = getattr(getattr(torch, "cuda", None), "OutOfMemoryError", None)
    if oom_type is not None and isinstance(exc, oom_type):
        return True
    text = str(exc)
    return any(marker in text for marker in _OOM_MARKERS)


class CheckpointUnwritableError(OSError):
    """The checkpoint directory refused a write (read-only filer,
    permissions revoked, a path shadowed by a file). A restart cannot fix
    it, so the worker exits with ``CKPT_UNWRITABLE_EXIT_CODE``. An
    ``OSError``, but not a ``RuntimeError``, so that no transient-retry
    wrapper swallows it."""


class PreemptionGuard:
    """SIGTERM -> "checkpoint at the next step boundary, then stop".

    The handler only raises a flag: the step may be mid-flight when the
    signal lands. ``resilient_train_loop`` reads :attr:`requested` after
    every completed step, agrees on it across the ranks (one of them may
    have been signalled alone), makes the emergency committed save itself,
    sets :attr:`checkpoint_saved` and returns early; the worker then exits
    with ``PREEMPT_EXIT_CODE``.

    Use it as a context manager (or ``install()`` / ``uninstall()``), so
    the previous SIGTERM disposition comes back.
    """

    def __init__(self, telemetry: Any = None, rank: int = 0, incarnation: int = 0, label: str = "train"):
        self._telemetry = telemetry
        self._rank = rank
        self._incarnation = incarnation
        self._label = label
        self._prev = None
        self._installed = False
        self._requested = False
        self.checkpoint_saved = False

    @property
    def requested(self) -> bool:
        return self._requested

    def _notice(self, message: str) -> None:
        self._requested = True
        if self._telemetry is not None:
            from ..observe import FailureEvent

            self._telemetry.emit(
                FailureEvent(
                    kind="preempt_notice", label=self._label, rank=self._rank,
                    incarnation=self._incarnation, message=message,
                )
            )

    def request(self) -> None:
        """Raise the flag without a signal: the handler's body, also callable
        directly (by a cloud preemption-notice poller, or a test)."""
        self._notice("SIGTERM received; emergency checkpoint at next step boundary")

    def peer_request(self) -> None:
        """Raise the flag because another rank was preempted: every rank
        stops at the same step."""
        self._notice("a peer rank was preempted; emergency checkpoint at this step boundary")

    def _handle(self, signum, frame) -> None:
        self.request()

    def install(self) -> "PreemptionGuard":
        self._prev = signal.signal(signal.SIGTERM, self._handle)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev or signal.SIG_DFL)
            self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


def _state_tree_leaves(tree: Any, tensors: List, generators: List) -> None:
    """The tensors and ``torch.Generator``s of a reducer state (a tree of
    NamedTuples, tuples, lists and dicts), in a fixed order."""
    import torch

    if isinstance(tree, torch.Tensor):
        tensors.append(tree)
    elif isinstance(tree, torch.Generator):
        generators.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _state_tree_leaves(v, tensors, generators)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _state_tree_leaves(v, tensors, generators)


class StateSnapshot:
    """A copy of what a training step writes, to put back when the step
    fails: the parameters, momenta, EF memories and model buffers (written
    in place, or swapped for new tensors), the reducer state (its tensors,
    its generators, and the object itself, which a step replaces), the
    ``"optax"`` optimizer's ``state_dict()``, and the CPU and CUDA random
    generators. The copy buffers are allocated at the first :meth:`take`
    and reused; each take and each restore is one ``_foreach_copy_`` a
    dtype (a list of mixed dtypes, such as BatchNorm's int64
    ``num_batches_tracked`` among fp32 tensors, leaves the fused
    multi-tensor route for a copy launch a tensor)."""

    FIELDS = ("params", "momenta", "memories", "model_state")

    def __init__(self):
        self._bufs: Optional[List] = None
        self._layout: Optional[List] = None
        self._groups: List[List[int]] = []  # tensor indices by (dtype, device)
        self._refs: Dict[str, Any] = {}
        self._generators: List = []
        self._rng = None
        self._cuda_rng = None
        self._optimizer = None

    def _live(self, state) -> tuple:
        tensors: List = []
        generators: List = []
        for field in self.FIELDS:
            tensors.extend((getattr(state, field, None) or {}).values())
        _state_tree_leaves(getattr(state, "reducer_state", None), tensors, generators)
        return tensors, generators

    def _copy(self, dst: List, src: List) -> None:
        import torch

        with torch.no_grad():
            for idx in self._groups:
                torch._foreach_copy_([dst[i] for i in idx], [src[i] for i in idx])

    def take(self, state) -> None:
        import copy

        import torch

        tensors, generators = self._live(state)
        # the structure of a run's state does not change, but check it
        # cheaply: the host is what a step waits on
        layout = [(t.shape, t.dtype, t.device) for t in tensors]
        if layout != self._layout:
            self._bufs = [torch.empty_like(t, requires_grad=False) for t in tensors]
            self._layout = layout
            groups: Dict[tuple, List[int]] = {}
            for i, (_, dtype, device) in enumerate(layout):
                groups.setdefault((dtype, device), []).append(i)
            self._groups = list(groups.values())
        self._copy(self._bufs, tensors)
        self._refs = {field: getattr(state, field, None) for field in self.FIELDS + ("reducer_state",)}
        self._generators = [(g, g.get_state()) for g in generators]
        self._rng = torch.get_rng_state()
        self._cuda_rng = torch.cuda.get_rng_state_all() if torch.cuda.is_initialized() else None
        optimizer = getattr(state, "optimizer", None)
        self._optimizer = copy.deepcopy(optimizer.state_dict()) if optimizer is not None else None

    def restore(self, state) -> None:
        import torch

        for field, ref in self._refs.items():
            if hasattr(state, field):
                setattr(state, field, ref)
        tensors, _ = self._live(state)
        self._copy(tensors, self._bufs)
        for g, saved in self._generators:
            g.set_state(saved)
        torch.set_rng_state(self._rng)
        if self._cuda_rng is not None:
            torch.cuda.set_rng_state_all(self._cuda_rng)
        if self._optimizer is not None:
            state.optimizer.load_state_dict(self._optimizer)


class GuardedStep:
    """Retry on a transient error, reject a non-finite loss, and the OOM
    forensics trap, around a training step; every other attribute is the
    step's.

    With ``retries > 0`` each attempt starts from a :class:`StateSnapshot`
    of the state and a failed attempt (an exception or a non-finite loss)
    puts it back, so a retried step lands bit for bit where an untroubled
    one would; when the retries are spent the state is as it was before
    the step and the last error is raised. With ``retries == 0`` no copy is
    made. The loss is read on the host in every attempt (the step's one
    synchronisation, which the loop makes anyway).

    The memory hooks feed the post-mortem: ``memory_sampler``
    (``observe.memory.MemorySampler``, its last sample), ``footprint`` and
    ``buffers_fn`` (``{buffer class: bytes}``, so the report names the top
    suspect). ``oom_report_path`` defaults to
    ``artifacts/oom_report.json``."""

    def __init__(
        self,
        step: Callable,
        retries: int = 2,
        backoff_seconds: float = 0.05,
        max_backoff_seconds: float = 5.0,
        jitter: float = 0.1,
        telemetry: Any = None,
        label: str = "step",
        rank: int = 0,
        memory_sampler: Any = None,
        footprint: Optional[Dict] = None,
        buffers_fn: Optional[Callable[[], Dict[str, float]]] = None,
        oom_report_path: Optional[str] = None,
    ):
        self._inner = step
        self.retries = retries
        self.backoff_seconds = backoff_seconds
        self.max_backoff_seconds = max_backoff_seconds
        self.jitter = jitter
        self._telemetry = telemetry
        self._label = label
        self._rank = rank
        self.memory_sampler = memory_sampler
        self.footprint = footprint
        self._buffers_fn = buffers_fn
        self._oom_report_path = oom_report_path
        self._step_index = 0
        self.snapshot = StateSnapshot() if retries > 0 else None

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _oom(self, exc: BaseException) -> "OutOfMemoryError":
        """Build and write the post-mortem, emit the failure event, and
        return the error for the caller to raise. Every part is best
        effort: a broken report path must not mask the out-of-memory."""
        from ..observe.memory import build_oom_report, write_oom_report

        last = getattr(self.memory_sampler, "last", None)
        buffers = None
        if self._buffers_fn is not None:
            try:
                buffers = self._buffers_fn()
            except Exception:
                buffers = None
        report = build_oom_report(
            error=str(exc), label=self._label, rank=self._rank, step=self._step_index,
            last_memory=last.record() if last is not None else None, footprint=self.footprint, buffers=buffers,
        )
        try:
            path = write_oom_report(report, self._oom_report_path)
        except OSError:
            path = None
        if self._telemetry is not None:
            from ..observe import FailureEvent

            self._telemetry.emit(
                FailureEvent(
                    kind="oom", label=self._label, rank=self._rank, step=self._step_index,
                    message=f"device out of memory (top buffer: {report['top_buffer'] or 'unknown'};"
                            f" forensics: {path or 'unwritable'})",
                )
            )
        return OutOfMemoryError(
            f"{self._label}: device out of memory at step {self._step_index}; forensics at {path or '<unwritable>'}"
        )

    def __call__(self, state, batch):
        from ..utils.failure import retry_transient

        snapshot = self.snapshot

        def attempt():
            if snapshot is not None:
                snapshot.take(state)
            try:
                new_state, loss = self._inner(state, batch)
                # waits for the step: a failure of the device surfaces here
                host_loss = float(loss)
            except RuntimeError as err:
                if snapshot is not None:
                    snapshot.restore(state)
                if is_oom_error(err):
                    raise self._oom(err) from err
                raise
            if not math.isfinite(host_loss):
                if snapshot is not None:
                    snapshot.restore(state)
                raise NonFiniteLossError(f"{self._label}: non-finite loss {host_loss}")
            return new_state, loss

        try:
            return retry_transient(
                attempt, retries=self.retries, backoff_seconds=self.backoff_seconds,
                max_backoff_seconds=self.max_backoff_seconds, jitter=self.jitter, exceptions=(RuntimeError,),
                telemetry=self._telemetry, label=self._label,
            )
        finally:
            self._step_index += 1


def guarded_batches(
    batches_for_epoch: Callable[[int], Iterator[Any]],
    expected_batch: Optional[int] = None,
    telemetry: Any = None,
    label: str = "loader",
    group=None,
) -> Callable[[int], Iterator[Any]]:
    """Wrap a per-epoch batch generator factory: a batch with ragged or
    unexpected leading dimensions (``expected_batch``) or non-finite
    floats is dropped with a ``FailureEvent(kind="bad_batch_dropped")``
    instead of reaching the step.

    Every rank of ``group`` draws the same global batch, but a fault may
    poison it on one rank only; a rank that dropped a batch its peers
    stepped on would leave them waiting in the step's collectives. So on a
    group of more than one rank, the ranks agree on each verdict (one
    int32 max, recorded as ``"bad-batch-flag"``, outside the step's bits)
    and a peer's bad batch is dropped everywhere. A world of one issues no
    collective."""
    import numpy as np

    from ..observe import FailureEvent

    agree_group = None
    if group is not None:
        from ..parallel.comm import world_size

        if world_size(group) > 1:
            agree_group = group

    def problem(batch) -> Optional[str]:
        leaves = list(batch.values()) if isinstance(batch, dict) else list(batch)
        lead = {np.asarray(a).shape[0] for a in leaves}
        if len(lead) > 1:
            return f"ragged leading dims {sorted(lead)}"
        if expected_batch is not None and lead and lead != {expected_batch}:
            return f"leading dim {lead.pop()} != expected {expected_batch}"
        for a in leaves:
            arr = np.asarray(a)
            if np.issubdtype(arr.dtype, np.floating) and not np.all(np.isfinite(arr)):
                return "non-finite values"
        return None

    def gen(epoch: int):
        for i, batch in enumerate(batches_for_epoch(epoch)):
            reason = problem(batch)
            if agree_group is not None:
                from ..parallel.comm import agree

                if agree(int(reason is not None), agree_group, "max", kind="bad-batch-flag") and reason is None:
                    reason = "a peer rank's batch was malformed"
            if reason is not None:
                if telemetry is not None:
                    telemetry.emit(
                        FailureEvent(kind="bad_batch_dropped", label=label, step=i, message=f"epoch {epoch}: {reason}")
                    )
                continue
            yield batch

    return gen


# ---- the degraded fabric: deadlines, the watchdog, the deadline guard ----------


def derive_collective_deadline(
    payload_bytes: int,
    n_workers: int,
    fabric: str = "NVLink4(H100)",
    measured_p50_s: Optional[float] = None,
    slack: float = 4.0,
    floor_s: float = 0.05,
) -> float:
    """A collective's deadline: ``max(modeled time, measured p50) * slack``,
    at least ``floor_s``. The model is ``utils.bandwidth.allreduce_time_s``
    (the ring bound at the fabric's line rate), optimistic by construction,
    hence the slack; the measured p50 of recent chunks keeps the deadline
    honest on a fabric slower than its model; the floor keeps a tiny
    payload from a microsecond deadline."""
    modeled = allreduce_time_s(int(payload_bytes), int(n_workers), fabric)
    budget = max(modeled, measured_p50_s or 0.0) * slack
    return max(budget, floor_s)


def derive_outer_deadline(
    outer_payload_bytes: int,
    n_sites: int,
    fabric: str = "1GbE",
    measured_p50_s: Optional[float] = None,
    slack: float = 6.0,
    floor_s: float = 0.25,
) -> float:
    """The deadline of ONE cross-site outer reduction of the hierarchical
    round: :func:`derive_collective_deadline` for the slow fabric, with
    looser defaults (a WAN edge jitters by orders of magnitude more, and an
    async outer sync costs nothing until the next round needs it: the
    deadline declares the edge dead, not slow). ``outer_payload_bytes`` is
    the compressed outer payload (``bits_by_fabric()["outer"] // 8``)."""
    return derive_collective_deadline(
        outer_payload_bytes, n_sites, fabric, measured_p50_s=measured_p50_s, slack=slack, floor_s=floor_s
    )


class PartitionPolicy:
    """The partition state machine of the hierarchical round, each
    transition a ``PartitionEvent``:

    - :meth:`note_partition`: the cross-site edge is declared dead (an
      outer deadline expired, or the injector's ``partitioned``):
      ``phase="partitioned"``, once a partition;
    - :meth:`note_local_round`: one round ran site-local (``phase="local"``),
      its inner steps charged against ``max_local_steps``;
      :class:`CommEscalationError` once the budget is spent;
    - :meth:`note_sync`: a cross-site sync completed: the staleness
      resets, and after a partition it is the rejoin (``phase="rejoin"``).

    It counts steps and rounds and reads no clock, so a test replays it
    exactly."""

    def __init__(self, max_local_steps: int, telemetry: Any = None, rank: int = 0, incarnation: int = 0):
        self.max_local_steps = int(max_local_steps)
        self._telemetry = telemetry
        self._rank = rank
        self._incarnation = incarnation
        self.partitioned = False
        self.edge: Optional[tuple] = None
        self.local_steps = 0
        self.outer_staleness = 0
        self.events: list = []  # every PartitionEvent, in order

    def _emit(self, phase: str, step: Optional[int], reason: str = ""):
        from ..observe import PartitionEvent

        ev = PartitionEvent(
            phase=phase, edge=list(self.edge) if self.edge is not None else None, local_steps=self.local_steps,
            max_local_steps=self.max_local_steps, outer_staleness=self.outer_staleness, reason=reason,
            rank=self._rank, step=step, incarnation=self._incarnation,
        )
        self.events.append(ev)
        if self._telemetry is not None:
            self._telemetry.emit(ev)
        return ev

    @property
    def remaining_budget(self) -> int:
        return max(0, self.max_local_steps - self.local_steps)

    def note_partition(self, edge: Optional[tuple] = None, step: Optional[int] = None, reason: str = "") -> None:
        """The edge is down; only the first call of a partition emits."""
        if self.partitioned:
            return
        self.partitioned = True
        self.edge = tuple(edge) if edge is not None else None
        self.local_steps = 0
        self._emit("partitioned", step, reason or "cross-site edge declared dead")

    def note_local_round(self, inner_steps: int, step: Optional[int] = None) -> None:
        """One round completed without its cross-site sync."""
        self.local_steps += int(inner_steps)
        self.outer_staleness += 1
        self._emit("local", step)
        if self.local_steps > self.max_local_steps:
            raise CommEscalationError(
                f"partition divergence budget exhausted: {self.local_steps} site-local steps >"
                f" max_local_steps={self.max_local_steps}; escalating to supervisor"
            )

    def note_sync(self, step: Optional[int] = None) -> None:
        """A cross-site sync completed."""
        if self.partitioned:
            self._emit(
                "rejoin", step,
                f"edge healed after {self.local_steps} site-local steps; EF catch-up reduction merged",
            )
            self.partitioned = False
            self.edge = None
            self.local_steps = 0
        self.outer_staleness = 0


class OuterSyncDriver:
    """Decides before each round whether its cross-site sync may run, from
    two signals over a :class:`PartitionPolicy`: the ``probes`` (zero-arg
    callables, such as ``lambda: injector.partitioned``) and an outer
    :class:`CollectiveWatchdog` whose expiry declares the edge dead::

        if driver.should_sync(step=i):
            state, losses = rounds(state, batches)
            driver.note_sync(step=i)
        else:
            state, losses = rounds.local_round(state, batches)
            driver.note_local(rounds.sync_every, step=i)  # may escalate

    The JAX package calls ``watchdog.expired_this_attempt()``, a property
    there, which would raise; the port reads the property."""

    def __init__(self, policy: PartitionPolicy, probes: Any = (), watchdog: Any = None, edge_probe: Any = None):
        self.policy = policy
        self._probes = list(probes)
        self._watchdog = watchdog
        self._edge_probe = edge_probe

    def _partition_reason(self) -> Optional[str]:
        for probe in self._probes:
            if probe():
                return "partition fault active"
        if self._watchdog is not None and self._watchdog.expired_this_attempt:
            return "outer sync deadline expired"
        return None

    def should_sync(self, step: Optional[int] = None) -> bool:
        """True: run the sync round; False: the edge is (still) down, run
        the local round."""
        reason = self._partition_reason()
        if reason is not None:
            edge = self._edge_probe() if self._edge_probe is not None else None
            self.policy.note_partition(edge=edge, step=step, reason=reason)
            return False
        return True

    def note_sync(self, step: Optional[int] = None) -> None:
        if self._watchdog is not None:
            self._watchdog.begin_attempt()
        self.policy.note_sync(step=step)

    def note_local(self, inner_steps: int, step: Optional[int] = None) -> None:
        """Charge one site-local round (raises once the budget is spent)."""
        self.policy.note_local_round(inner_steps, step=step)


class CollectiveWatchdog:
    """A deadline around every fenced chunk collective, as a
    ``parallel.comm`` fence hook.

    One monitor thread watches one deadline under a ``Condition``. Each
    ``launch`` of this rank's collectives arms it with
    :func:`derive_collective_deadline` of the chunk's bytes (the p50 of the
    last ``history`` chunks as its floor), and the next fence point
    disarms it, so the window holds one collective. On the card the fence
    point waits for the stream first (``comm._fence``), so the window is
    the collective's, not the host's enqueue. An expiry emits
    ``FailureEvent(kind="comm_deadline")`` from the monitor thread and
    marks the attempt; it never interrupts the step, which ends (late) on
    its own.

    :meth:`note_step` keeps the streak of degraded steps,
    :meth:`should_escalate` compares it with ``escalate_after`` and
    :meth:`take_epoch` hands the epoch's counters to the fallback
    controller. Register it before any fault injector.

    Inside :meth:`unwatched` the hook arms nothing and keeps no window's
    time: a step that the caller knows to be slow on the host for its own
    reasons (the port's audited step, see ``adaptive_train_loop``)."""

    def __init__(
        self,
        n_workers: int = 1,
        fabric: str = "NVLink4(H100)",
        slack: float = 4.0,
        floor_s: float = 0.05,
        escalate_after: int = 3,
        history: int = 64,
        telemetry: Any = None,
        rank: int = 0,
        label: str = "comm",
    ):
        self.n_workers = n_workers
        self.fabric = fabric
        self.slack = slack
        self.floor_s = floor_s
        self.escalate_after = escalate_after
        self._telemetry = telemetry
        self._rank = rank
        self._label = label
        self._cond = threading.Condition()
        self._deadline: Optional[float] = None
        self._armed: Optional[Dict[str, Any]] = None
        self._arm_t: Optional[float] = None
        self._durations: deque = deque(maxlen=history)
        self._stop = False
        self._expired_this_attempt = False
        self._degraded_streak = 0
        self._epoch_expiries = 0
        self._epoch_degraded = 0
        self._unwatched = False
        self.fired: list = []
        self._thread = threading.Thread(target=self._monitor, name=f"collective-watchdog-{label}", daemon=True)
        self._thread.start()

    # -- the fence hook (the loop's thread) --------------------------------------
    def __call__(self, info: Dict[str, Any]) -> None:
        if info.get("device_index") != self._rank or self._unwatched:
            return
        now = time.monotonic()
        with self._cond:
            if self._arm_t is not None:
                self._durations.append(now - self._arm_t)
            if info.get("phase") == "launch":
                durs = sorted(self._durations)
                p50 = durs[len(durs) // 2] if durs else None
                budget = derive_collective_deadline(
                    info.get("payload_bytes", 0), self.n_workers, self.fabric, measured_p50_s=p50,
                    slack=self.slack, floor_s=self.floor_s,
                )
                self._armed = {**info, "deadline_s": budget}
                self._arm_t = now
                self._deadline = now + budget
            else:  # retire: the payload's last result is in
                self._armed = None
                self._arm_t = None
                self._deadline = None
            self._cond.notify_all()

    # -- the monitor thread -----------------------------------------------------
    def _monitor(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                if self._deadline is None:
                    self._cond.wait()
                    continue
                now = time.monotonic()
                if now < self._deadline:
                    self._cond.wait(self._deadline - now)
                    continue
                info = self._armed or {}
                self._deadline = None
                self._armed = None
                self._arm_t = None
                self._expired_this_attempt = True
                self._epoch_expiries += 1
                self.fired.append(info)
            self._emit_deadline(info)

    def _emit_deadline(self, info: Dict[str, Any]) -> None:
        if self._telemetry is None:
            return
        from ..observe import FailureEvent

        self._telemetry.emit(
            FailureEvent(
                kind="comm_deadline",
                label=f"{info.get('tag', '?')}[{info.get('chunk', '?')}/{info.get('n_chunks', '?')}]",
                message=(
                    f"collective exceeded deadline {info.get('deadline_s', 0.0):.3f}s"
                    f" ({info.get('payload_bytes', 0)} B on {self.fabric})"
                ),
                rank=self._rank,
            )
        )

    @contextmanager
    def unwatched(self) -> Iterator[None]:
        """No deadline, and no window in the history, until the block
        ends. Entered between steps, when no window is open."""
        self._unwatched = True
        try:
            yield
        finally:
            self._unwatched = False

    # -- attempt, step and epoch bookkeeping (the loop's thread) ----------------
    def begin_attempt(self) -> None:
        with self._cond:
            self._expired_this_attempt = False

    @property
    def expired_this_attempt(self) -> bool:
        with self._cond:
            return self._expired_this_attempt

    def note_step(self, degraded: bool) -> None:
        with self._cond:
            if degraded:
                self._degraded_streak += 1
                self._epoch_degraded += 1
            else:
                self._degraded_streak = 0

    def should_escalate(self) -> bool:
        with self._cond:
            return self._degraded_streak >= self.escalate_after

    def take_epoch(self) -> Dict[str, int]:
        """The epoch's counters for the fallback controller, reset (the
        degraded streak is not: escalation is about the fabric, not the
        calendar)."""
        with self._cond:
            out = {"deadline_expiries": self._epoch_expiries, "degraded_steps": self._epoch_degraded}
            self._epoch_expiries = 0
            self._epoch_degraded = 0
            return out

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "CollectiveWatchdog":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class CommDeadlineGuard:
    """Around ``GuardedStep``: an expired collective is not an exception
    (the step returns, late, with a valid state), so the guard reads the
    watchdog's attempt flag after each call. An expired step is retried
    once from the state it started from, then marked degraded; only
    ``escalate_after`` degraded steps in a row raise
    :class:`CommEscalationError`. Every other attribute is the step's.

    The port's step writes its state in place, so the retry needs the
    state back: a :class:`StateSnapshot` taken once a step (one
    ``_foreach_copy_`` a dtype) and put back only on an expiry. Where the
    wrapped step is a ``GuardedStep`` with retries it already took that
    snapshot at the start of its last attempt, and the guard reuses it.

    Over ``group`` (more than one rank) the ranks agree on each attempt's
    verdict (one int32 max, recorded as ``"comm-deadline-flag"``, outside
    the step's ledger): a stall seen on one rank only would otherwise
    retry the step there alone and leave its peers in the next
    collective."""

    def __init__(
        self,
        step: Callable,
        watchdog: CollectiveWatchdog,
        telemetry: Any = None,
        label: str = "step",
        rank: int = 0,
        group=None,
    ):
        self._inner = step
        self._watchdog = watchdog
        self._telemetry = telemetry
        self._label = label
        self._rank = rank
        self._step_index = 0
        self.last_attempts = 0  # the attempts the last call ran (1 or 2)
        self._own_snapshot: Optional[StateSnapshot] = None
        self._agree_group = None
        if group is not None:
            from ..parallel.comm import world_size

            if world_size(group) > 1:
                self._agree_group = group

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _emit(self, kind: str, step: int, message: str) -> None:
        if self._telemetry is None:
            return
        from ..observe import FailureEvent

        self._telemetry.emit(FailureEvent(kind=kind, label=self._label, message=message, rank=self._rank, step=step))

    def _expired(self) -> bool:
        flag = int(self._watchdog.expired_this_attempt)
        if self._agree_group is not None:
            from ..parallel.comm import agree

            flag = agree(flag, self._agree_group, "max", kind="comm-deadline-flag")
        return bool(flag)

    def __call__(self, state, batch):
        wd = self._watchdog
        i = self._step_index
        self._step_index += 1
        snapshot = getattr(self._inner, "snapshot", None)
        if snapshot is None:
            if self._own_snapshot is None:
                self._own_snapshot = StateSnapshot()
            snapshot = self._own_snapshot
            snapshot.take(state)
        wd.begin_attempt()
        self.last_attempts = 1
        out = self._inner(state, batch)
        if not self._expired():
            wd.note_step(False)
            return out
        # a collective overran: the state is usable but suspect; put the
        # step's inputs back and run it once more
        self._emit("comm_step_retry", i, "collective deadline expired; retrying step in place")
        snapshot.restore(state)
        wd.begin_attempt()
        self.last_attempts = 2
        out = self._inner(state, batch)
        if not self._expired():
            wd.note_step(False)
            return out
        wd.note_step(True)
        self._emit("comm_degraded", i, "collective deadline expired on retry; step marked degraded")
        if wd.should_escalate():
            raise CommEscalationError(
                f"{self._label}: {wd.escalate_after} consecutive degraded steps (collective deadlines);"
                f" escalating to supervisor"
            )
        return out
