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

The collective watchdog, the deadline guard and the partition policy of
the JAX module go with the adaptive loop (ROADMAP.md §A item 5). Nothing
here imports torch at import time: the supervising parent imports this
package.
"""

from __future__ import annotations

import math
import signal
import sys
from typing import Any, Callable, Dict, Iterator, List, Optional

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
