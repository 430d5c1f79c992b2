"""The recovery guards of the checkpointed training loop, the narrow part
of the JAX package's ``resilience/guards.py`` it needs: the typed errors
of a failed save and of a non-finite loss, the exit codes a worker dies
with, and :class:`PreemptionGuard`, which turns a SIGTERM into an
emergency committed checkpoint at the next step boundary.

``GuardedStep`` and ``guarded_batches`` (retry on a transient error, drop
a malformed batch) come with the chaos plan that turns them on; until
then ``resilient_train_loop`` refuses ``step_retries`` and
``guard_batches``.
"""

from __future__ import annotations

import signal
from typing import Any

# exit code of a worker that honoured SIGTERM and committed its emergency
# checkpoint (EX_TEMPFAIL: restartable); the supervisor counts it, like a
# bare SIGTERM death, as a graceful death
PREEMPT_EXIT_CODE = 75
# exit code of a worker whose checkpoint directory refused writes past the
# save retry budget: a hard death, since a restart would die at the same
# commit
CKPT_UNWRITABLE_EXIT_CODE = 44


class NonFiniteLossError(RuntimeError):
    """A step reported a NaN or infinite loss."""


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
