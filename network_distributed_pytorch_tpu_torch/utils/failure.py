"""Failure detection for the training loop, the JAX package's
``utils/failure.py``:

- :class:`StepWatchdog` runs a callback when a watched step outlives its
  deadline (a peer died mid-collective, so the all-reduce never returns).
  A hung collective cannot be interrupted from Python, so the callback
  reports and decides (e.g. ``os._exit`` for a supervisor restart).
  ``compile_grace`` leaves the first watched regions unwatched: the first
  step pays the kernels' build and the allocator's warm-up.
- :func:`retry_transient` retries a call that raised a transient error,
  with a capped exponential backoff and a seeded jitter; every attempt is a
  ``FailureEvent(kind="retry")``.
- :class:`HeartbeatMonitor` is liveness over a shared filesystem: each
  process beats its own file, any process lists the peers whose beat has
  gone stale.
"""

from __future__ import annotations

import json
import os
import random
import sys
import threading
import time
from typing import Callable, Dict, List, Optional


class StepWatchdog:
    """Deadline monitor for calls that may hang::

        wd = StepWatchdog(timeout_seconds=300, on_timeout=report_and_exit)
        with wd.watch(f"step {i}"):
            state, loss = step(state, batch)

    ``on_timeout(label)`` runs on the one monitor thread when a watched
    region passes its deadline; the default prints a ``watchdog_timeout``
    :class:`..observe.FailureEvent` banner to standard error."""

    def __init__(
        self,
        timeout_seconds: float,
        on_timeout: Optional[Callable[[str], None]] = None,
        compile_grace: int = 0,
    ):
        self.timeout_seconds = timeout_seconds
        self.on_timeout = on_timeout or self._default_report
        self.compile_grace = compile_grace
        self.fired: List[str] = []  # labels whose deadline passed
        self._watch_count = 0
        self._cond = threading.Condition()
        self._fired_lock = threading.Lock()  # fired is appended on the monitor thread
        self._deadline: Optional[float] = None
        self._label: Optional[str] = None
        self._thread: Optional[threading.Thread] = None

    def reset(self) -> None:
        """Disarm, zero the watch count (so ``compile_grace`` applies
        again) and clear the fired history; the thread is reused."""
        with self._cond:
            self._deadline = None
            self._label = None
            self._watch_count = 0
            self._cond.notify()
        with self._fired_lock:
            self.fired.clear()

    @staticmethod
    def _default_report(label: str) -> None:
        from ..observe import FailureEvent

        sys.stderr.write(FailureEvent(kind="watchdog_timeout", label=label).banner() + "\n")

    def _monitor(self) -> None:
        while True:
            with self._cond:
                while self._deadline is None:
                    self._cond.wait()
                remaining = self._deadline - time.monotonic()
                if remaining > 0:
                    self._cond.wait(remaining)
                    continue
                label = self._label
                self._deadline = None
                self._label = None
            with self._fired_lock:
                self.fired.append(label)
            self.on_timeout(label)

    def _arm(self, label: str) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._monitor, daemon=True)
            self._thread.start()
        with self._cond:
            self._deadline = time.monotonic() + self.timeout_seconds
            self._label = label
            self._cond.notify()

    def _disarm(self) -> None:
        with self._cond:
            self._deadline = None
            self._label = None
            self._cond.notify()

    class _Watch:
        def __init__(self, wd: "StepWatchdog", label: str):
            self.wd = wd
            self.label = label
            self.armed = False

        def __enter__(self):
            with self.wd._cond:
                self.wd._watch_count += 1
                self.armed = self.wd._watch_count > self.wd.compile_grace
            if self.armed:
                self.wd._arm(self.label)
            return self

        def __exit__(self, *exc):
            if self.armed:
                self.wd._disarm()
            return False

    def watch(self, label: str = "step") -> "_Watch":
        return self._Watch(self, label)


def retry_transient(
    fn: Callable,
    retries: int = 3,
    backoff_seconds: float = 1.0,
    exceptions=(RuntimeError,),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    max_backoff_seconds: Optional[float] = None,
    jitter: float = 0.0,
    telemetry=None,
    label: str = "",
    rng: Optional[random.Random] = None,
):
    """Call ``fn()``; on one of ``exceptions`` retry up to ``retries``
    times, sleeping ``backoff_seconds * 2 ** (attempt - 1)`` (capped at
    ``max_backoff_seconds``) times ``1 + jitter * u`` with ``u`` uniform
    in [0, 1) from ``rng`` (the ``random`` module when None), so ranks
    retrying the same fault do not stampede in lockstep. Re-raises the last
    error when the retries are spent. Every failed attempt is emitted as a
    ``FailureEvent(kind="retry")`` through ``telemetry`` (the banner-only
    default registry when None)."""
    from ..observe import FailureEvent, default_telemetry

    emit_to = telemetry if telemetry is not None else default_telemetry()
    rng = rng if rng is not None else random
    attempt = 0
    while True:
        try:
            return fn()
        except exceptions as e:  # noqa: PERF203
            attempt += 1
            emit_to.emit(
                FailureEvent(kind="retry", label=label, message=f"attempt {attempt}/{retries}: {type(e).__name__}: {e}")
            )
            if attempt > retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            delay = backoff_seconds * (2 ** (attempt - 1))
            if max_backoff_seconds is not None:
                delay = min(delay, max_backoff_seconds)
            if jitter > 0:
                delay *= 1.0 + jitter * rng.random()
            time.sleep(delay)


class HeartbeatMonitor:
    """Liveness through per-process heartbeat files on a shared filesystem:
    process ``i`` writes ``<dir>/heartbeat_<i>.json`` when it beats;
    :meth:`stale_peers` lists the processes whose last beat is older than
    a threshold (or that never beat, once the start-up grace has passed).
    ``min_interval_seconds`` rate-limits the beats, so ``beat()`` can sit
    in the step loop."""

    def __init__(
        self,
        directory: str,
        process_id: int,
        num_processes: int,
        min_interval_seconds: float = 0.0,
        incarnation: int = 0,
        startup_grace_seconds: Optional[float] = None,
    ):
        self.directory = directory
        self.process_id = process_id
        self.num_processes = num_processes
        self.min_interval_seconds = min_interval_seconds
        # which life of this rank beats: a restarted worker's beat tells the
        # live replacement apart from its dead predecessor's file
        self.incarnation = incarnation
        self.startup_grace_seconds = startup_grace_seconds
        self._created_ts = time.time()
        self._last_beat = -float("inf")
        os.makedirs(directory, exist_ok=True)

    def _path(self, pid: int) -> str:
        return os.path.join(self.directory, f"heartbeat_{pid}.json")

    def beat(self, **extra) -> None:
        """Write this process's heartbeat (an atomic rename); nothing when
        the last beat is newer than ``min_interval_seconds``."""
        now = time.monotonic()
        if now - self._last_beat < self.min_interval_seconds:
            return
        self._last_beat = now
        payload = {"process_id": self.process_id, "incarnation": self.incarnation, "ts": time.time(), **extra}
        tmp = self._path(self.process_id) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self._path(self.process_id))

    def peer_payloads(self) -> Dict[int, Optional[Dict]]:
        """Each process's latest beat (None: never beat)."""
        out: Dict[int, Optional[Dict]] = {}
        for pid in range(self.num_processes):
            try:
                with open(self._path(pid)) as f:
                    payload = json.load(f)
                out[pid] = payload if "ts" in payload else None
            except (OSError, ValueError):
                out[pid] = None
        return out

    def last_beats(self) -> Dict[int, Optional[float]]:
        """The time of each process's latest beat (None: never beat)."""
        return {pid: (p["ts"] if p is not None else None) for pid, p in self.peer_payloads().items()}

    def stale_peers(self, threshold_seconds: float) -> List[int]:
        """Process ids (this one excluded) not seen within the threshold."""
        now = time.time()
        grace = self.startup_grace_seconds if self.startup_grace_seconds is not None else threshold_seconds
        booting = now - self._created_ts <= grace
        stale = []
        for pid, ts in self.last_beats().items():
            if pid == self.process_id:
                continue
            if ts is None:
                if not booting:
                    stale.append(pid)
            elif now - ts > threshold_seconds:
                stale.append(pid)
        return stale
