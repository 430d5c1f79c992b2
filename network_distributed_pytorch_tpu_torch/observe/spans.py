"""Nested host-side spans, the JAX package's ``observe/spans.py`` for the
port: ``with span("step/compute"): ...`` times a named region on the
monotonic clock and emits one :class:`..observe.events.SpanEvent` when it
closes, with its parent span's id and its depth, so a run log rebuilds
where the host's time went.

- The span stack is thread-local and span ids are unique in the process.
- A training loop installs its telemetry as the process's *ambient*
  recorder (:func:`recording`); code deeper down calls ``span(...)`` and
  emits through it, or keeps only the nesting when none is installed.
- Durations come from ``time.monotonic()``; the wall clock is stamped by
  ``Telemetry.emit`` when the span closes.
- While a ``torch.profiler`` trace is being recorded, each span is also a
  ``torch.profiler.record_function`` range, so the host's phases land in
  the device trace (the JAX package mirrors them into
  ``jax.profiler.TraceAnnotation``). Outside a trace a span pays nothing
  for it.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Iterator, Optional

import torch

from .events import SpanEvent
from .telemetry import Telemetry

_LOCAL = threading.local()
_IDS = itertools.count(1)  # itertools.count.__next__ is atomic
_AMBIENT: Optional[Telemetry] = None

# a managed rank's spans carry its rank (the supervisor's environment)
_ENV_RANK = "RESILIENCE_RANK"


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def set_ambient(telemetry: Optional[Telemetry]) -> Optional[Telemetry]:
    """Install ``telemetry`` as the process's span recorder; returns the
    previous one."""
    global _AMBIENT
    previous = _AMBIENT
    _AMBIENT = telemetry
    return previous


def ambient() -> Optional[Telemetry]:
    return _AMBIENT


@contextlib.contextmanager
def recording(telemetry: Optional[Telemetry]) -> Iterator[None]:
    """``telemetry`` as the ambient span recorder for the block, the prior
    one restored after."""
    previous = set_ambient(telemetry)
    try:
        yield
    finally:
        set_ambient(previous)


def current_span_id() -> Optional[int]:
    """The innermost open span's id on this thread (None outside spans)."""
    stack = _stack()
    return stack[-1][0] if stack else None


def _default_rank() -> Optional[int]:
    try:
        return int(os.environ[_ENV_RANK])
    except (KeyError, TypeError, ValueError):
        return None


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) is recording."""
    return torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def span(
    name: str,
    telemetry: Optional[Telemetry] = None,
    step: Optional[int] = None,
    rank: Optional[int] = None,
    mirror: bool = True,
) -> Iterator[None]:
    """Time a named region and emit a :class:`SpanEvent` when it closes.

    ``telemetry`` overrides the ambient recorder; with neither, the span
    keeps the nesting stack (so an inner recorded span keeps its parent)
    and emits nothing. ``mirror=False`` leaves the profiler range out."""
    recorder = telemetry if telemetry is not None else _AMBIENT
    stack = _stack()
    span_id = next(_IDS)
    parent_id = stack[-1][0] if stack else None
    depth = len(stack)
    stack.append((span_id, name))
    annotation = torch.profiler.record_function(name) if mirror and profiler_active() else None
    if annotation is not None:
        annotation.__enter__()
    t0 = time.monotonic()
    try:
        yield
    finally:
        dur = time.monotonic() - t0
        if annotation is not None:
            annotation.__exit__(None, None, None)
        stack.pop()
        if recorder is not None:
            recorder.emit(
                SpanEvent(
                    name=name,
                    span_id=span_id,
                    parent_id=parent_id,
                    depth=depth,
                    dur_s=dur,
                    step=step,
                    rank=rank if rank is not None else _default_rank(),
                )
            )
