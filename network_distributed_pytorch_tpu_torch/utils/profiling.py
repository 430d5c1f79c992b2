"""Profiling, the JAX package's ``utils/profiling.py`` for the port.

:func:`trace` records a ``torch.profiler`` trace of CPU and CUDA activity
(the host's operators and ranges, the card's kernels and copies) and
writes it into ``log_dir`` as a Chrome trace, which Perfetto and
``chrome://tracing`` open. :func:`step_annotation` and :func:`annotate`
name ranges in it (``torch.profiler.record_function``); outside a trace
they do nothing, so an unprofiled step pays nothing for them.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch

from ..observe.spans import profiler_active

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Record a profiler trace of the block and write it to
    ``log_dir/trace.json`` when the block ends (CUDA activity where a card
    is present)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))


def annotate(name: str):
    """A named host range in the trace (``record_function``); nothing
    outside a trace."""
    return torch.profiler.record_function(name) if profiler_active() else contextlib.nullcontext()


def step_annotation(name: str, step: int):
    """A range ``"{name}#{step}"`` around a training step in the trace (the
    JAX package's ``StepTraceAnnotation``); nothing outside a trace."""
    return annotate(f"{name}#{step}")
