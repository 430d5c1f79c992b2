"""Timing that waits for the work it times, the JAX package's
``utils/timing.py`` for the port. CUDA launches return before the card
finishes, so every timed region here ends by fetching a small result to
the host, which waits for the computation that produced it."""

from __future__ import annotations

import time
from typing import Callable

import torch


def wait_result(x):
    """``x`` on the host: a tensor's ``.item()`` (one element) or
    ``.cpu()``, each of which waits for the kernels that produce it;
    tuples, lists and dicts element by element. Use a SMALL output (a
    loss) so that the copy itself costs nothing."""
    if isinstance(x, torch.Tensor):
        return x.item() if x.numel() == 1 else x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(wait_result(v) for v in x)
    if isinstance(x, dict):
        return {k: wait_result(v) for k, v in x.items()}
    return x


def time_amortized(fn: Callable[[], object], repeats: int = 3) -> float:
    """Mean seconds a call of ``fn`` over ``repeats`` calls, each fetched
    with :func:`wait_result` before the next starts (so the calls cannot
    overlap: biased high by one host round trip a call, never low). The
    caller warms up (builds the kernels) first."""
    wait_result(fn())  # settle pending work outside the timed region
    t0 = time.perf_counter()
    for _ in range(repeats):
        wait_result(fn())
    return (time.perf_counter() - t0) / repeats
