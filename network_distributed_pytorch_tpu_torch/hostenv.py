"""The CUDA preflight, the port's form of the JAX package's ``hostenv.py``.

There, the module pins JAX's host platform (``force_cpu_devices``, XLA
flags) and probes the backend before a run. XLA flags have no meaning for
the port's ranks, so only the probe is ported: :func:`backend_preflight`
asks for the CUDA device count and the first card's name in a thread with
a wall deadline, once a process, and returns the same verdict dict.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

# one verdict a process: the thing probed is exactly what hangs on a wedged
# driver, and a thread stuck inside it cannot be cancelled, so a second
# caller must not start another
_PREFLIGHT: Optional[Dict] = None


def _probe() -> Tuple[str, int]:
    """``(platform, n_devices)`` of the CUDA backend; initialises it."""
    import torch

    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("no CUDA device: torch.cuda.device_count() is 0")
    torch.cuda.get_device_name(0)  # the context, not just the count
    return "gpu", n


def backend_preflight(
    timeout_s: float = 60.0,
    attempts: int = 2,
    backoff_s: float = 2.0,
    backoff_max_s: float = 30.0,
    force: bool = False,
    retry_on_timeout: bool = False,
) -> Dict:
    """Probe the CUDA backend once a process: ``torch.cuda.device_count()``
    and the first card's name in a daemon thread with a wall deadline,
    retried with bounded exponential backoff.

    Returns (and caches) the JAX package's verdict dict::

        {"ok": bool, "platform": str|None, "n_devices": int|None,
         "cause": str|None, "attempts": int, "elapsed_s": float}

    ``cause`` names why the probe failed: ``init_timeout: ...`` for a
    deadline overrun, ``SomeError: ...`` for a raised error (no card among
    them). ``force=True`` discards the cached verdict and probes again.
    ``retry_on_timeout=False`` (the default) stops after the first
    overrun: a raised error may be transient, but a hang rarely heals, and
    a caller with a deadline of its own needs the verdict within one
    probe's time."""
    global _PREFLIGHT
    if _PREFLIGHT is not None and not force:
        return _PREFLIGHT
    t0 = time.monotonic()
    verdict: Dict = {"ok": False, "platform": None, "n_devices": None, "cause": None, "attempts": 0, "elapsed_s": 0.0}
    tries = max(1, attempts)
    for attempt in range(tries):
        verdict["attempts"] = attempt + 1
        box: Dict = {}

        def run() -> None:
            try:
                box["platform"], box["n"] = _probe()
            except BaseException as e:  # noqa: BLE001 - a verdict, not a crash
                box["error"] = f"{type(e).__name__}: {e}"[:400]

        t = threading.Thread(target=run, name="backend-preflight", daemon=True)
        t.start()
        t.join(timeout_s)
        if t.is_alive():
            verdict["cause"] = (
                f"init_timeout: torch.cuda.device_count() still hung after {timeout_s:.0f}s"
                f" (attempt {attempt + 1}/{tries})"
            )
            if not retry_on_timeout:
                break
        elif "error" in box:
            verdict["cause"] = box["error"]
        else:
            verdict.update(ok=True, platform=box["platform"], n_devices=box["n"], cause=None)
            break
        if attempt + 1 < tries:
            time.sleep(min(backoff_s * (2**attempt), backoff_max_s))
    verdict["elapsed_s"] = time.monotonic() - t0
    _PREFLIGHT = verdict
    return verdict
