"""The worker side of the supervisor's environment contract, copied from
the JAX package's ``resilience/supervisor.py``: the incarnation a
restarted worker runs as, which the file spool uses to tell its own dead
predecessor's claims from a live peer's."""

from __future__ import annotations

import os

ENV_INCARNATION = "RESILIENCE_INCARNATION"


def incarnation_from_env(default: int = 0) -> int:
    """Which life of this worker is running (0 = first launch; the
    supervisor increments it on every restart)."""
    try:
        return int(os.environ.get(ENV_INCARNATION, default))
    except ValueError:
        return default
