"""The cost model's canonical comm config (the part of the JAX package's
``observe/costmodel.py`` that the launcher's ``--plan`` needs).

A plan document of ``scripts/plan.py`` names each fabric's best pick as a
comm config; :func:`canonical_config` normalises it (or a fallback-ladder
rung's overrides, or a ``CompileEvent.comm_config``) to the knob dict
that predictions and runs join on. The rest of the cost model (the
what-if pricing, its calibration and its events) is ROADMAP.md §A
item 5.
"""

from __future__ import annotations

from typing import Dict, Optional


def canonical_config(config: Optional[Dict], name: str = "") -> Dict:
    """``config`` as the canonical knob dict: ``name``, ``reducer``
    (``"exact"``, ``"powersgd"`` or ``"hierarchical"``), ``reducer_rank``
    (1 at least for PowerSGD), ``comm_chunks``, ``comm_strategy``,
    ``bucket_bytes``, ``sync_every`` (1 at least), and the two-level knobs
    ``outer_async`` and ``sites``."""
    config = config or {}
    reducer = str(config.get("reducer") or "exact").lower()
    if "powersgd" in reducer:
        reducer = "powersgd"
    elif "hier" in reducer:
        reducer = "hierarchical"
    elif reducer not in ("exact",):
        reducer = "exact" if "exact" in reducer else reducer
    rank = config.get("reducer_rank")
    out = {
        "name": str(config.get("name") or name or ""),
        "reducer": reducer,
        "reducer_rank": int(rank) if rank else 0,
        "comm_chunks": int(config.get("comm_chunks") or 0),
        "comm_strategy": str(config.get("comm_strategy") or "interleave"),
        "bucket_bytes": int(config.get("bucket_bytes") or 0),
        "sync_every": max(1, int(config.get("sync_every") or 1)),
        # the two-level knobs: meaningful only for reducer="hierarchical"
        "outer_async": 1 if config.get("outer_async") else 0,
        "sites": int(config.get("sites") or 0),
    }
    if out["reducer"] == "powersgd" and out["reducer_rank"] == 0:
        out["reducer_rank"] = 1
    return out
