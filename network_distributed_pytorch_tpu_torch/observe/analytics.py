"""Run-level analytics over a merged cross-rank timeline. The port's own
copy of the JAX package's ``observe/analytics.py``.

Two estimators:

**Straggler detection.** Per-rank steady-state step-duration distributions
(the first timed step per rank pays the kernels' builds and the
allocator's warm-up and is dropped, the JAX package's report's
convention); a rank whose p50 exceeds the cross-rank median p50 by more
than a configurable factor is flagged as a typed
:class:`observe.events.StragglerEvent`. The median is the baseline —
robust to the stragglers themselves — and the default factor of 1.5x sits
above same-host scheduling jitter (tens of percent) but below the 2x+
signature of a genuinely slow or contended rank.

**Effective bandwidth.** The wire ledger says how many bytes each
collective moves per step (exact — audited against the collectives a step
issued); the measured step time says how long a step takes; the
schedule's overlap extract (``utils.overlap.comm_attribution``) says what
fraction of the collectives are exposed on the critical path. ``bytes /
(step_p50 × exposed_fraction)`` is the achieved wire rate, compared
against every ``FABRICS_BYTES_PER_S`` line rate as a utilization fraction
and against the ring model (``utils.bandwidth``) as the
measured-vs-modeled verdict.

Imports no torch: ``utils.bandwidth`` and ``utils.overlap`` are
stdlib-only, and so is the package around them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..utils import bandwidth as _bandwidth
from ..utils import overlap as _overlap
from .events import StragglerEvent

DEFAULT_STRAGGLER_FACTOR = 1.5


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile (exact for the small samples a run has)."""
    if not values:
        return float("nan")
    ordered = sorted(values)
    k = max(0, min(len(ordered) - 1, round(p / 100 * (len(ordered) - 1))))
    return ordered[int(k)]


# ---------------------------------------------------------------------------
# straggler detection
# ---------------------------------------------------------------------------


def rank_step_stats(events: List[Dict], drop_first: bool = True) -> Dict[int, Dict]:
    """Per-rank step-duration distributions from merged (rank-tagged)
    events: ``{rank: {n, p50_s, p95_s, mean_s}}``. Only ``valid`` steps
    count; with ``drop_first`` the first timed step per rank (its build)
    is excluded when the rank has more than one."""
    durations: Dict[int, List[float]] = {}
    for e in events:
        if e.get("event") != "step" or not e.get("valid", True):
            continue
        rank = e.get("rank")
        dt = e.get("step_time_s")
        if rank is None or not isinstance(dt, (int, float)):
            continue
        durations.setdefault(int(rank), []).append(float(dt))
    stats: Dict[int, Dict] = {}
    for rank, d in sorted(durations.items()):
        steady = d[1:] if drop_first and len(d) > 1 else d
        stats[rank] = {
            "n": len(steady),
            "p50_s": percentile(steady, 50),
            "p95_s": percentile(steady, 95),
            "mean_s": sum(steady) / len(steady),
        }
    return stats


def detect_stragglers(
    stats: Dict[int, Dict],
    factor: float = DEFAULT_STRAGGLER_FACTOR,
    min_steps: int = 2,
) -> List[StragglerEvent]:
    """Flag every rank whose steady-state p50 exceeds ``factor`` times the
    cross-rank median p50. Needs at least two ranks with ``min_steps``
    timed steps each — a one-rank run has no peer to lag behind."""
    eligible = {
        r: s for r, s in stats.items()
        if s["n"] >= min_steps and s["p50_s"] == s["p50_s"]  # not NaN
    }
    if len(eligible) < 2:
        return []
    median = percentile([s["p50_s"] for s in eligible.values()], 50)
    if not median > 0:
        return []
    out: List[StragglerEvent] = []
    for rank, s in sorted(eligible.items()):
        ratio = s["p50_s"] / median
        if ratio > factor:
            out.append(
                StragglerEvent(
                    rank=rank,
                    p50_s=s["p50_s"],
                    median_p50_s=median,
                    factor=ratio,
                    threshold=factor,
                    n_steps=s["n"],
                )
            )
    return out


# ---------------------------------------------------------------------------
# effective bandwidth
# ---------------------------------------------------------------------------


def _dedupe_collectives(collectives: List[Dict]) -> List[Dict]:
    """The wire ledger is replicated: every rank (and every incarnation)
    emits the SAME per-step CollectiveEvents for a compiled step. Keep the
    first record per (label, tag, op, dtype) — summing across shards would
    multiply bytes by world size × restarts."""
    seen = set()
    out: List[Dict] = []
    for c in collectives:
        key = (c.get("label"), c.get("tag"), c.get("op"), c.get("dtype"))
        if key in seen:
            continue
        seen.add(key)
        out.append(c)
    return out


def effective_bandwidth(
    step_time_s: float,
    collectives: List[Dict],
    n_workers: int,
    overlap: Optional[Dict] = None,
    fabrics: Optional[Sequence[str]] = None,
    matrix: Optional[Dict] = None,
) -> Optional[Dict]:
    """Achieved wire rate and per-fabric utilization for one run.

    ``step_time_s`` is the measured steady-state step time (cross-rank
    median p50); ``collectives`` are CollectiveEvent records (deduped here
    across rank shards); ``overlap`` is a CompileEvent's overlap extract
    (None ⇒ all collectives treated as exposed); ``matrix`` is an optional
    measured per-edge fabric matrix (the JAX package's ``observe.fabric``
    writes one) — when present,
    the modeled comm time prices the ring against its slowest edge via the
    shared :func:`utils.bandwidth.fabric_model` accessor. Returns None
    when there is nothing to estimate."""
    collectives = _dedupe_collectives(
        [c for c in collectives if isinstance(c.get("payload_bytes"), (int, float))]
    )
    if not collectives or not isinstance(step_time_s, (int, float)):
        return None
    if not step_time_s > 0:
        return None
    model = _bandwidth.fabric_model(matrix)
    fabrics = list(fabrics) if fabrics else list(model.fabrics)

    attribution = _overlap.comm_attribution(overlap or {})
    # the exposed-comm budget: with no schedule evidence every collective
    # is charged to the critical path (exposed_fraction 1.0 — the honest
    # lower bound on achieved bandwidth)
    exposed = (
        attribution["exposed_fraction"] if attribution["n_collectives"] else 1.0
    )
    budget_s = step_time_s * exposed
    if not budget_s > 0:
        budget_s = step_time_s

    total_bytes = sum(float(c["payload_bytes"]) for c in collectives)
    total_count = sum(int(c.get("count", 1)) for c in collectives)
    achieved = total_bytes / budget_s

    def _fabric_views(payload_bytes: float, count: int) -> Dict[str, Dict]:
        util = {}
        modeled = {}
        for f in fabrics:
            util[f] = achieved / model.bytes_per_s(f)
            modeled[f] = model.allreduce_time_s(
                payload_bytes, max(n_workers, 1), f, n_collectives=max(count, 1)
            )
        return {"utilization": util, "modeled_comm_s": modeled}

    by_tag = []
    for c in collectives:
        payload = float(c["payload_bytes"])
        count = int(c.get("count", 1))
        share = payload / total_bytes if total_bytes else 0.0
        by_tag.append(
            {
                "tag": c.get("tag"),
                "op": c.get("op"),
                "label": c.get("label"),
                "payload_bytes": payload,
                "count": count,
                "comm_time_s": budget_s * share,
                "achieved_bytes_per_s": achieved,
                **_fabric_views(payload, count),
            }
        )
    return {
        "step_time_s": step_time_s,
        "n_workers": n_workers,
        "comm_budget_s": budget_s,
        "attribution": attribution,
        "total": {
            "payload_bytes": total_bytes,
            "count": total_count,
            "comm_time_s": budget_s,
            "achieved_bytes_per_s": achieved,
            **_fabric_views(total_bytes, total_count),
        },
        "by_tag": by_tag,
    }
