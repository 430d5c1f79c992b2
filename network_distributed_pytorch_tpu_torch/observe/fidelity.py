"""The gradient-fidelity plane, the JAX package's ``observe/fidelity.py``
for the port: host code over plain dicts, with no clock.

The wire ledger (:mod:`.ledger`) prices every byte a reduction saves; this
module observes what the savings cost: compression error a shape group or
bucket, error-feedback growth, replica drift, and, joined against the
ledger, loss bought per byte.

- :class:`FidelityTracker` turns one health-probe sample (the nested
  ``{group: {rel_error, cosine_sim, ef_norm, quantized_share}}`` dict that
  ``parallel.trainer.make_health_fn`` returns, on the host) into typed
  :class:`~.events.FidelityEvent` records, with each group's EF growth
  against its previous sample.
- :func:`fidelity_summary` aggregates a run's fidelity records a group;
  its ``rel_error`` is the worst group's mean relative error.
- :func:`frontier_from_events` joins the run's ``StepEvent`` losses with
  the cumulative wire bytes, segmented by the fallback ladder's rungs
  (``PolicyEvent``).

Every ``FidelityEvent.tag`` is a wire-ledger tag priced in the same step
(``WireLedger.by_tag``). The samples come at the ``health_every`` cadence:
sampled, never bitwise.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional

from .events import FidelityEvent

#: Relative-growth floor: EF norms below this are treated as zero when
#: computing the growth ratio (a dead-zero memory "growing" to 1e-12 is
#: numerical noise, not a blow-up).
_EF_FLOOR = 1e-12


class FidelityTracker:
    """Per-group host-side fidelity state across health-probe samples.

    ``group_tags`` is the reducer's static ``fidelity group -> wire-ledger
    tag`` map (``reducer.fidelity_group_tags(params_template)``) — events
    for groups missing from it are still emitted but tagged with their own
    group key, so an orphan shows up loudly in the ledger-join test
    instead of being silently dropped.
    """

    def __init__(
        self,
        group_tags: Optional[Mapping[str, str]] = None,
        rank: Optional[int] = None,
        label: str = "",
    ):
        self.group_tags: Dict[str, str] = dict(group_tags or {})
        self.rank = rank
        self.label = label
        self._prev_ef: Dict[str, float] = {}
        self._prev_step: Dict[str, int] = {}

    def events(
        self,
        step: int,
        stats: Mapping[str, Mapping[str, Any]],
        epoch: int = 0,
        drift: Optional[Mapping[str, Any]] = None,
    ) -> List[FidelityEvent]:
        """One probe sample -> typed events, one per group.

        ``ef_growth`` is the relative EF-norm growth since the group's
        previous sample (``(ef - prev) / max(prev, floor)``; 0 on the
        first sample) — the scale-free signal the EF blow-up detector
        watches. Drift scalars are replicated onto every group's event
        (they are whole-state quantities, not per-group ones)."""
        rd = float((drift or {}).get("replica_drift", 0.0) or 0.0)
        ad = float((drift or {}).get("anchor_drift", 0.0) or 0.0)
        out: List[FidelityEvent] = []
        for group in sorted(stats):
            vals = stats[group]
            ef = float(vals.get("ef_norm", 0.0))
            prev = self._prev_ef.get(group)
            if prev is None or prev < _EF_FLOOR:
                growth = 0.0
            else:
                growth = (ef - prev) / prev
            self._prev_ef[group] = ef
            self._prev_step[group] = int(step)
            out.append(
                FidelityEvent(
                    step=int(step),
                    group=group,
                    tag=self.group_tags.get(group, group),
                    epoch=int(epoch),
                    rel_error=float(vals.get("rel_error", 0.0)),
                    cosine_sim=float(vals.get("cosine_sim", 1.0)),
                    ef_norm=ef,
                    ef_growth=growth,
                    quantized_share=float(vals.get("quantized_share", 0.0)),
                    replica_drift=rd,
                    anchor_drift=ad,
                    rank=self.rank,
                    label=self.label,
                )
            )
        return out


def _is_fidelity(rec: Mapping[str, Any]) -> bool:
    return rec.get("event") == FidelityEvent.KIND


def fidelity_summary(records: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
    """Aggregate a run's fidelity records per group.

    Returns ``{"samples", "groups": {group: {...}}, "worst_group",
    "rel_error", "replica_drift": {last, max}, "anchor_drift": {last,
    max}}`` where ``worst_group`` is the group with the highest MEAN
    relative error — the blame assignment the phase-13 game day asserts —
    and ``rel_error`` (the gate's ``fidelity_rel_error``) is that group's
    mean: sustained degradation on the worst layer, robust to a single
    sampled spike. Empty input returns ``samples == 0`` and no groups."""
    groups: Dict[str, Dict[str, Any]] = {}
    samples = 0
    drift_last = {"replica_drift": 0.0, "anchor_drift": 0.0}
    drift_max = {"replica_drift": 0.0, "anchor_drift": 0.0}
    last_drift_step = -1
    for rec in records:
        if not _is_fidelity(rec):
            continue
        samples += 1
        step = int(rec.get("step", 0))
        group = str(rec.get("group", ""))
        g = groups.setdefault(
            group,
            {
                "tag": str(rec.get("tag", group)),
                "samples": 0,
                "first_step": step,
                "last_step": step,
                "last_rel_error": 0.0,
                "max_rel_error": 0.0,
                "sum_rel_error": 0.0,
                "min_cosine_sim": 1.0,
                "last_ef_norm": 0.0,
                "max_ef_norm": 0.0,
                "max_ef_growth": 0.0,
                "quantized_share": 0.0,
            },
        )
        rel = float(rec.get("rel_error", 0.0))
        g["samples"] += 1
        g["sum_rel_error"] += rel
        g["max_rel_error"] = max(g["max_rel_error"], rel)
        g["min_cosine_sim"] = min(
            g["min_cosine_sim"], float(rec.get("cosine_sim", 1.0))
        )
        ef = float(rec.get("ef_norm", 0.0))
        g["max_ef_norm"] = max(g["max_ef_norm"], ef)
        g["max_ef_growth"] = max(
            g["max_ef_growth"], float(rec.get("ef_growth", 0.0))
        )
        if step >= g["last_step"]:
            g["last_step"] = step
            g["last_rel_error"] = rel
            g["last_ef_norm"] = ef
            g["quantized_share"] = float(rec.get("quantized_share", 0.0))
        g["first_step"] = min(g["first_step"], step)
        for key in ("replica_drift", "anchor_drift"):
            v = float(rec.get(key, 0.0))
            drift_max[key] = max(drift_max[key], v)
            if step >= last_drift_step:
                drift_last[key] = v
        last_drift_step = max(last_drift_step, step)
    for g in groups.values():
        g["mean_rel_error"] = g.pop("sum_rel_error") / max(g["samples"], 1)
    worst = None
    if groups:
        worst = max(
            sorted(groups), key=lambda name: groups[name]["mean_rel_error"]
        )
    return {
        "samples": samples,
        "groups": groups,
        "worst_group": worst,
        "rel_error": groups[worst]["mean_rel_error"] if worst else 0.0,
        "replica_drift": {
            "last": drift_last["replica_drift"],
            "max": drift_max["replica_drift"],
        },
        "anchor_drift": {
            "last": drift_last["anchor_drift"],
            "max": drift_max["anchor_drift"],
        },
    }


def frontier_from_events(records: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
    """The accuracy-per-byte frontier: loss vs cumulative wire bytes,
    segmented by fallback-ladder rung.

    Joins the run's ``StepEvent`` trajectory (loss, ``bits_cumulative``)
    against its ``PolicyEvent`` rung transitions: each segment is one rung's
    tenure — the steps it governed, the bytes it spent (end-of-segment
    cumulative ledger bytes minus start), the loss it bought, and the
    headline ``loss_drop_per_gb`` (loss improvement per 10^9 wire bytes;
    negative when the loss ROSE on that rung's watch). Rung boundaries are
    placed at the first step whose epoch reaches the transition's epoch —
    the sampled/merge-tolerance guarantee class, not a bitwise alignment.
    Multi-rank merges are deduplicated by step number (the loss and byte
    counters are replicated across ranks by construction)."""
    steps: Dict[int, Dict[str, Any]] = {}
    policies: List[Dict[str, Any]] = []
    seen_policy = set()
    for rec in records:
        kind = rec.get("event")
        if kind == "step":
            s = int(rec.get("step", 0))
            if s not in steps:
                steps[s] = {
                    "step": s,
                    "epoch": int(rec.get("epoch", 0)),
                    "loss": float(rec.get("loss", 0.0)),
                    "bits": int(rec.get("bits_cumulative", 0)),
                }
        elif kind == "policy":
            key = (
                int(rec.get("epoch", 0)),
                str(rec.get("action", "")),
                str(rec.get("rung_after", "")),
                int(rec.get("rung_index_after", -1)),
            )
            if key in seen_policy:
                continue
            seen_policy.add(key)
            policies.append(
                {
                    "epoch": int(rec.get("epoch", 0)),
                    "action": str(rec.get("action", "")),
                    "rung_before": str(rec.get("rung_before", "")),
                    "rung_after": str(rec.get("rung_after", "")),
                }
            )
    trajectory = [steps[s] for s in sorted(steps)]
    if not trajectory:
        return {"rungs": [], "total_bytes": 0, "final_loss": None, "steps": 0}
    policies.sort(key=lambda p: p["epoch"])

    # boundary index per transition: first step whose epoch >= the
    # transition's epoch (the nudge lands mid-epoch; sampled alignment)
    boundaries: List[int] = []
    names: List[str] = [policies[0]["rung_before"]] if policies else ["run"]
    for pol in policies:
        idx = next(
            (
                i
                for i, st in enumerate(trajectory)
                if st["epoch"] >= pol["epoch"]
            ),
            len(trajectory),
        )
        # a transition landing before the previous one's boundary (same
        # epoch) extends the segment list without creating empty spans
        boundaries.append(max(idx, boundaries[-1] if boundaries else 0))
        names.append(pol["rung_after"])
    bounds = [0] + boundaries + [len(trajectory)]
    rungs: List[Dict[str, Any]] = []
    for i, name in enumerate(names):
        lo, hi = bounds[i], bounds[i + 1]
        if hi <= lo:
            continue
        seg = trajectory[lo:hi]
        prev_bits = trajectory[lo - 1]["bits"] if lo > 0 else 0
        prev_loss = trajectory[lo - 1]["loss"] if lo > 0 else seg[0]["loss"]
        seg_bytes = max(seg[-1]["bits"] - prev_bits, 0) // 8
        loss_drop = prev_loss - seg[-1]["loss"]
        rungs.append(
            {
                "rung": name,
                "start_step": seg[0]["step"],
                "end_step": seg[-1]["step"],
                "steps": len(seg),
                "loss_start": prev_loss,
                "loss_end": seg[-1]["loss"],
                "loss_drop": loss_drop,
                "bytes": seg_bytes,
                "bytes_cumulative_end": seg[-1]["bits"] // 8,
                "loss_drop_per_gb": (
                    loss_drop / (seg_bytes / 1e9) if seg_bytes > 0 else 0.0
                ),
            }
        )
    return {
        "rungs": rungs,
        "total_bytes": trajectory[-1]["bits"] // 8,
        "final_loss": trajectory[-1]["loss"],
        "steps": len(trajectory),
    }
