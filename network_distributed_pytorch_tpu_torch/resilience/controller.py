"""The fallback controller of the degraded fabric (the port's own copy of
the JAX package's ``resilience/controller.py``).

At every epoch boundary the :class:`FallbackController` reads an
:class:`EpochHealth` summary (the watchdog's counters and the measured step
times, which the training loop builds) and walks an ordered fallback
ladder::

    baseline -> chunked -> ring -> compress -> compress-low-rank -> localsgd
             -> hierarchical -> hierarchical-async

Each rung is a named dict of overrides of the comm knobs (``comm_chunks``,
``comm_strategy``, ``reducer``, ``reducer_rank``, ``sync_every``,
``outer_async``); the loop rebuilds the step ONCE a decision and carries
the training state across. Every move is a ``PolicyEvent`` with the
verdict that triggered it, the rungs before and after, and the predicted
against the realised bytes a step.

Hysteresis: descend after ``descend_after`` degraded epochs in a row
(default 1), ascend only after ``recover_after`` healthy ones in a row
(default 2), healthy also requiring the achieved rate at the rung within
``recover_factor`` of the best that rung has delivered. An epoch that is
neither (the middle band) resets both streaks and holds.

Nothing here imports torch: host floats and dicts only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = [
    "Rung",
    "DEFAULT_LADDER",
    "EpochHealth",
    "PolicyDecision",
    "FallbackController",
    "ladder_from_plan",
]


@dataclass(frozen=True)
class Rung:
    """One rung of the fallback ladder: a name plus the comm-knob override
    dict that configures it. Lower index = more wire-hungry / more exact;
    each descent trades fidelity or latency-sensitivity for fewer or
    smaller or rarer payloads."""

    name: str
    overrides: Dict[str, Any] = field(default_factory=dict)


# The ordered ladder the tentpole specifies: retune chunking first (free —
# same bytes, better overlap), then the explicit ring schedule (same bytes,
# no dependence on the native all-reduce), then PowerSGD compression
# (bytes actually shrink; rank 4 then rank 1), then widen the sync period
# (LocalSGD/DiLoCo-style — pays wire cost every ``sync_every`` steps).
DEFAULT_LADDER: List[Rung] = [
    Rung("baseline", {}),
    Rung("chunked", {"comm_chunks": 4}),
    Rung("ring", {"comm_chunks": 8, "comm_strategy": "ring"}),
    Rung("compress", {"reducer": "powersgd", "reducer_rank": 4}),
    Rung("compress-low-rank", {"reducer": "powersgd", "reducer_rank": 1}),
    Rung(
        "localsgd",
        {"reducer": "powersgd", "reducer_rank": 1, "sync_every": 8},
    ),
    # two-level geo rungs (parallel.hierarchical): exact on the fast
    # in-node axis every step, compressed outer reduction across the
    # fabric matrix's slow edges every ``sync_every`` inner steps —
    # synchronous first, then the async variant whose outer sync overlaps
    # the next window (``outer_async``), the last refuge before a slow
    # cross-site edge must gate step time at all
    Rung(
        "hierarchical",
        {"reducer": "hierarchical", "reducer_rank": 4, "sync_every": 4},
    ),
    Rung(
        "hierarchical-async",
        {
            "reducer": "hierarchical", "reducer_rank": 1, "sync_every": 8,
            "outer_async": 1,
        },
    ),
]


def ladder_from_plan(
    plan: Dict,
    fabric: str,
    ladder: Optional[List[Rung]] = None,
    max_rungs: Optional[int] = None,
) -> List[Rung]:
    """Planner-ordered fallback ladder: reorder ``ladder`` (default
    :data:`DEFAULT_LADDER`) so rungs come predicted-best-first per the
    ``scripts/torch_plan.py`` plan document's per-fabric rung ranking
    (``plan["ladder"][fabric]``, cheapest predicted step first).

    The controller's semantics are untouched — same hysteresis, one
    recompile per decision — only the ORDER it walks changes: under a
    planner-ordered ladder the first descent lands on the config the cost
    model predicts cheapest for this fabric instead of blindly trying
    chunking first. Rung names the plan does not rank keep their relative
    order after the ranked ones (the planner can only reorder what it
    priced); an unknown fabric or an empty ranking returns the ladder
    unchanged, so a stale plan can never brick a launch. ``max_rungs``
    optionally prunes the reordered ladder to its first N rungs."""
    base = list(DEFAULT_LADDER if ladder is None else ladder)
    names = [str(n) for n in (plan.get("ladder") or {}).get(fabric) or []]
    by_name = {r.name: r for r in base}
    ordered = [by_name[n] for n in names if n in by_name]
    seen = {r.name for r in ordered}
    ordered.extend(r for r in base if r.name not in seen)
    if max_rungs is not None and max_rungs > 0:
        ordered = ordered[:max_rungs]
    return ordered


@dataclass
class EpochHealth:
    """One epoch's fabric-health summary, as the training loop measured
    it: host-side step-time p50, the achieved wire rate (ledger bytes per
    measured second), the watchdog's deadline/degraded counters, and the
    straggler-verdict count. All host floats — no device values."""

    epoch: int
    step_p50_s: float = 0.0
    achieved_bytes_per_s: float = 0.0
    deadline_expiries: int = 0
    degraded_steps: int = 0
    stragglers: int = 0


@dataclass
class PolicyDecision:
    """One ladder move: ``action`` ("descend" | "ascend"), the trigger
    verdict string, and the rung before/after. ``overrides`` is the NEW
    rung's knob dict — what the loop must rebuild the step with."""

    action: str
    trigger: str
    epoch: int
    rung_before: str
    rung_after: str
    rung_index_before: int
    rung_index_after: int
    overrides: Dict[str, Any] = field(default_factory=dict)


class FallbackController:
    """Walks the fallback ladder from epoch-boundary health verdicts.

    ``observe(health)`` returns a :class:`PolicyDecision` when the ladder
    should move (the caller rebuilds the step, then calls ``record`` with
    the predicted/realized bytes-per-step so the transition lands in
    telemetry as a ``PolicyEvent``), or None to hold position.

    Degraded when ANY of: deadline expiries, degraded steps, straggler
    flags, or the achieved rate collapsing below ``degrade_factor`` × the
    best rate seen at this rung. Healthy when NONE of those fired AND the
    achieved rate is within ``recover_factor`` of the rung's best. The
    per-rung best is learned online (first epoch at a rung seeds it), so
    the thresholds are relative to what this fabric actually delivered,
    not to the paper's model.
    """

    def __init__(
        self,
        ladder: Optional[List[Rung]] = None,
        start_index: int = 0,
        descend_after: int = 1,
        recover_after: int = 2,
        degrade_factor: float = 0.5,
        recover_factor: float = 0.8,
        telemetry: Any = None,
        rank: int = 0,
    ):
        self.ladder = list(DEFAULT_LADDER if ladder is None else ladder)
        if not self.ladder:
            raise ValueError("fallback ladder must have at least one rung")
        self.index = int(start_index)
        if not 0 <= self.index < len(self.ladder):
            raise ValueError(
                f"start_index {start_index} outside ladder of "
                f"{len(self.ladder)} rungs"
            )
        self.descend_after = descend_after
        self.recover_after = recover_after
        self.degrade_factor = degrade_factor
        self.recover_factor = recover_factor
        self._telemetry = telemetry
        self._rank = rank
        self._degraded_streak = 0
        self._healthy_streak = 0
        self._best_achieved: Dict[int, float] = {}
        self._nudged_epoch: Optional[int] = None
        self.decisions: List[PolicyDecision] = []

    @property
    def rung(self) -> Rung:
        return self.ladder[self.index]

    @property
    def overrides(self) -> Dict[str, Any]:
        return dict(self.rung.overrides)

    def _classify(self, h: EpochHealth) -> str:
        """"degraded" | "healthy" | "indeterminate", with the trigger."""
        faults = []
        if h.deadline_expiries > 0:
            faults.append(f"deadline_expiries={h.deadline_expiries}")
        if h.degraded_steps > 0:
            faults.append(f"degraded_steps={h.degraded_steps}")
        if h.stragglers > 0:
            faults.append(f"stragglers={h.stragglers}")
        best = self._best_achieved.get(self.index, 0.0)
        if h.achieved_bytes_per_s > best:
            self._best_achieved[self.index] = best = h.achieved_bytes_per_s
        if (
            best > 0.0
            and h.achieved_bytes_per_s < self.degrade_factor * best
        ):
            faults.append(
                f"achieved_bytes_per_s={h.achieved_bytes_per_s:.3g}"
                f"<{self.degrade_factor}x best {best:.3g}"
            )
        if faults:
            return "degraded:" + ",".join(faults)
        if (
            best > 0.0
            and h.achieved_bytes_per_s >= self.recover_factor * best
        ):
            return "healthy"
        return "indeterminate"

    def observe(self, health: EpochHealth) -> Optional[PolicyDecision]:
        """Fold one epoch's health in; return the ladder move, if any."""
        if self._nudged_epoch == health.epoch:
            # a mid-epoch alert nudge already spent this epoch's decision
            # budget; the boundary verdict would double-move on the same
            # evidence (the health numbers that raised the alert)
            return None
        verdict = self._classify(health)
        if verdict.startswith("degraded"):
            self._degraded_streak += 1
            self._healthy_streak = 0
            if (
                self._degraded_streak >= self.descend_after
                and self.index < len(self.ladder) - 1
            ):
                return self._move(+1, verdict, health.epoch)
            return None
        if verdict == "healthy":
            self._healthy_streak += 1
            self._degraded_streak = 0
            if self._healthy_streak >= self.recover_after and self.index > 0:
                return self._move(
                    -1,
                    f"recovered:{self._healthy_streak} healthy epochs",
                    health.epoch,
                )
            return None
        # indeterminate: hold position, reset both streaks (hysteresis —
        # a move needs CONSECUTIVE evidence)
        self._degraded_streak = 0
        self._healthy_streak = 0
        return None

    def nudge(
        self, alert: str, epoch: int, severity: str = "warn"
    ) -> Optional[PolicyDecision]:
        """Mid-epoch alert nudge — the live plane's entry point.

        An :class:`observe.events.AlertEvent` from the streaming detectors
        arrives BETWEEN epoch boundaries (tailed off the run's
        ``alerts.jsonl`` feedback channel), so it cannot wait for
        ``observe``. The contract (DESIGN.md "mid-epoch controller
        nudges"):

        - A ``critical`` alert, or any comm-shaped alert
          (``bandwidth_collapse`` / ``step_time_drift``), descends ONE
          rung immediately — the same single-recompile budget as a
          boundary decision, just paid early.
        - A fidelity-shaped alert (``fidelity_collapse`` / ``ef_blowup``,
          any severity) ASCENDS one rung immediately: the gradient plane
          is reporting that the current rung's compression is destroying
          the update, so the fix is MORE fidelity (more bytes), the exact
          opposite of every comm-shaped verdict. A controller already at
          the top rung holds (there is no higher-fidelity config to buy).
        - Any other ``warn`` alert pre-charges the degraded streak: the
          next boundary ``observe`` needs one fewer degraded epoch to
          descend. No decision is returned.
        - At most one nudge per epoch in either direction (the boundary
          hysteresis still owns the cadence), and after a nudge the SAME
          epoch's boundary ``observe`` is a no-op — the epoch's decision
          budget is spent. ``nudged_epoch`` exposes which epoch that was.
        """
        if self._nudged_epoch == epoch:
            return None
        if alert in ("fidelity_collapse", "ef_blowup"):
            if self.index <= 0:
                return None
            self._nudged_epoch = epoch
            return self._move(-1, f"alert:{alert}:{severity}", epoch)
        immediate = severity == "critical" or alert in (
            "bandwidth_collapse",
            "step_time_drift",
        )
        if not immediate:
            self._degraded_streak += 1
            self._healthy_streak = 0
            return None
        if self.index >= len(self.ladder) - 1:
            return None
        self._nudged_epoch = epoch
        return self._move(+1, f"alert:{alert}:{severity}", epoch)

    @property
    def nudged_epoch(self) -> Optional[int]:
        """The epoch whose decision budget a nudge already spent (the
        caller skips that epoch's boundary ``observe``), or None."""
        return self._nudged_epoch

    def _move(self, delta: int, trigger: str, epoch: int) -> PolicyDecision:
        before = self.rung
        before_index = self.index
        self.index += delta
        self._degraded_streak = 0
        self._healthy_streak = 0
        after = self.rung
        decision = PolicyDecision(
            action="descend" if delta > 0 else "ascend",
            trigger=trigger,
            epoch=epoch,
            rung_before=before.name,
            rung_after=after.name,
            rung_index_before=before_index,
            rung_index_after=self.index,
            overrides=dict(after.overrides),
        )
        self.decisions.append(decision)
        return decision

    def record(
        self,
        decision: PolicyDecision,
        predicted_bytes_per_step: Optional[float] = None,
        realized_bytes_per_step: Optional[float] = None,
    ) -> None:
        """Emit the decision as a typed ``PolicyEvent``: predicted = the
        NEW rung's static ledger bytes/step, realized = what the OLD rung
        measurably cost — together the falsifiable claim that the move
        sheds (or restores) wire bytes."""
        if self._telemetry is None:
            return
        from ..observe import PolicyEvent

        self._telemetry.emit(
            PolicyEvent(
                action=decision.action,
                trigger=decision.trigger,
                epoch=decision.epoch,
                rung_before=decision.rung_before,
                rung_after=decision.rung_after,
                rung_index_before=decision.rung_index_before,
                rung_index_after=decision.rung_index_after,
                overrides=dict(decision.overrides),
                predicted_bytes_per_step=predicted_bytes_per_step,
                realized_bytes_per_step=realized_bytes_per_step,
                rank=self._rank,
            )
        )
