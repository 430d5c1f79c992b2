"""Streaming health detectors: EWMA envelopes over the live event stream.
The port's own copy of the JAX package's ``observe/health.py``: the same
detectors, thresholds and alert records, so a stream of events pages the
same way in both packages.

The post-hoc report (``scripts/report.py``) can afford full-history
percentiles; the live plane cannot — it sees events one at a time and must
decide *now* whether a signal left its healthy envelope. Every detector
here is built on the same O(1) primitive: an exponentially weighted moving
average of the signal and of its square (:class:`Ewma`), giving a running
mean and standard deviation with no history buffer. A detector fires when
its condition holds for ``sustain`` consecutive observations (one noisy
sample never pages anyone), then goes quiet for ``cooldown`` observations
so a persistently sick signal produces a heartbeat of alerts rather than
one per event.

Detectors are deliberately clock-free: they consume values carried BY the
events (``step_time_s``, ``grad_norm``, window bytes/s computed by the
aggregator) and count observations instead of reading any clock, so the
same code is exact in replay/tests and live. This module imports no torch
and is import-light — the supervisor runs it in its poll loop.

Thresholds (the JAX package's values):

- ``grad_spike``: value > mean + ``spike_sigma``·std (and > ``spike_factor``
  × mean, guarding the near-zero-variance warmup); a NON-FINITE grad norm
  or one beyond ``nan_factor`` × mean is severity ``critical`` — the
  sustained-NaN-precursor signal the supervisor may restart on.
- ``loss_plateau``: the EWMA of per-observation loss improvement stays
  below ``plateau_eps`` (relative to the loss scale) for ``sustain`` obs.
- ``step_time_drift``: a short-horizon EWMA of step time exceeds
  ``drift_factor`` × the long-horizon EWMA.
- ``bandwidth_collapse``: the achieved bytes/s window drops below
  ``collapse_frac`` × its own long-horizon EWMA.
- ``slo_burn``: the rolling serving p99 total latency exceeds
  ``slo_target_s`` (budget burn, not mean shift — p99 comes from the
  registry's ring-buffer histogram, computed by the aggregator).
- ``hbm_headroom``: the EWMA of the device-memory occupancy fraction
  (``bytes_in_use / bytes_limit`` from :class:`observe.events.MemoryEvent`)
  crosses ``headroom_warn_frac`` (warn) or ``headroom_critical_frac``
  (critical) — the OOM *precursor* the supervisor and the
  FallbackController can act on (e.g. nudging to a lower PowerSGD rank)
  before the allocator dies.
- ``fidelity_collapse``: one group's per-sample relative compression error
  (:class:`observe.events.FidelityEvent`) exceeds
  ``fidelity_factor`` × its own EWMA baseline (and the absolute
  ``fidelity_floor`` — a dead-zero exact group materializing error pages
  too); per-GROUP detectors so the alert blames the shape-group/bucket.
  Fires with a short sustain (``fidelity_sustain``) — deliberately long
  BEFORE the loss-plateau budget, because compression distortion leads
  loss damage by design (the EF chain absorbs it until it can't).
- ``ef_blowup``: one group's error-feedback memory norm exceeds
  ``ef_factor`` × its own EWMA baseline — the compressor is falling
  behind the gradient and the residual is compounding; critical beyond
  ``ef_critical_factor``. Both fidelity detectors freeze their baseline
  while firing (no self-silencing), like the spike/collapse family, and
  can ``nudge()`` the FallbackController back UP the ladder.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .events import AlertEvent


class Ewma:
    """Exponentially weighted mean + standard deviation, O(1) per update.

    ``alpha`` is the new-sample weight; 1/alpha is roughly the horizon in
    observations. ``std`` is derived from the EW second moment and is 0.0
    until two samples arrive.
    """

    def __init__(self, alpha: float):
        self.alpha = float(alpha)
        self.mean: Optional[float] = None
        self._sq: Optional[float] = None
        self.n = 0

    def update(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if self.mean is None:
            self.mean = x
            self._sq = x * x
            return
        a = self.alpha
        self.mean = (1.0 - a) * self.mean + a * x
        self._sq = (1.0 - a) * self._sq + a * x * x

    @property
    def std(self) -> float:
        if self.mean is None or self.n < 2:
            return 0.0
        var = max(0.0, self._sq - self.mean * self.mean)
        return math.sqrt(var)


@dataclass
class DetectorConfig:
    """Every detector threshold in one auditable record. Defaults are the
    JAX package's values; the aggregator and the supervisor construct their
    monitors from one shared instance so live behavior is reproducible
    from the config alone."""

    # grad-norm spike
    spike_alpha: float = 0.1
    spike_sigma: float = 6.0
    spike_factor: float = 3.0  # also require > factor x mean (warmup guard)
    nan_factor: float = 50.0  # beyond this x mean => critical (NaN precursor)
    spike_sustain: int = 1  # a single genuine spike must not be averaged away
    # loss plateau
    plateau_alpha: float = 0.05
    plateau_eps: float = 1e-3  # relative improvement per observation
    plateau_sustain: int = 20
    plateau_min_obs: int = 10
    # step-time drift
    drift_fast_alpha: float = 0.3
    drift_slow_alpha: float = 0.02
    drift_factor: float = 1.5
    drift_sustain: int = 5
    drift_min_obs: int = 10
    # bandwidth collapse
    collapse_alpha: float = 0.05
    collapse_frac: float = 0.4
    collapse_sustain: int = 3
    collapse_min_obs: int = 5
    # serving p99 burn rate
    slo_target_s: float = 2.0
    slo_sustain: int = 3
    # hbm headroom (occupancy fraction = bytes_in_use / bytes_limit)
    headroom_alpha: float = 0.3
    headroom_warn_frac: float = 0.85
    headroom_critical_frac: float = 0.95
    headroom_sustain: int = 2
    headroom_min_obs: int = 2
    # fidelity collapse (per-group relative compression error)
    fidelity_alpha: float = 0.1
    fidelity_factor: float = 3.0  # value > factor x own EWMA baseline
    fidelity_floor: float = 0.05  # absolute floor: zero-baseline groups too
    fidelity_critical: float = 0.5  # half the gradient mass lost => critical
    fidelity_sustain: int = 2  # pages LONG before loss_plateau's 10+20 budget
    fidelity_min_obs: int = 1
    # EF memory blow-up (per-group error-feedback norm)
    ef_alpha: float = 0.1
    ef_factor: float = 5.0
    ef_critical_factor: float = 25.0
    ef_sustain: int = 2
    ef_min_obs: int = 3
    # outer staleness (site-local steps / divergence budget during a
    # cross-site partition) — thresholdy, not statistical: the budget is
    # a hard contract, so the detector fires on fractions of it
    staleness_warn_frac: float = 0.5
    staleness_critical_frac: float = 0.9
    staleness_sustain: int = 1  # budget burn must page on the first obs
    # shared
    cooldown: int = 20  # observations of silence after a fired alert


class _Detector:
    """Shared sustain/cooldown machinery; subclasses implement
    ``_check(value) -> Optional[(severity, threshold, message)]``."""

    name = "detector"

    def __init__(self, sustain: int, cooldown: int):
        self._sustain = max(1, int(sustain))
        self._cooldown = max(0, int(cooldown))
        self._streak = 0
        self._quiet = 0
        self.fired = 0

    def observe(
        self, value: float, rank: Optional[int] = None, step: Optional[int] = None
    ) -> Optional[AlertEvent]:
        if self._quiet > 0:
            self._quiet -= 1
        verdict = self._check(value)
        if verdict is None:
            self._streak = 0
            return None
        self._streak += 1
        if self._streak < self._sustain or self._quiet > 0:
            return None
        severity, threshold, message = verdict
        self._streak = 0
        self._quiet = self._cooldown
        self.fired += 1
        return AlertEvent(
            alert=self.name,
            severity=severity,
            value=float(value) if math.isfinite(value) else float("inf"),
            threshold=float(threshold),
            message=message,
            rank=rank,
            step=step,
            source="detector",
        )

    def _check(self, value: float):
        raise NotImplementedError


class GradNormSpikeDetector(_Detector):
    name = "grad_spike"

    def __init__(self, cfg: DetectorConfig):
        super().__init__(cfg.spike_sustain, cfg.cooldown)
        self._cfg = cfg
        self._ewma = Ewma(cfg.spike_alpha)

    def _check(self, value: float):
        cfg = self._cfg
        if not math.isfinite(value):
            return ("critical", float("inf"), "non-finite grad norm")
        mean, std = self._ewma.mean, self._ewma.std
        verdict = None
        if mean is not None and self._ewma.n >= 3 and mean > 0.0:
            bound = mean + cfg.spike_sigma * std
            if value > max(bound, cfg.spike_factor * mean):
                if value > cfg.nan_factor * mean:
                    verdict = (
                        "critical",
                        cfg.nan_factor * mean,
                        f"grad norm {value:.3g} > {cfg.nan_factor:g}x EWMA "
                        f"{mean:.3g} (NaN precursor)",
                    )
                else:
                    verdict = (
                        "warn",
                        max(bound, cfg.spike_factor * mean),
                        f"grad norm {value:.3g} > EWMA {mean:.3g} "
                        f"+ {cfg.spike_sigma:g} sigma",
                    )
        # a spike must not poison the baseline it is judged against
        if verdict is None:
            self._ewma.update(value)
        return verdict


class LossPlateauDetector(_Detector):
    name = "loss_plateau"

    def __init__(self, cfg: DetectorConfig):
        super().__init__(cfg.plateau_sustain, cfg.cooldown)
        self._cfg = cfg
        self._improve = Ewma(cfg.plateau_alpha)
        self._last: Optional[float] = None

    def _check(self, value: float):
        cfg = self._cfg
        if not math.isfinite(value):
            self._last = None
            return None
        if self._last is not None:
            self._improve.update(self._last - value)
        self._last = value
        if self._improve.n < cfg.plateau_min_obs:
            return None
        scale = max(abs(value), 1e-12)
        rel = (self._improve.mean or 0.0) / scale
        if rel < cfg.plateau_eps:
            return (
                "warn",
                cfg.plateau_eps,
                f"relative loss improvement {rel:.2e}/obs < {cfg.plateau_eps:g}",
            )
        return None


class StepTimeDriftDetector(_Detector):
    name = "step_time_drift"

    def __init__(self, cfg: DetectorConfig):
        super().__init__(cfg.drift_sustain, cfg.cooldown)
        self._cfg = cfg
        self._fast = Ewma(cfg.drift_fast_alpha)
        self._slow = Ewma(cfg.drift_slow_alpha)

    def _check(self, value: float):
        cfg = self._cfg
        if not math.isfinite(value) or value <= 0.0:
            return None
        self._fast.update(value)
        slow = self._slow.mean
        verdict = None
        if (
            self._slow.n >= cfg.drift_min_obs
            and slow
            and self._fast.mean > cfg.drift_factor * slow
        ):
            verdict = (
                "warn",
                cfg.drift_factor * slow,
                f"step time {self._fast.mean * 1e3:.1f} ms > "
                f"{cfg.drift_factor:g}x baseline {slow * 1e3:.1f} ms",
            )
        else:
            # freeze the baseline while drifted, or recovery re-learns the
            # degraded speed as "normal" and the alert self-silences
            self._slow.update(value)
        return verdict


class BandwidthCollapseDetector(_Detector):
    name = "bandwidth_collapse"

    def __init__(self, cfg: DetectorConfig):
        super().__init__(cfg.collapse_sustain, cfg.cooldown)
        self._cfg = cfg
        self._ewma = Ewma(cfg.collapse_alpha)

    def _check(self, value: float):
        cfg = self._cfg
        if not math.isfinite(value) or value < 0.0:
            return None
        base = self._ewma.mean
        verdict = None
        if (
            self._ewma.n >= cfg.collapse_min_obs
            and base
            and value < cfg.collapse_frac * base
        ):
            verdict = (
                "warn",
                cfg.collapse_frac * base,
                f"bytes/s {value:.3g} < {cfg.collapse_frac:g}x baseline "
                f"{base:.3g}",
            )
        else:
            self._ewma.update(value)
        return verdict


class SloBurnRateDetector(_Detector):
    name = "slo_burn"

    def __init__(self, cfg: DetectorConfig):
        super().__init__(cfg.slo_sustain, cfg.cooldown)
        self._cfg = cfg

    def _check(self, value: float):
        cfg = self._cfg
        if not math.isfinite(value):
            return None
        if value > cfg.slo_target_s:
            return (
                "warn",
                cfg.slo_target_s,
                f"serving p99 {value * 1e3:.0f} ms > SLO "
                f"{cfg.slo_target_s * 1e3:.0f} ms",
            )
        return None


class HbmHeadroomDetector(_Detector):
    """OOM precursor: the EWMA of the occupancy FRACTION (bytes_in_use /
    bytes_limit) approaching 1.0. Smoothed so one transient allocator
    high-water sample does not page, but with a short horizon
    (``headroom_alpha``) — memory exhaustion is fast and the alert must
    lead the OOM, not eulogize it."""

    name = "hbm_headroom"

    def __init__(self, cfg: DetectorConfig):
        super().__init__(cfg.headroom_sustain, cfg.cooldown)
        self._cfg = cfg
        self._ewma = Ewma(cfg.headroom_alpha)

    def _check(self, value: float):
        cfg = self._cfg
        if not math.isfinite(value) or value < 0.0:
            return None
        self._ewma.update(value)
        if self._ewma.n < cfg.headroom_min_obs:
            return None
        frac = self._ewma.mean or 0.0
        if frac >= cfg.headroom_critical_frac:
            return (
                "critical",
                cfg.headroom_critical_frac,
                f"HBM {100 * frac:.1f}% of limit in use "
                f"(>= {100 * cfg.headroom_critical_frac:g}% — OOM imminent)",
            )
        if frac >= cfg.headroom_warn_frac:
            return (
                "warn",
                cfg.headroom_warn_frac,
                f"HBM {100 * frac:.1f}% of limit in use "
                f"(>= {100 * cfg.headroom_warn_frac:g}% headroom floor)",
            )
        return None


class FidelityCollapseDetector(_Detector):
    """Per-group compression-fidelity watch: the sampled relative error
    (``FidelityEvent.rel_error``) leaving its own learned envelope. The
    effective threshold is ``max(fidelity_factor × EWMA, fidelity_floor)``
    — the floor catches exact (zero-baseline) groups suddenly
    materializing error, where any multiplicative bound is vacuous.
    Severity escalates to critical past the absolute ``fidelity_critical``
    (the compressor is discarding a macroscopic share of the gradient).
    Fires on a ``fidelity_sustain``-sample streak — an order of magnitude
    earlier than the loss-plateau budget, by design: distortion leads loss
    damage while the EF chain still absorbs it."""

    name = "fidelity_collapse"

    def __init__(self, cfg: DetectorConfig):
        super().__init__(cfg.fidelity_sustain, cfg.cooldown)
        self._cfg = cfg
        self._ewma = Ewma(cfg.fidelity_alpha)

    def _check(self, value: float):
        cfg = self._cfg
        if not math.isfinite(value) or value < 0.0:
            return ("critical", float("inf"), "non-finite compression error")
        base = self._ewma.mean
        bound = cfg.fidelity_floor
        if base is not None and self._ewma.n >= cfg.fidelity_min_obs:
            bound = max(bound, cfg.fidelity_factor * base)
        verdict = None
        if value > bound:
            if value >= cfg.fidelity_critical:
                verdict = (
                    "critical",
                    cfg.fidelity_critical,
                    f"rel compression error {value:.3g} >= "
                    f"{cfg.fidelity_critical:g} absolute (gradient mass "
                    f"being discarded)",
                )
            else:
                verdict = (
                    "warn",
                    bound,
                    f"rel compression error {value:.3g} > envelope "
                    f"{bound:.3g} (baseline {base if base is not None else 0.0:.3g})",
                )
        # the collapsed samples must not poison the healthy baseline
        if verdict is None:
            self._ewma.update(value)
        return verdict


class EfBlowupDetector(_Detector):
    """Per-group error-feedback blow-up watch: the EF memory norm
    (``FidelityEvent.ef_norm``) running away from its own EWMA baseline —
    the compressor is persistently dropping more than the next step
    recovers, so the residual compounds instead of telescoping. Purely
    multiplicative (EF norms are scale-full quantities); a dead-zero
    baseline (exact groups) never fires."""

    name = "ef_blowup"

    def __init__(self, cfg: DetectorConfig):
        super().__init__(cfg.ef_sustain, cfg.cooldown)
        self._cfg = cfg
        self._ewma = Ewma(cfg.ef_alpha)

    def _check(self, value: float):
        cfg = self._cfg
        if not math.isfinite(value) or value < 0.0:
            return ("critical", float("inf"), "non-finite EF memory norm")
        base = self._ewma.mean
        verdict = None
        if (
            base is not None
            and base > 1e-12
            and self._ewma.n >= cfg.ef_min_obs
            and value > cfg.ef_factor * base
        ):
            if value > cfg.ef_critical_factor * base:
                verdict = (
                    "critical",
                    cfg.ef_critical_factor * base,
                    f"EF norm {value:.3g} > {cfg.ef_critical_factor:g}x "
                    f"baseline {base:.3g} (residual compounding)",
                )
            else:
                verdict = (
                    "warn",
                    cfg.ef_factor * base,
                    f"EF norm {value:.3g} > {cfg.ef_factor:g}x baseline "
                    f"{base:.3g}",
                )
        if verdict is None:
            self._ewma.update(value)
        return verdict


class OuterStalenessDetector(_Detector):
    """Divergence-budget burn during a cross-site partition: the value is
    the staleness FRACTION (site-local steps / ``--max-local-steps``).
    Unlike the statistical detectors there is no baseline to learn — the
    budget is the contract :class:`resilience.guards.PartitionPolicy`
    escalates on, so the detector pages at fixed fractions of it: warn at
    ``staleness_warn_frac`` (partition persisting), critical at
    ``staleness_critical_frac`` (escalation imminent)."""

    name = "outer_staleness"

    def __init__(self, cfg: DetectorConfig):
        super().__init__(cfg.staleness_sustain, cfg.cooldown)
        self._cfg = cfg

    def _check(self, value: float):
        cfg = self._cfg
        if not math.isfinite(value) or value < 0.0:
            return None
        if value >= cfg.staleness_critical_frac:
            return (
                "critical",
                cfg.staleness_critical_frac,
                f"outer staleness {100 * value:.0f}% of divergence budget"
                f" (>= {100 * cfg.staleness_critical_frac:g}% —"
                " escalation imminent)",
            )
        if value >= cfg.staleness_warn_frac:
            return (
                "warn",
                cfg.staleness_warn_frac,
                f"outer staleness {100 * value:.0f}% of divergence budget"
                f" (partition persisting)",
            )
        return None


class HealthMonitor:
    """The detector bank, keyed by signal. The aggregator routes each
    derived signal to :meth:`observe_*` as events stream in; every call
    returns the alerts that fired (usually none). Per-rank signals get
    per-rank detector instances so one slow rank cannot hide inside a
    cross-rank mean."""

    def __init__(self, config: Optional[DetectorConfig] = None):
        self.config = config or DetectorConfig()
        self._grad: Dict[Optional[int], GradNormSpikeDetector] = {}
        self._loss = LossPlateauDetector(self.config)
        self._drift: Dict[Optional[int], StepTimeDriftDetector] = {}
        # keyed per mesh edge ((src, dst) rank pair); the None key is the
        # run-aggregate signal, so the historical single-detector behavior
        # is the edge=None special case
        self._bandwidth: Dict[
            Optional[Tuple[int, int]], BandwidthCollapseDetector
        ] = {}
        self._slo = SloBurnRateDetector(self.config)
        self._hbm: Dict[Optional[int], HbmHeadroomDetector] = {}
        self._staleness: Dict[Optional[int], OuterStalenessDetector] = {}
        # keyed per fidelity GROUP (shape-group/bucket), not per rank —
        # the probe all-reduce-means the sample, so ranks agree and the
        # interesting attribution axis is which layer group degraded
        self._fidelity: Dict[str, FidelityCollapseDetector] = {}
        self._ef: Dict[str, EfBlowupDetector] = {}
        self.alerts: List[AlertEvent] = []

    def _keep(self, alert: Optional[AlertEvent]) -> List[AlertEvent]:
        if alert is None:
            return []
        self.alerts.append(alert)
        return [alert]

    def observe_grad_norm(
        self, value: float, rank: Optional[int] = None, step: Optional[int] = None
    ) -> List[AlertEvent]:
        det = self._grad.setdefault(rank, GradNormSpikeDetector(self.config))
        return self._keep(det.observe(value, rank=rank, step=step))

    def observe_loss(
        self, value: float, step: Optional[int] = None
    ) -> List[AlertEvent]:
        return self._keep(self._loss.observe(value, step=step))

    def observe_step_time(
        self, value: float, rank: Optional[int] = None, step: Optional[int] = None
    ) -> List[AlertEvent]:
        det = self._drift.setdefault(rank, StepTimeDriftDetector(self.config))
        return self._keep(det.observe(value, rank=rank, step=step))

    def observe_bytes_per_s(
        self, value: float, edge: Optional[Tuple[int, int]] = None
    ) -> List[AlertEvent]:
        """``edge=None`` is the run-aggregate achieved rate; an (src, dst)
        rank pair tracks ONE mesh link's effective rate with its own
        baseline, so a collapse alert names the edge (and blames the src
        rank) instead of the whole run."""
        det = self._bandwidth.setdefault(
            edge, BandwidthCollapseDetector(self.config)
        )
        alert = det.observe(value, rank=edge[0] if edge else None)
        if alert is not None and edge is not None:
            alert.message = f"edge {edge[0]}->{edge[1]}: {alert.message}"
        return self._keep(alert)

    def observe_serving_p99(self, value: float) -> List[AlertEvent]:
        return self._keep(self._slo.observe(value))

    def observe_hbm(
        self,
        bytes_in_use: float,
        bytes_limit: float,
        rank: Optional[int] = None,
        step: Optional[int] = None,
    ) -> List[AlertEvent]:
        """Per-rank OOM-precursor watch on the occupancy fraction. A
        sample without a positive limit (CPU backends report none) is
        dropped silently — the detector never learns a fake baseline."""
        if (
            not isinstance(bytes_limit, (int, float))
            or not math.isfinite(float(bytes_limit))
            or float(bytes_limit) <= 0.0
        ):
            return []
        det = self._hbm.setdefault(rank, HbmHeadroomDetector(self.config))
        return self._keep(
            det.observe(
                float(bytes_in_use) / float(bytes_limit), rank=rank, step=step
            )
        )

    def observe_outer_staleness(
        self,
        local_steps: float,
        max_local_steps: float,
        rank: Optional[int] = None,
        step: Optional[int] = None,
    ) -> List[AlertEvent]:
        """Budget-burn watch on a partition's site-local stretch. A
        sample without a positive budget is dropped silently — no budget
        means no escalation contract to page against."""
        if (
            not isinstance(max_local_steps, (int, float))
            or not math.isfinite(float(max_local_steps))
            or float(max_local_steps) <= 0.0
        ):
            return []
        det = self._staleness.setdefault(
            rank, OuterStalenessDetector(self.config)
        )
        return self._keep(
            det.observe(
                float(local_steps) / float(max_local_steps),
                rank=rank, step=step,
            )
        )

    def observe_fidelity(
        self,
        group: str,
        rel_error: float,
        rank: Optional[int] = None,
        step: Optional[int] = None,
    ) -> List[AlertEvent]:
        """Per-group compression-error watch; the alert message leads with
        the group key so blame lands on the shape-group/bucket, mirroring
        the per-edge bandwidth attribution."""
        det = self._fidelity.setdefault(
            group, FidelityCollapseDetector(self.config)
        )
        alert = det.observe(rel_error, rank=rank, step=step)
        if alert is not None:
            alert.message = f"group {group}: {alert.message}"
        return self._keep(alert)

    def observe_ef_norm(
        self,
        group: str,
        ef_norm: float,
        rank: Optional[int] = None,
        step: Optional[int] = None,
    ) -> List[AlertEvent]:
        """Per-group EF blow-up watch; same group-first blame convention."""
        det = self._ef.setdefault(group, EfBlowupDetector(self.config))
        alert = det.observe(ef_norm, rank=rank, step=step)
        if alert is not None:
            alert.message = f"group {group}: {alert.message}"
        return self._keep(alert)

    def fired_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for a in self.alerts:
            out[a.alert] = out.get(a.alert, 0) + 1
        return out
