"""Perf regression gate: compare a port run report against a recorded baseline.

Stdlib-only (no torch, no jax). Reads the machine-readable report that
``scripts/torch_report.py --run-dir`` writes to
``artifacts/run_report.json``, resolves a baseline, and exits nonzero when
any comparable metric regresses beyond the tolerance (``--advisory``
reports the regressions and exits 0). Its metrics, verdicts, JSON stdout
line and exit codes are the JAX package's ``scripts/gate.py``'s.

Baseline resolution order:

1. ``--baseline PATH`` — an explicit report/baseline JSON.
2. ``artifacts/GATE_BASELINE.json`` — a recorded baseline.

Otherwise the gate is skipped (``{"gate": "skipped", "reason":
"no_baseline"}``, exit 0). The one departure from the JAX package's gate:
it does not fall back to the newest ``BENCH_r*.json`` at the root, since
those files record TPU rounds, and a port report gated against one would
compare the card's numbers with a TPU's.

Metrics compared (only those present in BOTH report and baseline):

- ``step_p50_s``            lower is better
- ``achieved_bytes_per_s``  higher is better (from ``bandwidth.total``)
- ``flagship_imgs_per_sec`` higher is better (bench baselines)
- ``value``                 higher is better (bench value-tier score)
- ``mfu``                   higher is better (report ``mfu_headline`` /
  bench flagship ``mfu``)
- ``p99_decode_ms_per_token`` lower is better (report ``slo`` section —
  the serving engine's tail decode latency per generated token)
- ``loader_samples_per_s``    higher is better (bench loader phase —
  host-side batch assembly rate, isolated from compute)
- ``data_load_share``        lower is better (fraction of the step loop
  blocked on data; also gated against the ABSOLUTE
  ``data_load_share_target`` ceiling a baseline may record)
- ``costmodel_error``        lower is better (the what-if planner's
  relative predicted-vs-realized step-time error on an executed config,
  from ``torch_report.py --plan``; also gated against the ABSOLUTE
  ``costmodel_error_target`` ceiling, default 25 % — the calibration
  bound stated for cost-model predictions)
- ``critpath_comm_share``    lower is better (report ``critpath`` section —
  share of the cross-rank critical path spent blocked in collective-wait,
  from the observe.critpath analyzer)
- ``fleet_goodput``          higher is better (report ``fleet`` section —
  the gang scheduler's deadline-weighted completed work per chip-second
  over a multi-job game day, from ``resilience.scheduler``)
- ``hbm_peak_bytes``         lower is better (report ``memory`` section —
  the memory observatory's peak device-memory scalar: the live sampler's
  measured peak when ``memory_stats`` exists, the compile-time predicted
  peak otherwise; a fatter footprint is a regression even when throughput
  holds)
- ``serving_tokens_per_s_per_chip`` higher is better (bench serving
  phase — the paged engine's generated-token throughput per chip)
- ``kv_capacity_ratio``      higher is better (bench serving phase —
  peak concurrently-admitted requests, paged over dense, at equal KV
  HBM; also gated against the ABSOLUTE ``kv_capacity_ratio_target``
  floor, default 2x)
- ``fidelity_rel_error``     lower is better (report ``fidelity``
  section — the worst shape-group's MEAN relative compression error
  from the gradient-fidelity audit, ``observe.fidelity``; exact
  reducers report an identically-zero value, so 0 records like
  alerts_fired and any drift upward is a fidelity regression)

A metric the current report carries but a stale baseline does not gets a
clearly-labeled ``missing_baseline`` ADVISORY verdict (never a
regression): adding a gate metric must never brick CI on an older
``GATE_BASELINE.json``.

Device provenance: a report produced on ``cpu`` must not silently satisfy
a baseline recorded on a real chip (every relative comparison would be
noise). When both sides carry a platform (bench attestation ``platform``,
or a report's compile-time ``device_kind``) and they differ, the gate
emits a loud ``device_mismatch`` verdict — advisory by default so local
CPU probes keep passing, a real regression under ``--strict-device``.

Span time shares (report ``spans.by_name[*].share``) are compared
separately when both sides carry them: a span name whose share of run
wall-clock grew by more than ``--span-tolerance`` (absolute, default
0.10) is a regression — e.g. checkpointing creeping from 5% to 20% of the
run fails the gate even when throughput metrics still pass.

MFU additionally gates against an ABSOLUTE floor when the baseline (or
report) carries ``mfu_target``. The relative comparison
alone lets a slow regression ratchet: each round can lose just under the
tolerance against the previous round's baseline, compounding unbounded.
The floor verdict (``metric: "mfu_vs_target"``) has no tolerance — the
current MFU is simply below the published tier target or it is not.

Usage::

    python3 scripts/torch_gate.py --report artifacts/run_report.json \
        [--baseline F] [--tolerance 0.2] [--span-tolerance 0.1] [--advisory] [--strict-device]
"""

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

# metric name -> direction ("lower" / "higher" is better)
METRICS: Dict[str, str] = {
    "step_p50_s": "lower",
    "achieved_bytes_per_s": "higher",
    "flagship_imgs_per_sec": "higher",
    "value": "higher",
    "mfu": "higher",
    # wall seconds from the first injected comm fault to the first clean
    # step (scripts/torch_report.py recovery_latency_s) — slower healing is a
    # resilience regression
    "recovery_latency_s": "lower",
    # disaster-recovery MTTR (report ``recovery_time_s``): mean wall
    # seconds from a hard correlated death to the first step on the
    # replanned mesh — a slower game-day recovery is a regression
    "recovery_time_s": "lower",
    # serving tail latency (report ``slo.p99_decode_ms_per_token``, from
    # the serving/ engine's per-request events) — a slower p99 decode
    # tick is an SLO regression even when training metrics hold
    "p99_decode_ms_per_token": "lower",
    # live-plane detector verdicts (report ``alerts.fired``) — a healthy
    # run fires zero, so unlike every other metric the comparable value
    # may legitimately be 0 (extract_metrics accepts it); more alerts than
    # the recorded baseline means the run's health envelope got worse
    "alerts_fired": "lower",
    # loader-isolation assembly rate (a benchmark's ``loader`` phase) — the
    # data plane's own throughput, gated so a loader regression can't
    # hide behind a compute-bound flagship number
    "loader_samples_per_s": "higher",
    # fraction of the overlapped step loop blocked on data (bench's
    # synthetic loop, or the run report's ``data_load`` span share) — a
    # growing share means the loader stopped hiding under the step.
    # Zero is the healthy value, so 0 records like alerts_fired, and an
    # ABSOLUTE ceiling (``data_load_share_target``) backstops the
    # relative comparison exactly as mfu_target does for MFU
    "data_load_share": "lower",
    # the cost model's own calibration error (report ``costmodel.error``:
    # relative predicted-vs-realized step time on an executed config,
    # scripts/torch_plan.py + torch_report.py --plan) — the what-if planner is only
    # trustworthy while this stays small, so the MODEL is regression-gated
    # like any other metric. Zero is the healthy value (0 records), and
    # the ABSOLUTE ceiling ``costmodel_error_target`` (default
    # DEFAULT_COSTMODEL_ERROR_TARGET) backstops the relative comparison
    "costmodel_error": "lower",
    # share of the cross-rank critical path spent in collective-wait
    # (report ``critpath.comm_share``, observe.critpath) — the fraction of
    # every step's gating chain blocked on the fabric. Zero is the healthy
    # value (fully compute-bound run), so 0 records like alerts_fired; a
    # growing share means stragglers/slow edges started gating steps
    "critpath_comm_share": "lower",
    # peak device memory (report ``memory.hbm_peak_bytes``: measured
    # allocator peak when the live sampler ran, compile-time predicted
    # peak otherwise) — a model/config change that fattens the footprint
    # is a regression even while throughput metrics hold (the OOM you
    # haven't hit yet)
    "hbm_peak_bytes": "lower",
    # fleet control-plane goodput (report ``fleet.goodput``, from the
    # resilience.scheduler game day): deadline-weighted completed work per
    # chip-second across every job the scheduler ran — fewer completions,
    # more missed deadlines, or more chip-seconds burned by quarantined
    # crash-loopers all push it down
    "fleet_goodput": "higher",
    # paged-serving arm (a benchmark's serving phase): generated-token
    # throughput of the block-pool engine, and its concurrency win over
    # the dense slot cache at equal KV HBM (also held to an absolute
    # >= 2x floor via kv_capacity_ratio_target)
    "serving_tokens_per_s_per_chip": "higher",
    "kv_capacity_ratio": "higher",
    # gradient-fidelity audit (report ``fidelity.rel_error``,
    # observe.fidelity): the worst shape-group's mean relative
    # compression error over the run's health-probe samples. Zero IS the
    # healthy value (exact reducers), so 0 records like alerts_fired; a
    # rung/config change that quietly degrades what the compressed wire
    # delivers regresses here even while throughput metrics hold
    "fidelity_rel_error": "lower",
}

# the calibration bound DESIGN.md states for cost-model predictions: a
# prediction whose realized counterpart disagrees by more than this is a
# gate regression even with no recorded baseline to ratchet against
DEFAULT_COSTMODEL_ERROR_TARGET = 0.25

# the concurrency floor DESIGN.md states for the paged KV cache: at equal
# KV HBM the block pool must admit at least twice the concurrent requests
# a dense slot cache holds
DEFAULT_KV_CAPACITY_RATIO_TARGET = 2.0

BASELINE_NAME = "GATE_BASELINE.json"


def _say(msg: str) -> None:
    sys.stderr.write(f"# gate: {msg}\n")


def extract_metrics(doc: Dict) -> Dict[str, float]:
    """Pull the comparable scalar metrics out of a report/baseline dict."""
    out: Dict[str, float] = {}
    for name in (
        "step_p50_s", "flagship_imgs_per_sec", "value", "recovery_latency_s",
        "recovery_time_s",
    ):
        v = doc.get(name)
        if isinstance(v, (int, float)) and v == v and v > 0:
            out[name] = float(v)
    bw = doc.get("bandwidth")
    if isinstance(bw, dict):
        total = bw.get("total", {})
        v = total.get("achieved_bytes_per_s")
        if isinstance(v, (int, float)) and v == v and v > 0:
            out["achieved_bytes_per_s"] = float(v)
    # bench baselines store the achieved rate flat as well
    v = doc.get("achieved_bytes_per_s")
    if isinstance(v, (int, float)) and v == v and v > 0:
        out.setdefault("achieved_bytes_per_s", float(v))
    # MFU: the run report's headline scalar, or bench's flagship "mfu"
    for key in ("mfu_headline", "mfu"):
        v = doc.get(key)
        if isinstance(v, (int, float)) and v == v and v > 0:
            out.setdefault("mfu", float(v))
    # serving SLO scalar: nested under the report's "slo" section, flat in
    # hand-recorded baselines
    slo = doc.get("slo")
    if isinstance(slo, dict):
        v = slo.get("p99_decode_ms_per_token")
        if isinstance(v, (int, float)) and v == v and v > 0:
            out["p99_decode_ms_per_token"] = float(v)
    v = doc.get("p99_decode_ms_per_token")
    if isinstance(v, (int, float)) and v == v and v > 0:
        out.setdefault("p99_decode_ms_per_token", float(v))
    # live-plane alerts: nested under the report's "alerts" section, flat
    # in bench baselines. Zero IS the healthy value, so (alone among the
    # metrics) v == 0 still records
    alerts = doc.get("alerts")
    if isinstance(alerts, dict):
        v = alerts.get("fired")
        if isinstance(v, (int, float)) and v == v and v >= 0:
            out["alerts_fired"] = float(v)
    v = doc.get("alerts_fired")
    if isinstance(v, (int, float)) and v == v and v >= 0:
        out.setdefault("alerts_fired", float(v))
    # loader metrics: flat in bench baselines; a run report instead carries
    # the data_load share nested in its spans section (zero is healthy and
    # records, like alerts_fired)
    v = doc.get("loader_samples_per_s")
    if isinstance(v, (int, float)) and v == v and v > 0:
        out["loader_samples_per_s"] = float(v)
    v = doc.get("data_load_share")
    if isinstance(v, (int, float)) and v == v and v >= 0:
        out["data_load_share"] = float(v)
    spans = doc.get("spans")
    if isinstance(spans, dict):
        slot = (spans.get("by_name") or {}).get("data_load")
        share = slot.get("share") if isinstance(slot, dict) else None
        if isinstance(share, (int, float)) and share == share and share >= 0:
            out.setdefault("data_load_share", float(share))
    # cost-model calibration error: nested under the report's "costmodel"
    # section (torch_report.py --plan), flat in bench baselines. Zero (a perfect
    # prediction) is the healthy value, so >= 0 records
    cm = doc.get("costmodel")
    if isinstance(cm, dict):
        v = cm.get("error")
        if isinstance(v, (int, float)) and v == v and v >= 0:
            out["costmodel_error"] = float(v)
    v = doc.get("costmodel_error")
    if isinstance(v, (int, float)) and v == v and v >= 0:
        out.setdefault("costmodel_error", float(v))
    # critical-path comm share: nested under the report's "critpath"
    # section (observe.critpath via torch_report.py --run-dir), flat in bench
    # baselines. Zero (compute-bound path) is healthy, so >= 0 records
    cp = doc.get("critpath")
    if isinstance(cp, dict):
        v = cp.get("comm_share")
        if isinstance(v, (int, float)) and v == v and v >= 0:
            out["critpath_comm_share"] = float(v)
    v = doc.get("critpath_comm_share")
    if isinstance(v, (int, float)) and v == v and v >= 0:
        out.setdefault("critpath_comm_share", float(v))
    # peak device memory: nested under the report's "memory" section
    # (measured peak when the sampler ran, predicted peak otherwise —
    # memory_summary picks), flat in bench baselines
    mem = doc.get("memory")
    if isinstance(mem, dict):
        v = mem.get("hbm_peak_bytes")
        if isinstance(v, (int, float)) and v == v and v > 0:
            out["hbm_peak_bytes"] = float(v)
    v = doc.get("hbm_peak_bytes")
    if isinstance(v, (int, float)) and v == v and v > 0:
        out.setdefault("hbm_peak_bytes", float(v))
    # fleet goodput: nested under the report's "fleet" section
    # (scripts/torch_report.py fleet_summary_from_events), flat in bench
    # baselines
    fleet = doc.get("fleet")
    if isinstance(fleet, dict):
        v = fleet.get("goodput")
        if isinstance(v, (int, float)) and v == v and v > 0:
            out["fleet_goodput"] = float(v)
    v = doc.get("fleet_goodput")
    if isinstance(v, (int, float)) and v == v and v > 0:
        out.setdefault("fleet_goodput", float(v))
    # paged-serving metrics: flat in bench baselines; a run report may
    # carry them nested under a "serving" section (torch_report.py's serving
    # memory table rides elsewhere — these are the gateable scalars)
    serving = doc.get("serving")
    for src in (serving if isinstance(serving, dict) else {}, doc):
        for key in ("serving_tokens_per_s_per_chip", "kv_capacity_ratio"):
            v = src.get(key)
            if isinstance(v, (int, float)) and v == v and v > 0:
                out.setdefault(key, float(v))
    # gradient-fidelity scalar: nested under the report's "fidelity"
    # section (scripts/torch_report.py via observe.fidelity.fidelity_summary),
    # flat in bench baselines. Zero (exact reducers) is the healthy
    # value, so >= 0 records like alerts_fired
    fid = doc.get("fidelity")
    if isinstance(fid, dict):
        v = fid.get("rel_error")
        if isinstance(v, (int, float)) and v == v and v >= 0:
            out["fidelity_rel_error"] = float(v)
    v = doc.get("fidelity_rel_error")
    if isinstance(v, (int, float)) and v == v and v >= 0:
        out.setdefault("fidelity_rel_error", float(v))
    return out


def extract_span_shares(doc: Dict) -> Dict[str, float]:
    """Per-span-name wall-clock shares from a report's ``spans`` section
    (absent from bench baselines — span shares only gate report-vs-report)."""
    spans = doc.get("spans")
    if not isinstance(spans, dict):
        return {}
    out: Dict[str, float] = {}
    for name, slot in (spans.get("by_name") or {}).items():
        share = slot.get("share") if isinstance(slot, dict) else None
        if isinstance(share, (int, float)) and share == share and share >= 0:
            out[str(name)] = float(share)
    return out


def _load_json(path: str) -> Optional[Dict]:
    try:
        with open(path) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def resolve_baseline(
    explicit: Optional[str], root: str
) -> Optional[Tuple[str, Dict]]:
    """``(path, document)`` of the baseline: ``explicit``, else
    ``artifacts/GATE_BASELINE.json`` under ``root``; None when neither
    reads. No ``BENCH_r*.json`` fallback (the module's docstring says
    why)."""
    if explicit:
        doc = _load_json(explicit)
        return (explicit, doc) if doc is not None else None
    recorded = os.path.join(root, "artifacts", BASELINE_NAME)
    doc = _load_json(recorded)
    if doc is not None:
        return recorded, doc
    return None


def compare(
    current: Dict[str, float], baseline: Dict[str, float], tolerance: float
) -> List[Dict]:
    """Per-metric verdicts. Metrics present on both sides get the real
    relative comparison; a metric the CURRENT report carries but the
    (older, stale) baseline does not gets a clearly-labeled
    ``missing_baseline`` advisory verdict — never a regression, never a
    KeyError — so adding a gate metric can never brick CI until a fresh
    baseline records it. Metrics only the baseline carries are skipped
    silently (this run simply didn't measure them)."""
    verdicts: List[Dict] = []
    for name, direction in METRICS.items():
        if name not in current:
            continue
        if name not in baseline:
            verdicts.append(
                {
                    "metric": name,
                    "direction": direction,
                    "current": current[name],
                    "baseline": None,
                    "limit": None,
                    "ratio": None,
                    "regressed": False,
                    "missing_baseline": True,
                }
            )
            continue
        cur, base = current[name], baseline[name]
        if direction == "lower":
            limit = base * (1.0 + tolerance)
            regressed = cur > limit
            ratio = cur / base if base else float("inf")
        else:
            limit = base * (1.0 - tolerance)
            regressed = cur < limit
            ratio = cur / base if base else 0.0
        verdicts.append(
            {
                "metric": name,
                "direction": direction,
                "current": cur,
                "baseline": base,
                "limit": limit,
                "ratio": ratio,
                "regressed": regressed,
            }
        )
    return verdicts


def mfu_target_verdict(
    current: Dict[str, float], report: Dict, baseline_doc: Dict
) -> List[Dict]:
    """Absolute-floor verdict for MFU against the published per-tier
    target (``mfu_target``, recorded into GATE_BASELINE.json). No
    tolerance: the target IS the limit. Emitted only when a current MFU and a target are both available; the
    baseline's target wins over the report's own (the recorded baseline is
    the tier the gate compares against)."""
    mfu = current.get("mfu")
    target = None
    for doc in (baseline_doc, report):
        v = doc.get("mfu_target")
        if isinstance(v, (int, float)) and v == v and v > 0:
            target = float(v)
            break
    if mfu is None or target is None:
        return []
    return [
        {
            "metric": "mfu_vs_target",
            "direction": "higher",
            "current": mfu,
            "baseline": target,
            "limit": target,
            "ratio": mfu / target,
            "regressed": mfu < target,
        }
    ]


def data_load_share_verdict(
    current: Dict[str, float], report: Dict, baseline_doc: Dict
) -> List[Dict]:
    """Absolute-ceiling verdict for the data-plane share against the
    published target (``data_load_share_target``, recorded in the
    baseline). Same shape and
    rationale as :func:`mfu_target_verdict`: the relative comparison alone
    lets the loader's share ratchet up one tolerance per round."""
    share = current.get("data_load_share")
    target = None
    for doc in (baseline_doc, report):
        v = doc.get("data_load_share_target")
        if isinstance(v, (int, float)) and v == v and v > 0:
            target = float(v)
            break
    if share is None or target is None:
        return []
    return [
        {
            "metric": "data_load_share_vs_target",
            "direction": "lower",
            "current": share,
            "baseline": target,
            "limit": target,
            "ratio": share / target,
            "regressed": share > target,
        }
    ]


def costmodel_target_verdict(
    current: Dict[str, float], report: Dict, baseline_doc: Dict
) -> List[Dict]:
    """Absolute-ceiling verdict for the cost model's calibration error,
    mirroring :func:`mfu_target_verdict`. Unlike MFU's, the target has a
    default (``DEFAULT_COSTMODEL_ERROR_TARGET``): the <= 25 % bound is part
    of the model's stated guarantee class (DESIGN.md), not a per-tier
    published number — so a wildly wrong prediction fails the gate even
    before any baseline has recorded the metric."""
    err = current.get("costmodel_error")
    if err is None:
        return []
    target = DEFAULT_COSTMODEL_ERROR_TARGET
    for doc in (baseline_doc, report):
        v = doc.get("costmodel_error_target")
        if isinstance(v, (int, float)) and v == v and v > 0:
            target = float(v)
            break
    return [
        {
            "metric": "costmodel_error_vs_target",
            "direction": "lower",
            "current": err,
            "baseline": target,
            "limit": target,
            "ratio": err / target if target else float("inf"),
            "regressed": err > target,
        }
    ]


def kv_capacity_target_verdict(
    current: Dict[str, float], report: Dict, baseline_doc: Dict
) -> List[Dict]:
    """Absolute-floor verdict for the paged KV cache's concurrency win at
    equal HBM, mirroring :func:`mfu_target_verdict`. Like the cost model's
    bound, the target has a default (``DEFAULT_KV_CAPACITY_RATIO_TARGET``):
    the >= 2x admission win over a dense slot cache is the paged engine's
    stated guarantee class (DESIGN.md), so a pool that stops out-admitting
    dense fails the gate even before a baseline records the ratio."""
    ratio = current.get("kv_capacity_ratio")
    if ratio is None:
        return []
    target = DEFAULT_KV_CAPACITY_RATIO_TARGET
    for doc in (baseline_doc, report):
        v = doc.get("kv_capacity_ratio_target")
        if isinstance(v, (int, float)) and v == v and v > 0:
            target = float(v)
            break
    return [
        {
            "metric": "kv_capacity_ratio_vs_target",
            "direction": "higher",
            "current": ratio,
            "baseline": target,
            "limit": target,
            "ratio": ratio / target if target else 0.0,
            "regressed": ratio < target,
        }
    ]


def _platform_of(doc: Dict) -> Optional[str]:
    """Best-effort device provenance of a report/baseline: the bench
    attestation ``platform`` (or a hand-recorded ``device``) wins; a run
    report falls back to the compile-time ``device_kind`` its MFU records
    carry. None when nothing attests — provenance is then unknowable and
    the mismatch check stays silent."""
    for key in ("platform", "device"):
        v = doc.get(key)
        if isinstance(v, str) and v.strip():
            return v.strip().lower()
    mfu = doc.get("mfu")
    if isinstance(mfu, list):
        for m in mfu:
            dk = m.get("device_kind") if isinstance(m, dict) else None
            if isinstance(dk, str) and dk.strip():
                return dk.strip().lower()
    return None


def device_mismatch_verdict(
    report: Dict, baseline_doc: Dict, strict: bool
) -> List[Dict]:
    """The provenance guard: a ``cpu`` report quietly 'passing' a chip
    baseline is the gate lying to CI — every relative comparison crosses
    hardware. Loud advisory verdict when the attested platforms differ;
    ``--strict-device`` promotes it to a real regression."""
    rp, bp = _platform_of(report), _platform_of(baseline_doc)
    if rp is None or bp is None or rp == bp:
        return []
    return [
        {
            "metric": "device_mismatch",
            "direction": "match",
            "current": rp,
            "baseline": bp,
            "limit": None,
            "ratio": None,
            "regressed": bool(strict),
            "device_mismatch": True,
        }
    ]


def compare_span_shares(
    current: Dict[str, float], baseline: Dict[str, float], tolerance: float
) -> List[Dict]:
    """Span time-share verdicts: ABSOLUTE share growth beyond ``tolerance``
    regresses (shares are fractions of run wall-clock, so a ratio test
    would over-fire on tiny spans — 0.1% -> 0.4% is noise, 5% -> 20% is
    the regression this exists to catch). Only names present on both sides
    compare; a span that newly appeared has no baseline to regress from."""
    verdicts: List[Dict] = []
    for name in sorted(set(current) & set(baseline)):
        cur, base = current[name], baseline[name]
        limit = base + tolerance
        verdicts.append(
            {
                "metric": f"span:{name}",
                "direction": "lower",
                "current": cur,
                "baseline": base,
                "limit": limit,
                "ratio": cur / base if base else float("inf"),
                "regressed": cur > limit,
            }
        )
    return verdicts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--report",
        default=os.path.join("artifacts", "run_report.json"),
        help="run report to gate (from torch_report.py --run-dir)",
    )
    parser.add_argument(
        "--baseline", default=None, help="explicit baseline JSON to compare to"
    )
    parser.add_argument(
        "--tolerance", type=float, default=0.2,
        help="allowed fractional regression before failing (default 0.2)",
    )
    parser.add_argument(
        "--span-tolerance", type=float, default=0.1,
        help="allowed ABSOLUTE growth in a span's share of run wall-clock"
             " before failing (default 0.1 = ten percentage points)",
    )
    parser.add_argument(
        "--advisory", action="store_true",
        help="report regressions but always exit 0 (CI-on-shared-hardware mode)",
    )
    parser.add_argument(
        "--strict-device", action="store_true",
        help="fail (not just warn) when the report and baseline attest"
             " different device platforms",
    )
    parser.add_argument(
        "--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        help="repo root for baseline discovery (artifacts/GATE_BASELINE.json)",
    )
    args = parser.parse_args(argv)

    report = _load_json(args.report)
    if report is None:
        _say(f"no readable report at {args.report}; nothing to gate")
        sys.stdout.write(json.dumps({"gate": "skipped", "reason": "no_report"}) + "\n")
        return 0

    current = extract_metrics(report)
    resolved = resolve_baseline(args.baseline, args.root)
    if resolved is None:
        _say("no baseline found (--baseline or artifacts/GATE_BASELINE.json); pass")
        sys.stdout.write(
            json.dumps({"gate": "skipped", "reason": "no_baseline"}) + "\n"
        )
        return 0
    baseline_path, baseline_doc = resolved
    baseline = extract_metrics(baseline_doc)

    verdicts = compare(current, baseline, args.tolerance)
    verdicts.extend(mfu_target_verdict(current, report, baseline_doc))
    verdicts.extend(data_load_share_verdict(current, report, baseline_doc))
    verdicts.extend(costmodel_target_verdict(current, report, baseline_doc))
    verdicts.extend(kv_capacity_target_verdict(current, report, baseline_doc))
    verdicts.extend(
        device_mismatch_verdict(report, baseline_doc, args.strict_device)
    )
    verdicts.extend(
        compare_span_shares(
            extract_span_shares(report),
            extract_span_shares(baseline_doc),
            args.span_tolerance,
        )
    )
    if not verdicts:
        _say(
            f"baseline {baseline_path} shares no comparable metrics with "
            f"{args.report}; pass"
        )
        sys.stdout.write(
            json.dumps({"gate": "skipped", "reason": "no_common_metrics"}) + "\n"
        )
        return 0

    regressions = [v for v in verdicts if v["regressed"]]
    for v in verdicts:
        if v.get("device_mismatch"):
            # current/baseline are platform STRINGS here — must not reach
            # the numeric formatting below
            status = "REGRESSED" if v["regressed"] else "advisory"
            _say(
                f"device_mismatch: report ran on '{v['current']}' but the"
                f" baseline attests '{v['baseline']}' — every relative"
                f" comparison above crosses hardware -> {status}"
                + ("" if v["regressed"] else " (pass --strict-device to fail)")
            )
            continue
        if v.get("missing_baseline"):
            _say(
                f"{v['metric']}: current {v['current']:.6g} has no entry in"
                " the baseline -> missing_baseline (advisory; record a fresh"
                " baseline to start gating it)"
            )
            continue
        status = "REGRESSED" if v["regressed"] else "ok"
        is_span = v["metric"].startswith("span:")
        tol = (
            f"tol +{args.span_tolerance:.2f} abs" if is_span
            else "absolute floor" if v["metric"] == "mfu_vs_target"
            else "absolute ceiling" if v["metric"] in (
                "data_load_share_vs_target", "costmodel_error_vs_target"
            )
            else f"tol {args.tolerance:.0%}"
        )
        _say(
            f"{v['metric']}: current {v['current']:.6g} vs baseline "
            f"{v['baseline']:.6g} ({v['ratio']:.2f}x, {v['direction']} is "
            f"better, {tol}) -> {status}"
        )
    result = {
        "gate": "fail" if regressions else "pass",
        "advisory": bool(args.advisory),
        "baseline": baseline_path,
        "report": args.report,
        "tolerance": args.tolerance,
        "verdicts": verdicts,
    }
    sys.stdout.write(json.dumps(result) + "\n")
    if regressions and not args.advisory:
        _say(f"{len(regressions)} metric(s) regressed beyond tolerance")
        return 1
    if regressions:
        _say(f"{len(regressions)} regression(s) noted (advisory mode: exit 0)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
