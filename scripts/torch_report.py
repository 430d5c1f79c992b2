#!/usr/bin/env python3
"""The run report of the port's event logs and run directories.

The single event-log mode reads one log that a ``JsonlSink`` wrote (an
entry point's ``--event-log``, or one rank's shard of a run directory) and
renders the step-time percentiles, the wire ledger by tag, the compile
audit, the epochs, the span time sinks, the failure timeline (injected,
detected, recovered), the disaster-recovery incidents, the fallback
ladder's moves, the comm-fault recovery latency, the typed data drops, the
serving SLO, the paged KV pool and the fleet control plane.

With ``--run-dir`` the input is a whole run directory (manifest and
per-rank shards, ``launch ... --run-dir``): the shards are merged into one
timeline on the supervisor's clock (``observe.runlog.merge_run``), and the
text adds:

- the per-rank step-time skew, the straggler verdicts (``observe.
  analytics``), each flagged rank joined with the phase (and, for
  collective-wait, the ring edge) its critical-path excess sat in, and the
  effective bandwidth of the wire ledger against the step p50;
- the cross-rank critical path (``observe.critpath``) and the measured
  per-edge fabric matrix (``observe.fabric``);
- the MFU join (``observe.mfu``): the audit's counted FLOPs against the
  steady-state p50, against the H100's bf16 peak;
- the memory join: the ``MemoryEvent`` sampler's measured peak per rank
  (the port's compile events carry no predicted footprint, so the
  predicted peak stays unavailable);
- the backward buckets' exposed comm, the gradient-fidelity table and the
  accuracy-per-byte frontier (``observe.fidelity``), the two-level
  reduction's bytes per level, the cross-site partition timeline and the
  live plane's alerts;
- on a fleet scheduler's run directory (``launch fleet --run-dir``), each
  job's outcome, chip-seconds and preemptions, and the deadline-weighted
  goodput.

It writes the machine-readable report to ``--json-out`` (default
``artifacts/run_report.json``; ``scripts/torch_gate.py`` reads it), and
beside it the measured fabric matrix (``fabric_matrix.json``, which
``scripts/torch_plan.py --fabric-matrix`` reads) and the accuracy-per-byte
frontier (``fidelity_frontier.json``) where the run has them.

``--trace-out`` exports the merged timeline as Chrome-trace JSON (Perfetto
or ``chrome://tracing``): a process row per rank, nested spans as complete
events, the steps on their own track, collective and failure instants, and
memory and fidelity counters. ``--compare A B`` diffs two run directories
side by side; ``--watch`` redraws a live dashboard off the run's shards
(``observe.live.LiveAggregator``); ``--plan`` joins a
``scripts/torch_plan.py`` plan with the realized run
(``observe.costmodel.join_realized``: the model's ``error``).

Every function, flag and report key is the JAX package's
``scripts/report.py``'s. Imports no torch beyond the port's ``observe``
package.

Usage (from the root of the repository)::

    python3 scripts/torch_report.py runs/exact.jsonl
    python3 scripts/torch_report.py --run-dir runs/r7 --json-out out/run_report.json
    python3 scripts/torch_report.py --run-dir runs/r7 --trace-out out/trace.json
    python3 scripts/torch_report.py --compare runs/r7 runs/r8
    python3 scripts/torch_report.py --run-dir runs/r7 --watch
    python3 scripts/torch_report.py --run-dir runs/r8 --plan out/plan.json --plan-fabric "NVLink4(H100)"
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import sys
import time
from typing import Dict, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from network_distributed_pytorch_tpu_torch.observe import analytics, costmodel, critpath  # noqa: E402
from network_distributed_pytorch_tpu_torch.observe import fabric as fabric_mod  # noqa: E402
from network_distributed_pytorch_tpu_torch.observe import fidelity as fidelity_mod  # noqa: E402
from network_distributed_pytorch_tpu_torch.observe import mfu as mfu_mod  # noqa: E402
from network_distributed_pytorch_tpu_torch.observe import runlog  # noqa: E402
from network_distributed_pytorch_tpu_torch.observe.live import LiveAggregator, read_port_file  # noqa: E402


def load_events_counted(path: str) -> Tuple[List[Dict], int]:
    """Parse a JSONL event log, skipping the lines that are not JSON
    objects (foreign stdout interleaved into the log, the torn last line of
    a killed rank) and counting them, so that the report warns instead of
    passing the log off as whole."""
    events = []
    skipped = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if isinstance(rec, dict):
                events.append(rec)
            else:
                skipped += 1
    return events, skipped


def load_events(path: str) -> List[Dict]:
    """The events of :func:`load_events_counted` alone."""
    return load_events_counted(path)[0]


def load_plan(path: str) -> Optional[Dict]:
    """A ``scripts/torch_plan.py`` plan document, or None when unreadable."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) and "fabrics" in doc else None


def percentile(values: List[float], p: float) -> float:
    """Nearest-rank percentile (exact for the small samples a run log has)."""
    if not values:
        return float("nan")
    ordered = sorted(values)
    k = max(0, min(len(ordered) - 1, round(p / 100 * (len(ordered) - 1))))
    return ordered[int(k)]


def _fmt_bytes(n: float) -> str:
    if abs(n) >= 1e6:
        return f"{n / 1e6:.2f} MB"
    if abs(n) >= 1e3:
        return f"{n / 1e3:.2f} KB"
    return f"{n:.0f} B"


# failure-event kinds by role in the fault lifecycle (resilience/):
# an injection starts a timeline span; the next detection and the next
# recovery on the same rank close it with measurable latencies
_DETECTION_KINDS = {
    "worker_exit", "worker_hang", "watchdog_timeout", "bad_batch_dropped",
    "audit_error", "stale_peer", "preempt_notice",
    "comm_deadline", "comm_degraded", "checkpoint_unwritable",
}
_RECOVERY_KINDS = {
    "retry", "checkpoint_fallback", "worker_restart", "resumed",
    "resharded", "preempt_checkpoint", "degraded_restart",
    "worker_complete", "run_complete",
    "comm_fault_cleared", "comm_step_retry", "quorum_replan",
}
# the comm-layer fault kinds (resilience.chaos.COMM_FAULTS) — the
# recovery-latency clock starts at the first of these injected
_COMM_FAULT_LABELS = {
    "comm_throttle", "comm_stall", "comm_flap", "comm_slow_edge",
}
# supervisor-observed worker deaths; their messages carry the supervisor's
# graceful-vs-hard classification (SIGTERM honored within the grace window
# vs SIGKILL/crash), which the timeline tallies
_DEATH_KINDS = {"worker_exit", "worker_term"}


def _death_counts(events: List[Dict]) -> Dict[str, int]:
    counts = {"graceful": 0, "hard": 0}
    for f in events:
        if f.get("kind") not in _DEATH_KINDS:
            continue
        msg = f.get("message", "") or ""
        if "graceful" in msg:
            counts["graceful"] += 1
        elif "hard" in msg:
            counts["hard"] += 1
    return counts


def _same_rank(a: Dict, b: Dict) -> bool:
    ra, rb = a.get("rank"), b.get("rank")
    return ra is None or rb is None or ra == rb


def render_failure_timeline(failures: List[Dict]) -> List[str]:
    """The failures section: every failure-domain event (injected faults,
    detections, recoveries) ordered by timestamp with relative times, plus
    the injected → detected → recovered latencies per fault."""
    timed = [f for f in failures if isinstance(f.get("ts"), (int, float))]
    untimed = [f for f in failures if f not in timed]
    timed.sort(key=lambda f: f["ts"])
    ordered = timed + untimed
    t0 = timed[0]["ts"] if timed else None

    lines = ["", "failures — timeline", "-------------------"]
    for f in ordered:
        when = (
            f"t+{f['ts'] - t0:8.3f}s" if isinstance(f.get("ts"), (int, float))
            else " " * 10 + "-"
        )
        who = f"rank {f['rank']}" if f.get("rank") is not None else "-"
        inc = (
            f" inc {f['incarnation']}"
            if f.get("incarnation") not in (None, 0)
            else ""
        )
        at = f" @step {f['step']}" if f.get("step") is not None else ""
        detail = f.get("label", "") or ""
        msg = f.get("message", "") or ""
        tail = " ".join(x for x in (detail, msg) if x)
        lines.append(
            f"  {when}  {f.get('kind', '?'):<20} [{who}{inc}]{at}  {tail}"
        )

    deaths = _death_counts(ordered)
    if deaths["graceful"] or deaths["hard"]:
        lines.append(
            f"  deaths: {deaths['graceful']} graceful (SIGTERM honored /"
            f" clean exit), {deaths['hard']} hard (SIGKILL / crash)"
        )

    # latency spans: injected -> first detection -> first recovery (same rank)
    for i, f in enumerate(timed):
        if f.get("kind") != "chaos_injected":
            continue
        detected = recovered = None
        for g in timed[i + 1:]:
            if not _same_rank(f, g):
                continue
            if detected is None and g.get("kind") in _DETECTION_KINDS:
                detected = g
            if g.get("kind") in _RECOVERY_KINDS:
                recovered = g
                break
        span = []
        if detected is not None:
            span.append(f"detected +{detected['ts'] - f['ts']:.3f}s")
        if recovered is not None:
            span.append(
                f"{recovered.get('kind')} +{recovered['ts'] - f['ts']:.3f}s"
            )
        if span:
            lines.append(
                f"    -> {f.get('label', '?')}: {', '.join(span)}"
            )
    return lines


def _event_time(e: Dict) -> Optional[float]:
    t = e.get("t_run", e.get("ts"))
    return t if isinstance(t, (int, float)) else None


def render_policy_timeline(policies: List[Dict]) -> List[str]:
    """The fallback-controller section: every ladder move ordered by time,
    with the trigger verdict and the predicted-vs-realized bytes/step the
    controller claimed for it."""
    ordered = sorted(
        policies, key=lambda p: (_event_time(p) is None, _event_time(p) or 0.0)
    )
    t0 = next((_event_time(p) for p in ordered if _event_time(p) is not None), None)
    lines = ["", "policy — fallback ladder timeline",
             "---------------------------------"]
    for p in ordered:
        t = _event_time(p)
        when = f"t+{t - t0:8.3f}s" if t is not None and t0 is not None else " " * 10 + "-"
        pred = p.get("predicted_bytes_per_step")
        real = p.get("realized_bytes_per_step")
        claim = ""
        if pred is not None or real is not None:
            claim = (
                f"  realized {_fmt_bytes(real or 0)}/step ->"
                f" predicted {_fmt_bytes(pred or 0)}/step"
            )
        lines.append(
            f"  {when}  {p.get('action', '?'):<8} epoch {p.get('epoch', '?'):<3} "
            f"{p.get('rung_before', '?')} -> {p.get('rung_after', '?')}{claim}"
        )
        if p.get("trigger"):
            lines.append(f"      trigger: {p['trigger']}")
    descends = sum(1 for p in ordered if p.get("action") == "descend")
    ascends = sum(1 for p in ordered if p.get("action") == "ascend")
    last = ordered[-1] if ordered else None
    lines.append(
        f"  {descends} descend(s), {ascends} ascend(s); final rung"
        f" {last.get('rung_after', '?') if last else '?'}"
    )
    return lines


def render_alert_section(alerts: List[Dict]) -> List[str]:
    """The live plane's alert feed: every detector verdict ordered by time,
    with the measurement that fired it (empty run → no section)."""
    if not alerts:
        return []
    ordered = sorted(
        alerts, key=lambda a: (_event_time(a) is None, _event_time(a) or 0.0)
    )
    t0 = next(
        (_event_time(a) for a in ordered if _event_time(a) is not None), None
    )
    lines = ["", "live alerts — streaming detector verdicts",
             "-----------------------------------------"]
    for a in ordered:
        t = _event_time(a)
        when = (
            f"t+{t - t0:8.3f}s"
            if t is not None and t0 is not None
            else " " * 10 + "-"
        )
        who = f" rank {a['rank']}" if a.get("rank") is not None else ""
        lines.append(
            f"  {when}  {a.get('alert', '?'):<20} {a.get('severity', '?'):<8}"
            f" value {a.get('value', 0):.4g} / threshold"
            f" {a.get('threshold', 0):.4g}{who}"
        )
        if a.get("message"):
            lines.append(f"      {a['message']}")
    crit = sum(1 for a in ordered if a.get("severity") == "critical")
    lines.append(f"  {len(ordered)} alert(s), {crit} critical")
    return lines


def data_drop_summary(events: List[Dict]) -> Dict[str, Dict]:
    """Per-label tally of typed data-drop events (samples an experiment
    silently lost to shape constraints — now counted, not just noted)."""
    out: Dict[str, Dict] = {}
    for e in events:
        if e.get("event") != "data_drop":
            continue
        slot = out.setdefault(
            e.get("label", "?"),
            {"events": 0, "dropped_batches": 0, "dropped_samples": 0},
        )
        slot["events"] += 1
        slot["dropped_batches"] += int(e.get("dropped_batches", 0) or 0)
        slot["dropped_samples"] += int(e.get("dropped_samples", 0) or 0)
    return out


def slo_summary_from_events(events: List[Dict]) -> Optional[Dict]:
    """Per-run serving SLO aggregate over terminal ``request`` events
    (``observe.RequestEvent``, one per request from ``serving/``): state
    counts, p50/p99 of each latency phase, decode ms/token, and aggregate
    token throughput over the event window. None when the run served
    nothing (the section and the gate metric simply don't apply)."""
    reqs = [e for e in events if e.get("event") == "request"]
    if not reqs:
        return None
    finished = [e for e in reqs if e.get("state") == "finished"]
    out: Dict = {
        "n_requests": len(reqs),
        "n_finished": len(finished),
        "n_evicted": sum(1 for e in reqs if e.get("state") == "evicted"),
        "n_failed": sum(1 for e in reqs if e.get("state") == "failed"),
        "requeues": sum(int(e.get("requeues", 0) or 0) for e in finished),
    }
    for phase in ("queue_s", "prefill_s", "decode_s", "total_s"):
        vals = [e[phase] for e in finished if e.get(phase) is not None]
        out[f"p50_{phase}"] = percentile(vals, 50) if vals else None
        out[f"p99_{phase}"] = percentile(vals, 99) if vals else None
    per_tok = [
        1e3 * e["decode_s"] / (int(e["tokens_generated"]) - 1)
        for e in finished
        if e.get("decode_s") is not None
        and int(e.get("tokens_generated", 0) or 0) > 1
    ]
    out["p50_decode_ms_per_token"] = percentile(per_tok, 50) if per_tok else None
    out["p99_decode_ms_per_token"] = percentile(per_tok, 99) if per_tok else None
    total_tokens = sum(int(e.get("tokens_generated", 0) or 0) for e in finished)
    out["total_tokens"] = total_tokens
    # throughput over the window the terminal events span: an aggregate
    # fleet number (per-request rates double-count concurrency)
    ts = [t for e in finished if (t := _event_time(e)) is not None]
    out["tokens_per_s"] = (
        total_tokens / (max(ts) - min(ts))
        if total_tokens and len(ts) > 1 and max(ts) > min(ts)
        else None
    )
    return out


def render_request_section(slo: Dict) -> List[str]:
    def _ms(v: Optional[float]) -> str:
        return f"{v * 1e3:8.1f} ms" if v is not None else "     n/a   "

    lines = ["", "serving SLO (per-request latencies)",
             "-----------------------------------"]
    lines.append(
        f"  {slo['n_requests']} request(s): {slo['n_finished']} finished, "
        f"{slo['n_evicted']} evicted, {slo['n_failed']} failed, "
        f"{slo['requeues']} requeue(s) survived"
    )
    for phase, label in (
        ("queue_s", "queue"), ("prefill_s", "prefill"),
        ("decode_s", "decode"), ("total_s", "total"),
    ):
        lines.append(
            f"  {label:<8} p50 {_ms(slo.get(f'p50_{phase}'))}   "
            f"p99 {_ms(slo.get(f'p99_{phase}'))}"
        )
    p50 = slo.get("p50_decode_ms_per_token")
    p99 = slo.get("p99_decode_ms_per_token")
    if p50 is not None and p99 is not None:
        lines.append(
            f"  decode/token p50 {p50:8.2f} ms   p99 {p99:8.2f} ms"
            " (the gate's serving scalar)"
        )
    tps = slo.get("tokens_per_s")
    tps_txt = f"{tps:,.1f} tokens/s" if tps else "n/a"
    lines.append(
        f"  throughput  {tps_txt} ({slo['total_tokens']} tokens)"
    )
    return lines


def kv_pool_summary_from_events(events: List[Dict]) -> Optional[Dict]:
    """Paged-KV memory aggregate over ``kv_pool`` events
    (``observe.KVPoolEvent``, emitted by ``serving.engine.PagedEngine``
    every few ticks and at eviction). Per engine (rank, label): the LAST
    snapshot (counters are monotonic, occupancy is current) plus the
    high-water block usage across the run; totals for the table the gate
    and a human both read. None when the run never served paged."""
    pools = [e for e in events if e.get("event") == "kv_pool"]
    if not pools:
        return None
    by_engine: Dict[Tuple, Dict] = {}
    for e in pools:
        key = (e.get("rank"), str(e.get("label", "serving")))
        slot = by_engine.setdefault(key, {"min_free": None, "last": None})
        free = e.get("blocks_free")
        if isinstance(free, (int, float)) and (
            slot["min_free"] is None or free < slot["min_free"]
        ):
            slot["min_free"] = int(free)
        slot["last"] = e
    engines = []
    for (rank, label), slot in sorted(
        by_engine.items(), key=lambda kv: (kv[0][0] is None, kv[0])
    ):
        last = slot["last"]
        n_blocks = int(last.get("n_blocks", 0) or 0)
        used = int(last.get("blocks_used", 0) or 0)
        shared = int(last.get("blocks_shared", 0) or 0)
        engines.append(
            {
                "rank": rank,
                "label": label,
                "pool_bytes": int(last.get("pool_bytes", 0) or 0),
                "n_blocks": n_blocks,
                "block_len": int(last.get("block_len", 0) or 0),
                "blocks_free": int(last.get("blocks_free", 0) or 0),
                "blocks_used": used,
                "blocks_shared": shared,
                # peak occupancy over the run, from the min free observed
                "peak_blocks_used": (
                    n_blocks - 1 - slot["min_free"]
                    if slot["min_free"] is not None and n_blocks
                    else None
                ),
                "prefix_hits_total": int(last.get("prefix_hits_total", 0) or 0),
                "prefill_tokens_saved_total": int(
                    last.get("prefill_tokens_saved_total", 0) or 0
                ),
                "cow_copies_total": int(last.get("cow_copies_total", 0) or 0),
                "admissions_deferred_total": int(
                    last.get("admissions_deferred_total", 0) or 0
                ),
            }
        )
    used = sum(e["blocks_used"] for e in engines)
    shared = sum(e["blocks_shared"] for e in engines)
    return {
        "n_engines": len(engines),
        "engines": engines,
        "pool_bytes_total": sum(e["pool_bytes"] for e in engines),
        "blocks_free_total": sum(e["blocks_free"] for e in engines),
        "prefix_hits_total": sum(e["prefix_hits_total"] for e in engines),
        "prefill_tokens_saved_total": sum(
            e["prefill_tokens_saved_total"] for e in engines
        ),
        "cow_copies_total": sum(e["cow_copies_total"] for e in engines),
        "admissions_deferred_total": sum(
            e["admissions_deferred_total"] for e in engines
        ),
        # fraction of currently-referenced blocks that more than one chain
        # owns — the live footprint prefix sharing is deduplicating
        "prefix_shared_share": (shared / used) if used else 0.0,
    }


def render_kv_pool_section(kv: Dict) -> List[str]:
    lines = ["", "serving KV memory (paged block pool)",
             "------------------------------------"]
    lines.append(
        f"  {kv['n_engines']} engine(s): pool {_fmt_bytes(kv['pool_bytes_total'])}"
        f" total, {kv['blocks_free_total']} block(s) free,"
        f" {100.0 * kv['prefix_shared_share']:.1f}% of used blocks"
        " prefix-shared"
    )
    lines.append(
        f"  prefix hits {kv['prefix_hits_total']}"
        f" ({kv['prefill_tokens_saved_total']} prefill token(s) saved),"
        f" cow copies {kv['cow_copies_total']},"
        f" admissions deferred {kv['admissions_deferred_total']}"
    )
    for e in kv["engines"]:
        rank = "?" if e["rank"] is None else e["rank"]
        peak = (
            f"peak {e['peak_blocks_used']}" if e["peak_blocks_used"] is not None
            else "peak n/a"
        )
        lines.append(
            f"    rank {rank} {e['label']:<12} {_fmt_bytes(e['pool_bytes'])}"
            f" = {e['n_blocks']} x {e['block_len']}-token blocks,"
            f" used {e['blocks_used']} ({peak}),"
            f" shared {e['blocks_shared']}"
        )
    return lines


def fleet_summary_from_events(events: List[Dict]) -> Optional[Dict]:
    """Fleet control-plane aggregate over the scheduler's typed events
    (``job`` lifecycle, ``preempt``, ``schedule``, ``job_failed``): per-job
    outcome rows plus the deadline-weighted goodput scalar the gate
    compares — completed work weighted 1.0 when the deadline was met (or
    none was set), 0.5 when missed, divided by every chip-second any
    terminal job held. None when the run scheduled nothing."""
    job_events = [e for e in events if e.get("event") == "job"]
    if not job_events:
        return None
    jobs: Dict[str, Dict] = {}
    for e in job_events:
        j = jobs.setdefault(
            str(e.get("job_id", "?")),
            {
                "kind": e.get("kind", ""),
                "priority": e.get("priority", 0),
                "state": "unfinished",
                "transitions": [],
                "preemptions": 0,
                "chip_seconds": None,
                "work_done": None,
                "met_deadline": None,
            },
        )
        state = e.get("state")
        j["transitions"].append(state)
        j["preemptions"] = max(
            j["preemptions"], int(e.get("preemptions", 0) or 0)
        )
        if state in ("completed", "failed"):
            j["state"] = "quarantined" if state == "failed" else state
            j["chip_seconds"] = e.get("chip_seconds")
            j["work_done"] = e.get("work_done")
            j["met_deadline"] = e.get("met_deadline")
    schedules = [e for e in events if e.get("event") == "schedule"]
    terminal = [j for j in jobs.values() if j["state"] != "unfinished"]
    total_chip_s = sum(
        j["chip_seconds"] for j in terminal
        if isinstance(j["chip_seconds"], (int, float))
    )
    weighted = sum(
        (0.5 if j["met_deadline"] is False else 1.0) * j["work_done"]
        for j in terminal
        if j["state"] == "completed"
        and isinstance(j["work_done"], (int, float))
    )
    return {
        "n_jobs": len(jobs),
        "jobs": jobs,
        "completed": sorted(
            k for k, j in jobs.items() if j["state"] == "completed"
        ),
        "quarantined": sorted(
            k for k, j in jobs.items() if j["state"] == "quarantined"
        ),
        "unfinished": sorted(
            k for k, j in jobs.items() if j["state"] == "unfinished"
        ),
        "preemptions": sum(
            1 for e in events if e.get("event") == "preempt"
        ),
        "admissions": len(schedules),
        "planner_priced": sum(
            1 for e in schedules if e.get("planner") == "costmodel"
        ),
        "total_chip_seconds": total_chip_s,
        "weighted_work": weighted,
        "goodput": (weighted / total_chip_s) if total_chip_s else None,
    }


def render_fleet_section(fleet: Dict) -> List[str]:
    lines = ["", "fleet control plane (gang scheduler)",
             "------------------------------------"]
    lines.append(
        f"  {fleet['n_jobs']} job(s): {len(fleet['completed'])} completed, "
        f"{len(fleet['quarantined'])} quarantined, "
        f"{len(fleet['unfinished'])} unfinished; "
        f"{fleet['preemptions']} preemption(s) over "
        f"{fleet['admissions']} admission(s) "
        f"({fleet['planner_priced']} planner-priced)"
    )
    for name, j in sorted(fleet["jobs"].items()):
        chip = j.get("chip_seconds")
        chip_txt = f"{chip:8.1f} chip-s" if chip is not None else "     n/a      "
        met = j.get("met_deadline")
        met_txt = (
            "deadline met" if met
            else "deadline MISSED" if met is False
            else "no deadline"
        )
        lines.append(
            f"  {name:<12} {j.get('kind', '?'):<5} prio {j['priority']:>3}  "
            f"{j['state']:<12} {chip_txt}  {met_txt}  "
            f"{j['preemptions']} preemption(s)"
        )
    gp = fleet.get("goodput")
    if gp is not None:
        lines.append(
            f"  goodput  {gp:.4f} weighted-work/chip-s over "
            f"{fleet['total_chip_seconds']:.1f} chip-s (the gate's fleet"
            " scalar, higher = better)"
        )
    return lines


def recovery_latency_s(events: List[Dict]) -> Optional[float]:
    """Seconds from the FIRST injected comm fault to the first healthy
    step after it — a step whose window (previous step's close, its close]
    contains no comm_deadline/comm_degraded detection and no further comm
    fault injection. None when no comm fault was injected or the run never
    got healthy again (itself a finding: the gate treats missing as
    worst-case)."""
    injected = [
        t for e in events
        if e.get("event") == "failure" and e.get("kind") == "chaos_injected"
        and e.get("label") in _COMM_FAULT_LABELS
        and (t := _event_time(e)) is not None
    ]
    if not injected:
        return None
    t0 = min(injected)
    bad = sorted(
        t for e in events
        if e.get("event") == "failure"
        and (
            e.get("kind") in ("comm_deadline", "comm_degraded")
            or (
                e.get("kind") == "chaos_injected"
                and e.get("label") in _COMM_FAULT_LABELS
            )
        )
        and (t := _event_time(e)) is not None
    )
    steps = sorted(
        t for e in events
        if e.get("event") == "step" and (t := _event_time(e)) is not None
    )
    prev: Optional[float] = None
    for st in steps:
        if st <= t0:
            prev = st
            continue
        lo = prev if prev is not None else float("-inf")
        i = bisect.bisect_right(bad, lo)
        if i >= len(bad) or bad[i] > st:
            return st - t0
        prev = st
    return None


def _mesh_str(mesh: Optional[Dict]) -> str:
    if not isinstance(mesh, dict):
        return "?"
    return "x".join(
        str(mesh.get(a, 1)) for a in ("data", "fsdp", "tensor")
    )


def recovery_incidents(events: List[Dict]) -> List[Dict]:
    """The disaster-recovery timeline: one incident per supervisor mesh
    replan (typed ``reshape`` event).  Each incident's clock starts at the
    earliest HARD worker death since the previous replan (when the fault
    actually landed) and stops at the first step event after the old
    world is fully torn down (the replan's last ``worker_term`` shutdown
    — a step before that could be a not-yet-killed old-generation worker,
    not the survivors), so ``recovery_s`` measures the whole detect →
    replan → respawn → reshard → step outage, not just the supervisor's
    bookkeeping."""
    reshapes = sorted(
        (
            (t, e) for e in events
            if e.get("event") == "reshape"
            and (t := _event_time(e)) is not None
        ),
        key=lambda p: p[0],
    )
    if not reshapes:
        return []
    deaths = sorted(
        t for e in events
        if e.get("event") == "failure" and e.get("kind") in _DEATH_KINDS
        and "hard" in (e.get("message") or "")
        and (t := _event_time(e)) is not None
    )
    steps = sorted(
        t for e in events
        if e.get("event") == "step" and (t := _event_time(e)) is not None
    )
    terms = sorted(
        t for e in events
        if e.get("event") == "failure" and e.get("kind") == "worker_term"
        and "reshape" in (e.get("message") or "")
        and (t := _event_time(e)) is not None
    )
    incidents: List[Dict] = []
    prev = float("-inf")
    for n, (t_r, e) in enumerate(reshapes):
        i = bisect.bisect_right(deaths, prev)
        j = bisect.bisect_right(deaths, t_r)
        start = deaths[i] if i < j else t_r
        # the old world is down once this replan's last worker_term landed
        # (bounded by the next replan, if any)
        t_next = reshapes[n + 1][0] if n + 1 < len(reshapes) else float("inf")
        lo = bisect.bisect_right(terms, t_r)
        hi = bisect.bisect_right(terms, t_next)
        t_down = terms[hi - 1] if hi > lo else t_r
        k = bisect.bisect_right(steps, t_down)
        end = steps[k] if k < len(steps) else None
        incidents.append({
            "ts": t_r,
            "old_world": e.get("old_world"),
            "new_world": e.get("new_world"),
            "old_mesh": e.get("old_mesh"),
            "new_mesh": e.get("new_mesh"),
            "dead_ranks": e.get("dead_ranks"),
            "correlated": bool(e.get("correlated")),
            "reason": e.get("reason", "") or "",
            "detect_s": t_r - start,
            "recovery_s": (end - start) if end is not None else None,
        })
        prev = t_r
    return incidents


def mttr_s(incidents: List[Dict]) -> Optional[float]:
    """Mean time to recovery over the incidents that actually healed
    (produced a post-replan step).  None when there were no incidents or
    none healed — the gate treats missing as worst-case."""
    healed = [
        i["recovery_s"] for i in incidents if i.get("recovery_s") is not None
    ]
    return sum(healed) / len(healed) if healed else None


def render_recovery_section(incidents: List[Dict]) -> List[str]:
    lines = [
        "",
        "disaster recovery — replan timeline",
        "-----------------------------------",
    ]
    t0 = incidents[0]["ts"]
    for n, inc in enumerate(incidents):
        label = "correlated" if inc["correlated"] else "independent"
        dead = ",".join(str(r) for r in (inc.get("dead_ranks") or []))
        mesh = ""
        if inc.get("old_mesh") or inc.get("new_mesh"):
            mesh = (
                f"  mesh {_mesh_str(inc.get('old_mesh'))}"
                f" -> {_mesh_str(inc.get('new_mesh'))}"
            )
        lines.append(
            f"  incident {n}: t+{inc['ts'] - t0:8.3f}s  {label} death of"
            f" rank(s) [{dead}]  world {inc.get('old_world')} ->"
            f" {inc.get('new_world')}{mesh}"
        )
        rec = (
            f"{inc['recovery_s']:.3f}s"
            if inc.get("recovery_s") is not None
            else "never (no step after replan)"
        )
        lines.append(
            f"    -> detected +{inc['detect_s']:.3f}s, recovered {rec}"
        )
    m = mttr_s(incidents)
    if m is not None:
        lines.append(
            f"  MTTR: {m:.3f}s over {len(incidents)} incident(s)"
            " (hard death -> first post-replan step)"
        )
    return lines


def render_report(events: List[Dict], name: str = "", skipped_lines: int = 0) -> str:
    by_kind: Dict[str, List[Dict]] = {}
    for e in events:
        by_kind.setdefault(e.get("event", "raw"), []).append(e)

    lines: List[str] = []
    title = f"run report{': ' + name if name else ''}"
    lines.append(title)
    lines.append("=" * len(title))
    kinds = ", ".join(f"{k}={len(v)}" for k, v in sorted(by_kind.items()))
    lines.append(f"{len(events)} events ({kinds})")
    if skipped_lines:
        lines.append(
            f"  warning: {skipped_lines} unparseable/torn line(s) skipped"
            " (foreign stdout or a killed rank's half-written tail)"
        )

    steps = by_kind.get("step", [])
    valid = [s for s in steps if s.get("valid", True)]
    times = [s["step_time_s"] for s in valid if "step_time_s" in s]
    if steps:
        lines.append("")
        lines.append("steps")
        lines.append("-----")
        lines.append(
            f"  {len(steps)} steps recorded, {len(valid)} with valid timing"
        )
        if times:
            # the first timed step pays jit compilation; steady-state excludes it
            steady = times[1:] if len(times) > 1 else times
            lines.append(
                f"  step time   p50 {percentile(steady, 50) * 1e3:8.1f} ms   "
                f"p95 {percentile(steady, 95) * 1e3:8.1f} ms   "
                f"(steady-state, n={len(steady)}; "
                f"first step {times[0] * 1e3:.1f} ms incl. compile)"
            )
        losses = [s["loss"] for s in steps if "loss" in s]
        if losses:
            lines.append(
                f"  loss        first {losses[0]:.4f} -> last {losses[-1]:.4f}"
            )
        bits = [s["bits_cumulative"] for s in steps if "bits_cumulative" in s]
        if bits and len(steps) > 0:
            per_step = (bits[-1] - bits[0]) / max(1, len(steps) - 1) / 8 if len(steps) > 1 else bits[0] / 8
            lines.append(
                f"  wire        {_fmt_bytes(bits[-1] / 8)} total, "
                f"{_fmt_bytes(per_step)}/step"
            )

    collectives = by_kind.get("collective", [])
    if collectives:
        lines.append("")
        lines.append("wire ledger (bytes/step by tag)")
        lines.append("-------------------------------")
        total = sum(c.get("payload_bytes", 0) for c in collectives)
        for c in collectives:
            pct = 100 * c.get("payload_bytes", 0) / total if total else 0
            lines.append(
                f"  {c.get('tag', '?'):<18} {c.get('layer', '?'):<8} "
                f"{c.get('op', '?'):<14} x{c.get('count', 1):<3} "
                f"{_fmt_bytes(c.get('payload_bytes', 0)):>12}  ({pct:4.1f}%)"
            )
        lines.append(f"  {'total':<18} {'':<8} {'':<14} {'':<4} {_fmt_bytes(total):>12}")

    for comp in by_kind.get("compile", []):
        lines.append("")
        lines.append(f"compile audit: {comp.get('label', '?')}")
        lines.append("-" * (15 + len(str(comp.get("label", "?")))))
        delta = comp.get("delta_bytes", 0)
        verdict = "byte-exact" if comp.get("exact") else f"delta {delta:+d} B"
        lines.append(
            f"  analytic {_fmt_bytes(comp.get('analytic_bytes', 0))}/step vs "
            f"compiled HLO {_fmt_bytes(comp.get('hlo_bytes', 0))}/step -> {verdict}"
        )
        if comp.get("hlo_by_kind"):
            kinds = ", ".join(
                f"{k} x{v}" for k, v in sorted(comp["hlo_by_kind"].items())
            )
            lines.append(
                f"  HLO collectives ({comp.get('hlo_collective_count', 0)}): {kinds}"
            )
        if comp.get("compression_ratio") is not None:
            lines.append(
                f"  compression {comp['compression_ratio']:.1f}x "
                f"(dense gradient {_fmt_bytes(comp.get('dense_grad_bytes') or 0)})"
            )
        if comp.get("flops_per_step"):
            peak = comp.get("peak_flops_per_s")
            peak_txt = f", peak {peak / 1e12:.1f} TF/s" if peak else ""
            ba = comp.get("bytes_accessed_per_step")
            ba_txt = f", {_fmt_bytes(ba)} accessed" if ba else ""
            lines.append(
                f"  device cost: {comp['flops_per_step'] / 1e9:.2f} GF/step "
                f"({comp.get('flops_source', '?')}) on "
                f"{comp.get('device_kind') or 'unknown device'}{peak_txt}{ba_txt}"
            )
        if comp.get("peak_hbm_bytes") is not None:
            split = ", ".join(
                f"{name[: -len('_bytes')]} {_fmt_bytes(comp[name])}"
                for name in (
                    "argument_bytes", "output_bytes", "temp_bytes",
                    "generated_code_bytes",
                )
                if comp.get(name) is not None
            )
            lines.append(
                f"  HBM footprint: predicted peak "
                f"{_fmt_bytes(comp['peak_hbm_bytes'])}"
                + (f" ({split})" if split else "")
            )
        ov = comp.get("overlap") or {}
        if ov:
            if ov.get("scheduled"):
                lines.append(
                    f"  overlap: {ov.get('n_overlapped', 0)}/"
                    f"{ov.get('n_async_collectives', 0)} async collectives "
                    f"overlapped with compute; "
                    f"{ov.get('n_copy_windows_with_compute', 0)}/"
                    f"{ov.get('n_async_copy_windows', 0)} DMA copy windows "
                    f"with compute inside"
                )
                if ov.get("collective_emitters"):
                    lines.append(
                        f"  emitters: {', '.join(sorted(set(ov['collective_emitters'])))}"
                    )
            else:
                lines.append(
                    "  overlap: HLO not scheduled (CPU backend) — async windows n/a"
                )

    epochs = by_kind.get("epoch", [])
    if epochs:
        lines.append("")
        lines.append("epochs")
        lines.append("------")
        for e in epochs:
            lines.append(
                f"  epoch {e.get('epoch', '?')}: mean loss "
                f"{e.get('mean_loss', float('nan')):.4f}, "
                f"{_fmt_bytes(e.get('bits_cumulative', 0) / 8)} cumulative"
            )

    # single-process runs carry spans too (t_run falls back to the emit ts)
    spans = span_summary(events)
    if spans:
        lines.extend(render_span_section(spans))

    # reshape events ride the failure timeline (their ``kind`` is the
    # supervisor's replan label, e.g. quorum_replan)
    failures = by_kind.get("failure", []) + by_kind.get("reshape", [])
    if failures:
        lines.extend(render_failure_timeline(failures))

    incidents = recovery_incidents(events)
    if incidents:
        lines.extend(render_recovery_section(incidents))

    policies = by_kind.get("policy", [])
    if policies:
        lines.extend(render_policy_timeline(policies))
    latency = recovery_latency_s(events)
    if latency is not None:
        lines.append("")
        lines.append(
            f"comm-fault recovery latency: {latency:.3f}s"
            " (first injected comm fault -> first clean step)"
        )

    drops = data_drop_summary(events)
    if drops:
        lines.append("")
        lines.append("data drops (typed)")
        lines.append("------------------")
        for label, d in sorted(drops.items()):
            lines.append(
                f"  {label:<18} {d['dropped_samples']} sample(s) in "
                f"{d['dropped_batches']} batch(es) over {d['events']} event(s)"
            )

    slo = slo_summary_from_events(events)
    if slo:
        lines.extend(render_request_section(slo))

    kv = kv_pool_summary_from_events(events)
    if kv:
        lines.extend(render_kv_pool_section(kv))

    fleet = fleet_summary_from_events(events)
    if fleet:
        lines.extend(render_fleet_section(fleet))

    notes = by_kind.get("note", [])
    if notes:
        lines.append("")
        lines.append(f"notes: {len(notes)}")

    return "\n".join(lines) + "\n"


def _fmt_rate(bps: float) -> str:
    if bps >= 1e9:
        return f"{bps / 1e9:.2f} GB/s"
    if bps >= 1e6:
        return f"{bps / 1e6:.2f} MB/s"
    return f"{bps / 1e3:.2f} KB/s"


def render_run_sections(
    merged, stats: Dict[int, Dict], stragglers: List, bandwidth: Optional[Dict],
    straggler_factor: float,
) -> List[str]:
    """The multi-rank sections: per-rank step-time skew, straggler
    verdicts, and the achieved-vs-modeled bandwidth table."""
    lines: List[str] = []
    p50s = [s["p50_s"] for s in stats.values() if s["n"]]
    median_p50 = percentile(p50s, 50) if p50s else float("nan")

    lines.append("")
    lines.append("per-rank step time (steady-state)")
    lines.append("---------------------------------")
    for rank in sorted(merged.per_rank):
        pr = merged.per_rank[rank]
        s = stats.get(rank)
        if pr.get("missing"):
            lines.append(f"  rank {rank}: shard missing")
            continue
        torn = f", {pr['torn_lines']} torn" if pr.get("torn_lines") else ""
        if s is None or not s["n"]:
            lines.append(
                f"  rank {rank}: {pr['events']} events, no timed steps{torn}"
            )
            continue
        skew = s["p50_s"] / median_p50 if median_p50 and median_p50 > 0 else float("nan")
        lines.append(
            f"  rank {rank}: n={s['n']:<3} p50 {s['p50_s'] * 1e3:8.1f} ms  "
            f"p95 {s['p95_s'] * 1e3:8.1f} ms  skew {skew:5.2f}x  "
            f"clock offset {pr['clock_offset_s']:+.3f}s{torn}"
        )
    if p50s:
        worst = max(p50s) / median_p50 if median_p50 > 0 else float("nan")
        lines.append(
            f"  cross-rank median p50 {median_p50 * 1e3:.1f} ms; "
            f"max/median skew {worst:.2f}x"
        )

    lines.append("")
    lines.append(f"stragglers (threshold {straggler_factor:.2f}x median p50)")
    lines.append("-" * 42)
    if stragglers:
        for ev in stragglers:
            lines.append(f"  {ev.banner()}")
    else:
        lines.append("  none")

    if bandwidth:
        attr = bandwidth["attribution"]
        lines.append("")
        lines.append("effective bandwidth (measured bytes / measured seconds)")
        lines.append("-------------------------------------------------------")
        if attr["n_collectives"]:
            lines.append(
                f"  comm budget {bandwidth['comm_budget_s'] * 1e3:.1f} ms/step "
                f"(exposed fraction {attr['exposed_fraction']:.2f} of "
                f"{attr['n_collectives']} scheduled collectives)"
            )
        else:
            lines.append(
                f"  comm budget {bandwidth['comm_budget_s'] * 1e3:.1f} ms/step "
                "(no schedule evidence: every collective charged as exposed)"
            )
        for row in bandwidth["by_tag"] + [dict(bandwidth["total"], tag="total", op="")]:
            util = " | ".join(
                f"{f} {100 * u:.2f}%" for f, u in row["utilization"].items()
            )
            lines.append(
                f"  {row['tag']:<18} {row.get('op', ''):<14} "
                f"{_fmt_bytes(row['payload_bytes']):>12}/step x{row['count']:<3} "
                f"achieved {_fmt_rate(row['achieved_bytes_per_s'])}"
            )
            lines.append(f"      line-rate utilization: {util}")
    return lines


def hierarchy_summary(bandwidth: Optional[Dict]) -> Optional[Dict]:
    """Per-level wire traffic for a two-level hierarchical run: the
    bandwidth rows whose ledger tags carry the reducer's ``outer.`` /
    ``inner.`` level prefixes, aggregated per level. None when the run
    was flat (no level-tagged collectives) — the section simply doesn't
    apply. ``outer_bytes_per_step`` is the geo claim's falsifiable
    number: the cross-site traffic the compressed outer reduction
    actually moved, joinable against the cost model's
    ``predicted_outer_bytes_per_step``."""
    if not isinstance(bandwidth, dict):
        return None
    levels: Dict[str, Dict] = {}
    for row in bandwidth.get("by_tag") or []:
        tag = str(row.get("tag") or "")
        level = tag.split(".", 1)[0]
        if level not in ("outer", "inner") or "." not in tag:
            continue
        slot = levels.setdefault(
            level, {"payload_bytes": 0.0, "count": 0, "tags": []}
        )
        slot["payload_bytes"] += float(row.get("payload_bytes") or 0.0)
        slot["count"] += int(row.get("count") or 0)
        slot["tags"].append(tag)
    if not levels:
        return None
    outer = levels.get("outer", {}).get("payload_bytes", 0.0)
    inner = levels.get("inner", {}).get("payload_bytes", 0.0)
    total = outer + inner
    return {
        "levels": levels,
        "outer_bytes_per_step": outer,
        "inner_bytes_per_step": inner,
        # the shrinkage the two-level design buys: fraction of the wire
        # traffic that actually crossed the slow edge
        "cross_site_fraction": (outer / total) if total > 0 else None,
    }


def render_hierarchy_section(hierarchy: Optional[Dict]) -> List[str]:
    if not hierarchy:
        return []
    lines = ["", "hierarchical reduction — bytes per level", "-" * 41]
    for level in ("inner", "outer"):
        slot = hierarchy["levels"].get(level)
        if not slot:
            continue
        lines.append(
            f"  {level:<6} {_fmt_bytes(slot['payload_bytes']):>12}/step "
            f"x{slot['count']:<4} ({', '.join(sorted(slot['tags']))})"
        )
    frac = hierarchy.get("cross_site_fraction")
    if frac is not None:
        lines.append(
            f"  cross-site share of wire traffic: {100 * frac:.2f}%"
        )
    return lines


def partition_summary(events: List[Dict]) -> Optional[Dict]:
    """The cross-site partition timeline: every typed ``partition`` event
    (``observe.events.PartitionEvent`` — the guarded outer sync degrading
    to site-local training, charging its divergence budget, rejoining).
    None when the run never partitioned."""
    parts = [e for e in events if e.get("event") == "partition"]
    if not parts:
        return None
    phases: Dict[str, int] = {}
    for e in parts:
        k = str(e.get("phase", "?"))
        phases[k] = phases.get(k, 0) + 1
    local_steps = [
        int(e["local_steps"]) for e in parts
        if isinstance(e.get("local_steps"), (int, float))
    ]
    budgets = [
        int(e["max_local_steps"]) for e in parts
        if isinstance(e.get("max_local_steps"), (int, float))
    ]
    return {
        "events": parts,
        "by_phase": phases,
        "n_partitions": phases.get("partitioned", 0),
        "n_rejoins": phases.get("rejoin", 0),
        "max_local_steps": max(local_steps) if local_steps else 0,
        "budget": max(budgets) if budgets else None,
        "healed": phases.get("rejoin", 0) >= phases.get("partitioned", 0)
        and phases.get("partitioned", 0) > 0,
    }


def render_partition_section(partitions: Optional[Dict]) -> List[str]:
    if not partitions:
        return []
    lines = ["", "cross-site partitions — timeline", "-" * 32]
    timed = sorted(
        partitions["events"],
        key=lambda e: (_event_time(e) is None, _event_time(e) or 0.0),
    )
    for e in timed:
        t = _event_time(e)
        stamp = f"t+{t:8.3f}s" if t is not None else " " * 10
        detail = []
        if e.get("edge"):
            detail.append(f"edge {e['edge']}")
        if isinstance(e.get("local_steps"), (int, float)):
            detail.append(
                f"local {int(e['local_steps'])}/{e.get('max_local_steps', '?')}"
            )
        if e.get("reason"):
            detail.append(str(e["reason"]))
        lines.append(
            f"  {stamp}  {str(e.get('phase', '?')):<12} "
            f"step {e.get('step', '?')}  {'; '.join(detail)}"
        )
    lines.append(
        f"  {partitions['n_partitions']} partition(s), "
        f"{partitions['n_rejoins']} rejoin(s), worst site-local stretch "
        f"{partitions['max_local_steps']} step(s)"
        + (
            f" of {partitions['budget']} budget"
            if partitions.get("budget") is not None else ""
        )
    )
    return lines


def _union_len(intervals: List[Tuple[float, float]]) -> float:
    """Total length covered by a set of (start, end) intervals."""
    covered = 0.0
    end = None
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if end is None or lo > end:
            covered += hi - lo
            end = hi
        elif hi > end:
            covered += hi - end
            end = hi
    return covered


def span_summary(events: List[Dict]) -> Optional[Dict]:
    """Aggregate the merged timeline's SpanEvents into per-name time
    shares and per-rank idle gaps.

    A span's ``ts``/``t_run`` marks its CLOSE; start is ``t_run − dur_s``.
    ``share`` divides a span name's total time by the summed per-rank wall
    (each rank's last-event-minus-first-event window), so it is the
    fraction of run wall-clock that name occupied — comparable across runs
    and what ``scripts/torch_gate.py`` regresses on. ``idle`` is the part of a
    rank's wall NOT covered by any depth-0 span: host time attributed to
    nothing, the first place to look when MFU is low but no span is hot."""
    spans = [
        e for e in events
        if e.get("event") == "span"
        and isinstance(e.get("dur_s"), (int, float)) and e["dur_s"] >= 0
    ]
    if not spans:
        return None
    walls: Dict = {}
    for e in events:
        t = e.get("t_run", e.get("ts"))
        if isinstance(t, (int, float)):
            r = e.get("rank")
            lo, hi = walls.get(r, (t, t))
            walls[r] = (min(lo, t), max(hi, t))
    total_wall = sum(hi - lo for lo, hi in walls.values())
    by_name: Dict[str, Dict] = {}
    for s in spans:
        slot = by_name.setdefault(
            s.get("name", "?"), {"count": 0, "total_s": 0.0, "max_s": 0.0}
        )
        slot["count"] += 1
        slot["total_s"] += s["dur_s"]
        slot["max_s"] = max(slot["max_s"], s["dur_s"])
    for slot in by_name.values():
        slot["mean_s"] = slot["total_s"] / slot["count"]
        slot["share"] = (
            slot["total_s"] / total_wall if total_wall > 0 else None
        )
    idle_by_rank: Dict[str, Dict] = {}
    for r, (lo, hi) in sorted(
        walls.items(), key=lambda kv: (kv[0] is None, kv[0])
    ):
        if r is None:  # the supervisor's shard has no training work to idle
            continue
        ivals = [
            (max(lo, s["t_run"] - s["dur_s"]), min(hi, s["t_run"]))
            for s in spans
            if s.get("rank") == r and s.get("depth") == 0
            and isinstance(s.get("t_run"), (int, float))
        ]
        if not ivals:
            continue  # no spans on this rank's clock — idle is undefined
        covered = _union_len(ivals)
        wall = hi - lo
        idle_by_rank[str(r)] = {
            "wall_s": wall,
            "covered_s": covered,
            "idle_s": max(0.0, wall - covered),
        }
    return {
        "by_name": by_name,
        "total_wall_s": total_wall,
        "idle_by_rank": idle_by_rank,
    }


def render_span_section(spans: Dict, top_n: int = 8) -> List[str]:
    """The critical-path summary: top span time sinks by total time, then
    the per-rank idle gaps."""
    lines = ["", "span time attribution (top sinks)",
             "---------------------------------"]
    top = sorted(
        spans["by_name"].items(), key=lambda kv: -kv[1]["total_s"]
    )[:top_n]
    for name, s in top:
        share = (
            f"{100 * s['share']:5.1f}%" if s.get("share") is not None
            else "    -"
        )
        lines.append(
            f"  {name:<22} total {s['total_s'] * 1e3:9.1f} ms  "
            f"x{s['count']:<4} mean {s['mean_s'] * 1e3:7.1f} ms  "
            f"share {share}"
        )
    dropped = len(spans["by_name"]) - len(top)
    if dropped > 0:
        lines.append(f"  (+{dropped} more span name(s) below the top {top_n})")
    if spans["idle_by_rank"]:
        lines.append("  idle (wall not covered by any top-level span):")
        for r, g in spans["idle_by_rank"].items():
            pct = 100 * g["idle_s"] / g["wall_s"] if g["wall_s"] > 0 else 0.0
            lines.append(
                f"    rank {r}: {g['idle_s'] * 1e3:9.1f} ms of "
                f"{g['wall_s'] * 1e3:9.1f} ms wall ({pct:4.1f}%)"
            )
    return lines


def bucket_attribution(
    bandwidth: Optional[Dict], overlap: Optional[Dict]
) -> List[Dict]:
    """Per-bucket exposed-comm rows for DDP backward-order buckets
    (``ExactReducer(bucket_bytes=...)`` tags its ledger entries
    ``grads.b<i>``). Each row carries the bucket id, its wire bytes and
    chunk count, its share of the step's exposed comm budget, and an
    overlap fraction: how many of the bucket's collectives have backward
    compute scheduled behind them in the compiled module.

    The per-bucket overlap join is POSITIONAL: buckets are fence-chained in
    id order, so their collectives occupy the tail of the schedule's sync
    sequence in that order. It is only trusted when the schedule carries at
    least as many sync collectives as the buckets' total chunk count
    (``join: "positional"``); otherwise every bucket falls back to the
    run-level exposed fraction (``join: "global"``). The port's compile
    events carry no scheduled-collective extract, so a port run always
    takes the global join."""
    if not isinstance(bandwidth, dict):
        return []
    tagged = []
    for row in bandwidth.get("by_tag") or []:
        m = re.match(r"^grads\.b(\d+)$", str(row.get("tag") or ""))
        if m:
            tagged.append((int(m.group(1)), row))
    if not tagged:
        return []
    tagged.sort(key=lambda t: t[0])
    total_bytes = sum(float(r["payload_bytes"]) for _, r in tagged)
    counts = [max(1, int(r.get("count", 1))) for _, r in tagged]
    global_exposed = (bandwidth.get("attribution") or {}).get(
        "exposed_fraction", 1.0
    )
    sync = (overlap or {}).get("sync_collectives") or []
    positional = len(sync) >= sum(counts)
    rows = []
    cursor = len(sync) - sum(counts)  # buckets trail the loss sync
    for (bucket_id, row), count in zip(tagged, counts):
        if positional:
            ops = sync[cursor : cursor + count]
            cursor += count
            # a collective is overlapped when compute is scheduled in the
            # gap behind it; the schedule's final collective has no
            # successor gap and is always exposed (comm_attribution rule)
            overlapped = sum(
                1
                for op in ops
                if int(op.get("compute_ops_after") or 0) > 0
                and op is not sync[-1]
            )
            overlap_fraction = overlapped / count
            join = "positional"
        else:
            overlap_fraction = 1.0 - float(global_exposed)
            join = "global"
        payload = float(row["payload_bytes"])
        rows.append(
            {
                "bucket": bucket_id,
                "tag": row.get("tag"),
                "payload_bytes": payload,
                "count": count,
                "share_of_grads_bytes": (
                    payload / total_bytes if total_bytes else 0.0
                ),
                "overlap_fraction": overlap_fraction,
                "exposed_fraction": 1.0 - overlap_fraction,
                "comm_time_s": row.get("comm_time_s"),
                "join": join,
            }
        )
    return rows


def render_bucket_section(buckets: List[Dict]) -> List[str]:
    """The per-bucket exposed-comm table (empty list when the run had no
    backward-order buckets — the section is omitted entirely)."""
    if not buckets:
        return []
    lines = ["", "backward-bucket comm attribution",
             "-" * 42]
    for b in buckets:
        lines.append(
            f"  bucket {b['bucket']:<3} {_fmt_bytes(b['payload_bytes']):>12}"
            f"/step x{b['count']:<3} "
            f"overlap {b['overlap_fraction']:.2f} "
            f"(exposed {b['exposed_fraction']:.2f}, "
            f"{100 * b['share_of_grads_bytes']:.1f}% of grad bytes, "
            f"join: {b['join']})"
        )
    exposed_bytes = sum(
        b["payload_bytes"] * b["exposed_fraction"] for b in buckets
    )
    total = sum(b["payload_bytes"] for b in buckets)
    if total:
        lines.append(
            f"  exposed grad bytes {_fmt_bytes(exposed_bytes)}/step of "
            f"{_fmt_bytes(total)} ({100 * exposed_bytes / total:.1f}%)"
        )
    return lines


def render_mfu_section(mfu_records: List[Dict]) -> List[str]:
    """Per-phase MFU + roofline verdicts (already record() dicts)."""
    lines = ["", "mfu & roofline (steady-state)",
             "-----------------------------"]
    if not mfu_records:
        lines.append(
            "  no compile record carries a FLOPs count — run with audit"
            " enabled (or a bench tier) to populate the join"
        )
        return lines
    for m in mfu_records:
        mfu = f"{m['mfu']:.4f}" if m.get("mfu") is not None else "n/a"
        peak = m.get("peak_flops_per_s") or 0.0
        peak_txt = f" of {peak / 1e12:.1f} TF/s peak" if peak > 0 else ""
        exposed = m.get("exposed_comm_fraction")
        exp_txt = f", exposed comm {exposed:.2f}" if exposed is not None else ""
        lines.append(
            f"  {m.get('label', '?'):<16} mfu {mfu}{peak_txt}  "
            f"{m.get('flops_per_step', 0.0) / 1e9:8.2f} GF/step "
            f"({m.get('flops_source', '?')}) at "
            f"{m.get('step_time_s', 0.0) * 1e3:7.1f} ms/step"
            f" -> {m.get('bound', '?')}{exp_txt}"
        )
    return lines


def render_critpath_section(
    crit: Optional[Dict],
    matrix: Optional[Dict],
    clock_skew_bound_s: float = 0.0,
) -> List[str]:
    """The cross-rank critical-path section: per-rank and per-phase blame
    shares, the top gating edge, and the measured per-edge utilization
    table. Empty when the run carries no stepped, ranked spans."""
    if not isinstance(crit, dict):
        return []
    lines = ["", "critical path (cross-rank)",
             "--------------------------"]
    lines.append(
        f"  {crit['n_steps']} step(s) analyzed, collective-wait share of"
        f" the critical path {100 * crit['comm_share']:.1f}%"
        f" (merge tolerance +/- {clock_skew_bound_s * 1e3:.1f} ms)"
    )
    ranks = ", ".join(
        f"rank {r}: {100 * s:.1f}%"
        for r, s in crit["blame_by_rank"].items()
    )
    lines.append(f"  blame by rank   {ranks}")
    phases = ", ".join(
        f"{p}: {100 * s:.1f}%"
        for p, s in crit["blame_by_phase"].items()
    )
    lines.append(f"  blame by phase  {phases}")
    top = crit.get("top_edge")
    if top:
        lines.append(
            f"  top gating edge {top['src']} -> {top['dst']}"
            f" (gated {top['blamed_steps']} step(s) in collective-wait)"
        )
    if isinstance(matrix, dict):
        lines.append(
            f"  per-edge fabric matrix ({matrix.get('topology')},"
            f" {_fmt_bytes(matrix.get('per_step_edge_bytes', 0.0))}/step"
            f" per link):"
        )
        for row in fabric_mod.edge_utilization(matrix):
            util = "  ".join(
                f"{name} {100 * u:5.1f}%"
                for name, u in sorted(row["utilization"].items())
            )
            lines.append(
                f"    {row['src']} -> {row['dst']}  "
                f"{_fmt_rate(row['bytes_per_s']):>12}  "
                f"wait p50 {row['wait_s_p50'] * 1e3:7.2f} ms  util {util}"
            )
        b = matrix.get("bottleneck") or {}
        if b:
            lines.append(
                f"    bottleneck edge: {b.get('src')} -> {b.get('dst')}"
            )
    return lines


# the compile-time HBM footprint fields the memory join reads off the
# last CompileEvent (the port's audit leaves them None: its predicted peak
# is unavailable, and the peak is the MemoryEvent sampler's measured one)
_FOOTPRINT_KEYS = (
    "argument_bytes",
    "output_bytes",
    "temp_bytes",
    "generated_code_bytes",
    "peak_hbm_bytes",
)


def memory_summary(
    compile_events: List[Dict], memory_events: List[Dict]
) -> Dict:
    """The report's memory section: compile-time predicted peak joined
    with the live measured peak per rank. ALWAYS returns a section —
    a CPU run degrades to predicted-present / measured-unavailable, it
    never vanishes (the gate reads ``hbm_peak_bytes`` from here: measured
    when the sampler ran, predicted otherwise)."""
    predicted = None
    if compile_events:
        last = compile_events[-1]
        fields = {
            k: float(last[k])
            for k in _FOOTPRINT_KEYS
            if isinstance(last.get(k), (int, float))
        }
        if fields:
            predicted = fields
    per_rank: Dict[int, Dict] = {}
    for e in memory_events:
        r = e.get("rank")
        r = int(r) if isinstance(r, (int, float)) else -1
        cur = per_rank.setdefault(
            r,
            {
                "samples": 0,
                "last_bytes_in_use": None,
                "peak_bytes_in_use": None,
                "bytes_limit": None,
                "device_kind": "",
            },
        )
        cur["samples"] += 1
        in_use = e.get("bytes_in_use")
        if isinstance(in_use, (int, float)):
            cur["last_bytes_in_use"] = float(in_use)
        peak = e.get("peak_bytes_in_use")
        peak = peak if isinstance(peak, (int, float)) else in_use
        if isinstance(peak, (int, float)):
            cur["peak_bytes_in_use"] = max(
                cur["peak_bytes_in_use"] or 0.0, float(peak)
            )
        limit = e.get("bytes_limit")
        if isinstance(limit, (int, float)):
            cur["bytes_limit"] = float(limit)
        if e.get("device_kind"):
            cur["device_kind"] = str(e["device_kind"])
    measured = None
    if per_rank:
        peaks = [
            v["peak_bytes_in_use"]
            for v in per_rank.values()
            if v["peak_bytes_in_use"] is not None
        ]
        limits = [
            v["bytes_limit"]
            for v in per_rank.values()
            if v["bytes_limit"] is not None
        ]
        peak = max(peaks) if peaks else None
        limit = max(limits) if limits else None
        measured = {
            "per_rank": {str(r): per_rank[r] for r in sorted(per_rank)},
            "peak_bytes_in_use": peak,
            "bytes_limit": limit,
            "headroom_frac": (
                1.0 - peak / limit if peak is not None and limit else None
            ),
        }
    hbm_peak = (
        measured["peak_bytes_in_use"]
        if measured and measured["peak_bytes_in_use"] is not None
        else (predicted or {}).get("peak_hbm_bytes")
    )
    return {
        "predicted": predicted,
        "measured": measured,
        "measured_available": measured is not None,
        "hbm_peak_bytes": hbm_peak,
        "hbm_peak_source": (
            "measured" if measured else ("predicted" if predicted else None)
        ),
    }


def render_memory_section(memory: Dict) -> List[str]:
    """The human face of :func:`memory_summary` — rendered even when both
    planes are empty, so a missing memory plane is visible, not silent."""
    lines = ["", "memory", "------"]
    predicted = memory.get("predicted")
    if predicted:
        split = ", ".join(
            f"{k[: -len('_bytes')]} {_fmt_bytes(predicted[k])}"
            for k in _FOOTPRINT_KEYS[:-1]
            if predicted.get(k) is not None
        )
        peak = predicted.get("peak_hbm_bytes")
        lines.append(
            "  predicted peak (compile-time footprint): "
            + (_fmt_bytes(peak) if peak is not None else "n/a")
            + (f"  ({split})" if split else "")
        )
    else:
        lines.append(
            "  predicted peak: unavailable (backend exposes no"
            " memory_analysis)"
        )
    measured = memory.get("measured")
    if measured:
        for r, v in sorted(
            measured["per_rank"].items(), key=lambda kv: int(kv[0])
        ):
            peak = v.get("peak_bytes_in_use")
            limit = v.get("bytes_limit")
            frac = (
                f"  ({100 * peak / limit:.1f}% of"
                f" {_fmt_bytes(limit)} limit)"
                if peak is not None and limit
                else ""
            )
            lines.append(
                f"  rank {r}: peak "
                + (_fmt_bytes(peak) if peak is not None else "n/a")
                + f" over {v.get('samples', 0)} samples"
                + (f" on {v['device_kind']}" if v.get("device_kind") else "")
                + frac
            )
        hf = measured.get("headroom_frac")
        if hf is not None:
            lines.append(f"  headroom at peak: {100 * hf:.1f}%")
    else:
        lines.append(
            "  measured: unavailable (no memory_stats on this backend —"
            " the sampler no-ops on CPU)"
        )
    src = memory.get("hbm_peak_source")
    peak = memory.get("hbm_peak_bytes")
    if peak is not None:
        lines.append(
            f"  hbm_peak_bytes (gate scalar): {_fmt_bytes(peak)} [{src}]"
        )
    return lines


def render_fidelity_section(fid: Optional[Dict]) -> List[str]:
    """The gradient-fidelity table: one row per shape group / bucket with
    its wire-ledger tag, mean/max relative error, worst cosine similarity,
    and EF-memory high-water marks — blame lands on ``worst_group``, the
    same key the live ``fidelity_collapse`` alert names. Empty when the
    run emitted no fidelity samples (exact runs still emit zeros, so an
    absent section means the probe never ran, not that fidelity was
    perfect)."""
    if not fid or not fid.get("samples"):
        return []
    lines = ["", "gradient fidelity (per shape group / bucket)",
             "-" * 44]
    lines.append(
        f"  {'group':<26} {'ledger tag':<16} {'mean err':>9} {'max err':>9}"
        f" {'min cos':>8} {'max EF':>9} {'quantized':>9}"
    )
    for name in sorted(fid["groups"]):
        g = fid["groups"][name]
        lines.append(
            f"  {name:<26} {g['tag']:<16} {g['mean_rel_error']:>9.4g}"
            f" {g['max_rel_error']:>9.4g} {g['min_cosine_sim']:>8.4f}"
            f" {g['max_ef_norm']:>9.4g}"
            f" {100 * g['quantized_share']:>8.1f}%"
        )
    worst = fid.get("worst_group")
    if worst:
        lines.append(
            f"  worst group: {worst} (mean rel error"
            f" {fid['rel_error']:.4g} — the gate's fidelity_rel_error,"
            " lower = better)"
        )
    rd, ad = fid.get("replica_drift") or {}, fid.get("anchor_drift") or {}
    if rd.get("max") or ad.get("max"):
        lines.append(
            f"  replica drift last {rd.get('last', 0.0):.4g} / max"
            f" {rd.get('max', 0.0):.4g}; anchor drift last"
            f" {ad.get('last', 0.0):.4g} / max {ad.get('max', 0.0):.4g}"
        )
    return lines


def render_frontier_section(frontier: Optional[Dict]) -> List[str]:
    """The accuracy-per-byte frontier: per-rung loss bought per wire byte
    spent (empty when the run logged no steps)."""
    if not frontier or not frontier.get("rungs"):
        return []
    lines = ["", "accuracy-per-byte frontier (loss vs ledger bytes by rung)",
             "-" * 57]
    for r in frontier["rungs"]:
        lines.append(
            f"  {r['rung']:<12} steps {r['start_step']:>4}-{r['end_step']:<4}"
            f" loss {r['loss_start']:.4f} -> {r['loss_end']:.4f}"
            f"  {_fmt_bytes(r['bytes']):>12}"
            f"  {r['loss_drop_per_gb']:+.3f} loss/GB"
        )
    lines.append(
        f"  total {_fmt_bytes(frontier['total_bytes'])} wire ->"
        f" final loss {frontier['final_loss']:.4f}"
        f" over {frontier['steps']} step(s)"
    )
    return lines


# Chrome-trace lanes, one pid per rank (Perfetto renders pid -1, the
# supervisor, as its own process track)
_TID_SPANS, _TID_STEPS, _TID_COLLECTIVES, _TID_FAILURES = 0, 1, 2, 3
_TID_MEMORY = 4
_TID_FIDELITY = 5


def chrome_trace(events: List[Dict]) -> Dict:
    """The merged timeline as Chrome-trace JSON (Perfetto /
    ``chrome://tracing``): spans and steps as complete ("X") events with
    microsecond timestamps relative to the earliest event, collectives and
    failures as instants, one process per rank."""
    timed = [e for e in events if isinstance(e.get("t_run"), (int, float))]
    if not timed:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(
        e["t_run"] - (
            e["dur_s"]
            if e.get("event") == "span"
            and isinstance(e.get("dur_s"), (int, float))
            else 0.0
        )
        for e in timed
    )

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    trace_events: List[Dict] = []
    pids: Dict[int, str] = {}
    for e in timed:
        rank = e.get("rank")
        pid = int(rank) if rank is not None else -1
        kind = e.get("event")
        if kind == "span" and isinstance(e.get("dur_s"), (int, float)):
            pids[pid] = "supervisor" if pid < 0 else f"rank {pid}"
            trace_events.append({
                "ph": "X", "cat": "span", "name": e.get("name", "span"),
                "pid": pid, "tid": _TID_SPANS,
                "ts": us(e["t_run"] - e["dur_s"]),
                "dur": round(e["dur_s"] * 1e6, 3),
                "args": {
                    k: e.get(k)
                    for k in ("span_id", "parent_id", "depth", "step")
                    if e.get(k) is not None
                },
            })
        elif kind == "step" and isinstance(e.get("step_time_s"), (int, float)):
            pids[pid] = "supervisor" if pid < 0 else f"rank {pid}"
            trace_events.append({
                "ph": "X", "cat": "step", "name": f"step {e.get('step')}",
                "pid": pid, "tid": _TID_STEPS,
                "ts": us(e["t_run"] - e["step_time_s"]),
                "dur": round(e["step_time_s"] * 1e6, 3),
                "args": {"loss": e.get("loss")},
            })
        elif kind == "collective":
            pids[pid] = "supervisor" if pid < 0 else f"rank {pid}"
            trace_events.append({
                "ph": "i", "s": "t", "cat": "collective",
                "name": f"{e.get('tag', '?')} ({e.get('op', '?')})",
                "pid": pid, "tid": _TID_COLLECTIVES, "ts": us(e["t_run"]),
                "args": {
                    "payload_bytes": e.get("payload_bytes"),
                    "layer": e.get("layer"),
                },
            })
        elif kind == "failure":
            pids[pid] = "supervisor" if pid < 0 else f"rank {pid}"
            trace_events.append({
                "ph": "i", "s": "t", "cat": "failure",
                "name": e.get("kind", "failure"),
                "pid": pid, "tid": _TID_FAILURES, "ts": us(e["t_run"]),
                "args": {"message": e.get("message")},
            })
        elif kind == "memory" and isinstance(
            e.get("bytes_in_use"), (int, float)
        ):
            # a Perfetto counter track per rank: device bytes in use over
            # run time (the limit rides along as a second series so the
            # headroom squeeze is visible on the same track)
            pids[pid] = "supervisor" if pid < 0 else f"rank {pid}"
            args = {"bytes_in_use": e["bytes_in_use"]}
            if isinstance(e.get("bytes_limit"), (int, float)):
                args["bytes_limit"] = e["bytes_limit"]
            trace_events.append({
                "ph": "C", "cat": "memory", "name": "HBM bytes",
                "pid": pid, "tid": _TID_MEMORY, "ts": us(e["t_run"]),
                "args": args,
            })
        elif kind == "fidelity" and isinstance(
            e.get("rel_error"), (int, float)
        ):
            # one Perfetto counter track per fidelity group: relative
            # compression error (and EF norm) over run time — the visual
            # twin of the report's fidelity table, so a degraded bucket
            # is a visible step change on its own track
            pids[pid] = "supervisor" if pid < 0 else f"rank {pid}"
            args = {"rel_error": e["rel_error"]}
            if isinstance(e.get("ef_norm"), (int, float)):
                args["ef_norm"] = e["ef_norm"]
            trace_events.append({
                "ph": "C", "cat": "fidelity",
                "name": f"fidelity {e.get('group', '?')}",
                "pid": pid, "tid": _TID_FIDELITY, "ts": us(e["t_run"]),
                "args": args,
            })
    # Perfetto flow arrows across rank tracks at each collective: every
    # step's exposed-comm slices are ring-chained rank r -> rank r+1 (the
    # same (src, dst) charging the fabric matrix uses), so the UI draws
    # the cross-rank synchronization edge the critical-path analyzer
    # reasons about. A flow phase must carry a ts INSIDE the slice it
    # binds to — the midpoint is used.
    comm_mid: Dict[Tuple[int, int], float] = {}
    for e in timed:
        if (
            e.get("event") == "span"
            and isinstance(e.get("dur_s"), (int, float))
            and "comm" in str(e.get("name") or "")
            and e.get("rank") is not None
            and e.get("step") is not None
        ):
            comm_mid[(int(e["step"]), int(e["rank"]))] = us(
                e["t_run"] - e["dur_s"] / 2.0
            )
    steps_seen: Dict[int, List[int]] = {}
    for step, rank in comm_mid:
        steps_seen.setdefault(step, []).append(rank)
    for step, ranks in sorted(steps_seen.items()):
        ranks = sorted(ranks)
        if len(ranks) < 2:
            continue
        for k, src in enumerate(ranks):
            dst = ranks[(k + 1) % len(ranks)]
            flow_id = f"step{step}:{src}->{dst}"
            common = {
                "cat": "collective-flow",
                "name": f"step {step} sync",
                "id": flow_id,
                "tid": _TID_SPANS,
            }
            trace_events.append({
                "ph": "s", "pid": src, "ts": comm_mid[(step, src)], **common,
            })
            trace_events.append({
                "ph": "f", "bp": "e", "pid": dst,
                "ts": comm_mid[(step, dst)], **common,
            })

    meta: List[Dict] = []
    for pid, name in sorted(pids.items()):
        meta.append({
            "ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": name},
        })
        for tid, tname in (
            (_TID_SPANS, "spans"), (_TID_STEPS, "steps"),
            (_TID_COLLECTIVES, "collectives"), (_TID_FAILURES, "failures"),
            (_TID_MEMORY, "memory"), (_TID_FIDELITY, "fidelity"),
        ):
            meta.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": tname},
            })
    return {"traceEvents": meta + trace_events, "displayTimeUnit": "ms"}


def run_report(
    run_dir: str,
    straggler_factor: float = 1.5,
    trace_out: Optional[str] = None,
) -> Tuple[str, Dict]:
    """The multi-rank run report: merge the run directory's shards, run
    the analytics (including the span time-attribution summary and the
    MFU/roofline join), and return (text, machine-readable report dict).
    ``trace_out`` additionally writes the merged timeline as Chrome-trace
    JSON there."""
    merged = runlog.merge_run(run_dir)
    stats = analytics.rank_step_stats(merged.events)
    stragglers = analytics.detect_stragglers(stats, factor=straggler_factor)
    p50s = [s["p50_s"] for s in stats.values() if s["n"]]
    step_p50 = analytics.percentile(p50s, 50) if p50s else None
    step_p95 = (
        analytics.percentile(
            [s["p95_s"] for s in stats.values() if s["n"]], 50
        )
        if p50s else None
    )
    compile_events = [e for e in merged.events if e.get("event") == "compile"]
    overlap = next((e.get("overlap") for e in compile_events), None)
    collectives = [e for e in merged.events if e.get("event") == "collective"]
    bandwidth = (
        analytics.effective_bandwidth(
            step_p50, collectives, merged.manifest.world_size, overlap=overlap
        )
        if collectives and step_p50
        else None
    )

    # the MFU join: compile-time FLOPs records x measured steady-state p50
    n_steps = sum(s["n"] for s in stats.values())
    mfu_records = [
        ev.record()
        for ev in mfu_mod.mfu_from_compile_records(
            compile_events,
            step_p50,
            n_steps=n_steps,
        )
    ]
    mfus = [m["mfu"] for m in mfu_records if m.get("mfu") is not None]
    spans = span_summary(merged.events)

    # the cross-rank critical path and the measured per-edge matrix
    crit = critpath.analyze(merged.events, merged.manifest.world_size)
    matrix = fabric_mod.measure_fabric_matrix(
        merged.events, merged.manifest.world_size
    )
    straggler_records = [ev.record() for ev in stragglers]
    if crit:
        # join the straggler verdicts against the blame attribution: a
        # flagged rank carries the phase (and, for collective-wait, the
        # ring edge) its critical-path excess sat in
        by_rank: Dict[int, List[Dict]] = {}
        for ev in crit["events"]:
            by_rank.setdefault(int(ev["rank"]), []).append(ev)
        for rec in straggler_records:
            blamed = by_rank.get(int(rec.get("rank", -1))) or []
            if not blamed:
                continue
            phases = [e["phase"] for e in blamed]
            rec["blamed_phase"] = max(set(phases), key=phases.count)
            edges = [
                (e["edge_src"], e["edge_dst"])
                for e in blamed if e.get("edge_src") is not None
            ]
            if rec["blamed_phase"] == "collective-wait" and edges:
                src, dst = max(set(edges), key=edges.count)
                rec["blamed_edge"] = {"src": src, "dst": dst}

    sections = render_run_sections(
        merged, stats, stragglers, bandwidth, straggler_factor
    )
    sections.extend(
        render_critpath_section(
            crit, matrix, clock_skew_bound_s=merged.clock_skew_bound_s
        )
    )
    sections.extend(render_mfu_section(mfu_records))
    memory_events = [e for e in merged.events if e.get("event") == "memory"]
    memory = memory_summary(compile_events, memory_events)
    sections.extend(render_memory_section(memory))
    comm_buckets = bucket_attribution(bandwidth, overlap)
    sections.extend(render_bucket_section(comm_buckets))

    # the gradient-fidelity plane: per-group compression audit joined
    # against the wire ledger's tags, plus the accuracy-per-byte frontier
    # (loss bought per ledger byte, segmented by fallback-ladder rung)
    fid = fidelity_mod.fidelity_summary(merged.events)
    frontier = fidelity_mod.frontier_from_events(merged.events)
    sections.extend(render_fidelity_section(fid))
    sections.extend(render_frontier_section(frontier))

    hierarchy = hierarchy_summary(bandwidth)
    sections.extend(render_hierarchy_section(hierarchy))
    partitions = partition_summary(merged.events)
    sections.extend(render_partition_section(partitions))
    sections.extend(
        render_alert_section(
            [e for e in merged.events if e.get("event") == "alert"]
        )
    )
    # the span attribution section itself renders inside render_report
    # (shared with the single-file mode); here we only keep the summary
    # for the machine-readable report dict
    if trace_out:
        trace = chrome_trace(merged.events)
        parent = os.path.dirname(trace_out)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(trace_out, "w") as f:
            json.dump(trace, f)
        sections.append("")
        sections.append(
            f"trace: {len(trace['traceEvents'])} events ->"
            f" {trace_out} (open in Perfetto / chrome://tracing)"
        )

    text = (
        render_report(merged.events, name=run_dir, skipped_lines=merged.torn_lines)
        .rstrip("\n") + "\n" + "\n".join(sections) + "\n"
    )

    failures = [e for e in merged.events if e.get("event") == "failure"]
    deaths = _death_counts(failures)
    incidents = recovery_incidents(merged.events)
    mttr = mttr_s(incidents)
    policies = [e for e in merged.events if e.get("event") == "policy"]
    alert_events = [e for e in merged.events if e.get("event") == "alert"]
    alerts_by_kind: Dict[str, int] = {}
    for a in alert_events:
        k = str(a.get("alert", "?"))
        alerts_by_kind[k] = alerts_by_kind.get(k, 0) + 1
    report = {
        "schema": 1,
        "run_dir": os.path.abspath(run_dir),
        "run_id": merged.manifest.run_id,
        "world_size": merged.manifest.world_size,
        "generated_unix": time.time(),
        "n_events": len(merged.events),
        "torn_lines": merged.torn_lines,
        "startup_s": merged.startup_s,
        "ranks": {
            str(r): {**merged.per_rank[r], **stats.get(r, {})}
            for r in sorted(merged.per_rank)
        },
        "step_p50_s": step_p50,
        "step_p95_s": step_p95,
        "step_skew": (
            max(p50s) / step_p50 if p50s and step_p50 and step_p50 > 0 else None
        ),
        "straggler_factor": straggler_factor,
        "stragglers": straggler_records,
        "bandwidth": bandwidth,
        # the cross-rank critical path (None when the run has no stepped
        # spans) — the gate's critpath_comm_share lives at
        # critpath.comm_share; timings inherit clock_skew_bound_s
        "critpath": crit,
        "clock_skew_bound_s": merged.clock_skew_bound_s,
        # the measured per-edge matrix (also persisted next to --json-out
        # as fabric_matrix.json for scripts/torch_plan.py to read)
        "fabric_matrix": matrix,
        # the wire-ledger compile extract (LAST compile event = the config
        # the run finished on): analytic bytes, compression evidence, and
        # the comm-config knobs the step compiled with — what the offline
        # cost model (observe.costmodel) calibrates from and joins its
        # predictions against
        "compile": (
            {
                "analytic_bytes": compile_events[-1].get("analytic_bytes"),
                "dense_grad_bytes": compile_events[-1].get("dense_grad_bytes"),
                "compression_ratio": compile_events[-1].get("compression_ratio"),
                "comm_config": compile_events[-1].get("comm_config") or {},
                "n_compiles": len(compile_events),
            }
            if compile_events else None
        ),
        # per-bucket exposed-comm attribution (DDP backward-order buckets;
        # empty when the run used a monolithic packed collective)
        "comm_buckets": comm_buckets,
        # two-level reduction: wire bytes per level from the outer.* /
        # inner.* ledger tags (None for flat runs) — the cross-site
        # shrinkage claim joins hierarchy.outer_bytes_per_step against
        # the plan's predicted_outer_bytes_per_step
        "hierarchy": hierarchy,
        # typed cross-site partition timeline (None when never
        # partitioned): degradation to site-local training, divergence
        # budget charged, rejoin
        "partitions": partitions,
        "mfu": mfu_records,
        # the gate's scalar: the best steady-state MFU across phases
        # (higher = better; a regression means the run got less efficient)
        "mfu_headline": max(mfus) if mfus else None,
        "spans": spans,
        "failures": {
            **deaths,
            "restarts": sum(
                1 for f in failures if f.get("kind") == "worker_restart"
            ),
            "reshapes": len(incidents),
        },
        "policy": {
            "decisions": policies,
            "descends": sum(
                1 for p in policies if p.get("action") == "descend"
            ),
            "ascends": sum(1 for p in policies if p.get("action") == "ascend"),
            "final_rung": (
                sorted(
                    policies,
                    key=lambda p: (
                        _event_time(p) is None, _event_time(p) or 0.0
                    ),
                )[-1].get("rung_after")
                if policies else None
            ),
        },
        # the live plane's verdicts (always present, even when zero fired,
        # so the gate can extract alerts_fired from every run)
        "alerts": {
            "fired": len(alert_events),
            "by_kind": alerts_by_kind,
            "criticals": sum(
                1 for a in alert_events if a.get("severity") == "critical"
            ),
            "records": alert_events,
        },
        "data_drops": data_drop_summary(merged.events),
        # the gate's recovery scalar: wall seconds from the first injected
        # comm fault to the first clean step (lower = faster heal)
        "recovery_latency_s": recovery_latency_s(merged.events),
        # disaster-recovery incidents: one per supervisor mesh replan,
        # clocked hard-death -> first post-replan step; the gate's MTTR
        # scalar (lower = faster game-day recovery)
        "recovery": {"incidents": incidents, "mttr_s": mttr},
        "recovery_time_s": mttr,
        # per-request serving SLOs (None when the run served nothing);
        # the gate's serving scalar is slo.p99_decode_ms_per_token
        "slo": slo_summary_from_events(merged.events),
        # paged-KV block-pool memory (None when the run never served
        # paged): pool bytes, blocks free, prefix-shared share, COW/defer
        # counters — the serving entry in the memory observatory
        "kv_pool": kv_pool_summary_from_events(merged.events),
        # fleet control-plane aggregate (None when the run scheduled no
        # jobs); the gate's fleet scalar is fleet.goodput (higher = better)
        "fleet": fleet_summary_from_events(merged.events),
        # the memory observatory's join: compile-time predicted peak vs
        # the live sampler's measured peak per rank — ALWAYS present (a
        # CPU run keeps predicted and marks measured unavailable); the
        # gate's scalar is memory.hbm_peak_bytes (lower = leaner)
        "memory": memory,
        # the gradient-fidelity audit (None when the probe never sampled):
        # per-group compression error keyed by the SAME shape-group /
        # bucket keys the wire ledger prices; the gate's scalar is
        # fidelity.rel_error — the worst group's mean relative error
        # (lower = higher fidelity)
        "fidelity": fid if fid.get("samples") else None,
        # the accuracy-per-byte frontier: loss trajectory joined against
        # cumulative ledger bytes per fallback-ladder rung (also persisted
        # next to --json-out as fidelity_frontier.json)
        "fidelity_frontier": frontier if frontier.get("steps") else None,
    }
    return text, report


def _compare_metric(report: Dict, dotted: str) -> Optional[float]:
    """Pull one (possibly nested) scalar out of a report dict."""
    node = report
    for part in dotted.split("."):
        if not isinstance(node, dict):
            return None
        node = node.get(part)
    return float(node) if isinstance(node, (int, float)) and node == node else None


# what --compare diffs, in display order: (dotted key, label, formatter)
_COMPARE_ROWS = (
    ("step_p50_s", "step p50", lambda v: f"{v * 1e3:.2f} ms"),
    ("step_p95_s", "step p95", lambda v: f"{v * 1e3:.2f} ms"),
    ("bandwidth.total.payload_bytes", "bytes/step", _fmt_bytes),
    ("bandwidth.total.achieved_bytes_per_s", "achieved bw", _fmt_rate),
    ("mfu_headline", "MFU headline", lambda v: f"{v:.4f}"),
    ("memory.hbm_peak_bytes", "HBM peak", _fmt_bytes),
    ("fidelity.rel_error", "fidelity rel err", lambda v: f"{v:.4g}"),
    ("alerts.fired", "alerts fired", lambda v: f"{v:.0f}"),
    ("policy.descends", "policy descends", lambda v: f"{v:.0f}"),
    ("recovery_latency_s", "recovery latency", lambda v: f"{v:.2f} s"),
    ("fleet.goodput", "fleet goodput", lambda v: f"{v:.4f}/chip-s"),
)
_COMPARE_TOP_SPANS = 5


def compare_runs(
    run_a: str, run_b: str, straggler_factor: float = 1.5
) -> Tuple[str, Dict]:
    """Side-by-side diff of two run directories — the manual workflow
    behind every "did PR N help?" question, reusing the same run-dir
    loaders as the single-run report. Returns (text, machine dict)."""
    _, rep_a = run_report(run_a, straggler_factor=straggler_factor)
    _, rep_b = run_report(run_b, straggler_factor=straggler_factor)

    metrics: Dict[str, Dict] = {}
    lines = [
        "run compare",
        f"  A: {run_a}",
        f"  B: {run_b}",
        "",
        f"  {'metric':<18} {'A':>14} {'B':>14} {'B/A':>8}",
    ]
    for dotted, label, fmt in _COMPARE_ROWS:
        a, b = _compare_metric(rep_a, dotted), _compare_metric(rep_b, dotted)
        if a is None and b is None:
            continue
        metrics[dotted] = {
            "a": a,
            "b": b,
            "ratio": (b / a) if a and b is not None else None,
        }
        ratio = metrics[dotted]["ratio"]
        lines.append(
            f"  {label:<18} {fmt(a) if a is not None else 'n/a':>14}"
            f" {fmt(b) if b is not None else 'n/a':>14}"
            f" {f'{ratio:.2f}x' if ratio is not None else 'n/a':>8}"
        )

    # top span shares: the union of each side's biggest time sinks, so a
    # sink that newly appeared in B still shows up against A's 0
    def _shares(rep: Dict) -> Dict[str, float]:
        spans = rep.get("spans") or {}
        out = {}
        for name, slot in (spans.get("by_name") or {}).items():
            share = slot.get("share") if isinstance(slot, dict) else None
            if isinstance(share, (int, float)) and share == share:
                out[str(name)] = float(share)
        return out

    sh_a, sh_b = _shares(rep_a), _shares(rep_b)
    top = sorted(
        set(sorted(sh_a, key=sh_a.get, reverse=True)[:_COMPARE_TOP_SPANS])
        | set(sorted(sh_b, key=sh_b.get, reverse=True)[:_COMPARE_TOP_SPANS]),
        key=lambda n: max(sh_a.get(n, 0.0), sh_b.get(n, 0.0)),
        reverse=True,
    )
    spans_out: Dict[str, Dict] = {}
    if top:
        lines.append("")
        lines.append(f"  {'span share':<18} {'A':>14} {'B':>14} {'B-A':>8}")
        for name in top:
            a, b = sh_a.get(name, 0.0), sh_b.get(name, 0.0)
            spans_out[name] = {"a": a, "b": b, "delta": b - a}
            lines.append(
                f"  {name:<18} {a:>13.1%} {b:>13.1%} {b - a:>+8.3f}"
            )

    doc = {
        "schema": 1,
        "a": {"run_dir": rep_a.get("run_dir"), "run_id": rep_a.get("run_id")},
        "b": {"run_dir": rep_b.get("run_dir"), "run_id": rep_b.get("run_id")},
        "metrics": metrics,
        "span_shares": spans_out,
    }
    return "\n".join(lines) + "\n", doc


def _label_value(label_str: str, key: str) -> str:
    """Pull one label's value out of a rendered ``{k="v",...}`` string
    (the registry snapshot's key format)."""
    marker = f'{key}="'
    i = label_str.find(marker)
    if i < 0:
        return label_str
    j = label_str.find('"', i + len(marker))
    return label_str[i + len(marker):j] if j > 0 else label_str


def render_watch_frame(agg, run_dir: str = "") -> str:
    """One dashboard frame off a ``LiveAggregator``: step rate, per-fabric
    utilization, the alert feed, and the serving SLO tiles."""
    reg = agg.registry
    snap = reg.snapshot()
    lines: List[str] = []
    header = f"live: {run_dir or agg.run_dir}"
    port = read_port_file(agg.run_dir)
    if port:
        header += f"   /metrics on 127.0.0.1:{port}"
    lines.append(header)
    lines.append("=" * len(header))

    steps = sum(
        v for v in snap.get("live_steps_total", {}).values()
        if isinstance(v, (int, float))
    )
    rate = reg.get_gauge("live_step_rate_per_s")
    p50 = reg.get_gauge("live_step_time_p50_seconds")
    p99 = reg.get_gauge("live_step_time_p99_seconds")
    lines.append(
        "  steps   "
        f"{int(steps):>8}   "
        + (f"rate {rate:6.2f}/s   " if rate is not None else "rate      -   ")
        + (f"p50 {p50 * 1e3:8.1f} ms   " if p50 is not None else "p50        -   ")
        + (f"p99 {p99 * 1e3:8.1f} ms" if p99 is not None else "p99        -")
    )
    bps = reg.get_gauge("live_comm_bytes_per_s")
    if bps is not None:
        utils = [
            f"{_label_value(lbl, 'fabric')} {100 * v:5.1f}%"
            for lbl, v in sorted(
                snap.get("live_fabric_utilization", {}).items()
            )
            if isinstance(v, (int, float))
        ]
        lines.append(
            f"  comm    {_fmt_rate(bps):>10}   util " + "  ".join(utils)
        )
    edges = snap.get("live_edge_bytes_per_s", {})
    if edges:
        tiles = "  ".join(
            f"{_label_value(lbl, 'edge')} {_fmt_rate(v)}"
            for lbl, v in sorted(edges.items())
            if isinstance(v, (int, float))
        )
        lines.append(f"  edges   {tiles}")
    gn = snap.get("live_grad_norm", {})
    if gn:
        tiles = "   ".join(
            f"rank {_label_value(lbl, 'rank')}: {v:.4g}"
            for lbl, v in sorted(gn.items())
            if isinstance(v, (int, float))
        )
        lines.append(f"  grad ‖g‖ {tiles}")

    served = snap.get("live_serving_requests_total", {})
    if served:
        states = "  ".join(
            f"{_label_value(lbl, 'state')}={int(v)}"
            for lbl, v in sorted(served.items())
            if isinstance(v, (int, float))
        )
        row = f"  serving {states}"
        sp99 = reg.get_gauge("live_serving_p99_total_seconds")
        if sp99 is not None:
            row += f"   p99 total {sp99 * 1e3:.0f} ms"
        tok = reg.get_histogram("live_serving_decode_ms_per_token")
        if tok is not None and len(tok):
            row += f"   decode {tok.percentile(50):.1f} ms/token"
        lines.append(row)

    lines.append("")
    lines.append(f"  alerts fired: {len(agg.alerts)}")
    for a in agg.alerts[-8:]:
        lines.append(
            f"    {a.alert:<20} {a.severity:<8} value {a.value:.4g}"
            + (f"  rank {a.rank}" if a.rank is not None else "")
        )
    torn = reg.get_gauge("live_torn_lines_total")
    if torn:
        lines.append(f"  torn shard lines: {int(torn)}")
    return "\n".join(lines) + "\n"


def watch_run(
    run_dir: str,
    interval: float = 1.0,
    iterations: int = 0,
    out=None,
) -> int:
    """``--watch``: poll the run directory's shards through a
    ``LiveAggregator`` and redraw the dashboard in place (ANSI
    clear-and-home on a tty, plain append otherwise). ``iterations=0``
    runs until the user interrupts; a positive bound exists for tests."""
    out = out or sys.stdout
    agg = LiveAggregator(run_dir)
    n = 0
    try:
        while True:
            n += 1
            agg.poll()
            frame = render_watch_frame(agg, run_dir)
            if out.isatty():
                out.write("\x1b[H\x1b[2J")
            out.write(frame)
            out.flush()
            if iterations and n >= iterations:
                return 0
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def join_plan(report: Dict, plan: Dict, fabric: Optional[str] = None) -> Tuple[Optional[Dict], str]:
    """The ``costmodel`` section: ``plan``'s prediction for ``fabric`` (the
    plan's only fabric when None) joined with the realized run, and its
    text line. Raises ``ValueError`` when the fabric is ambiguous."""
    fabrics = sorted(plan.get("fabrics") or {})
    fabric = fabric or (fabrics[0] if len(fabrics) == 1 else None)
    if fabric is None:
        raise ValueError(f"the plan has {len(fabrics)} fabrics; pick one with --plan-fabric")
    joined = costmodel.join_realized(plan, fabric, report)
    if joined is None:
        return None, ""
    pred = joined.get("predicted_step_s")
    if pred is None:
        return joined, f"\ncostmodel [{fabric}] {joined['config_key']}: no matching prediction in the plan\n"
    return joined, (
        f"\ncostmodel [{fabric}] {joined['config_key']}: predicted {pred * 1e3:.2f} ms vs realized"
        f" {joined['realized_step_s'] * 1e3:.2f} ms ({joined.get('error', 0.0):.1%} error)\n"
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("logs", nargs="*", help="telemetry JSONL file(s)")
    parser.add_argument(
        "--run-dir", default=None,
        help="merge a supervised run directory (manifest + per-rank shards)"
             " into one multi-rank report",
    )
    parser.add_argument(
        "--json-out", default=None,
        help="run-dir mode: write the machine-readable report here"
             " (default artifacts/run_report.json)",
    )
    parser.add_argument(
        "--straggler-factor", type=float, default=1.5,
        help="flag ranks whose p50 step time exceeds the cross-rank median"
             " by this factor",
    )
    parser.add_argument(
        "--trace-out", default=None,
        help="run-dir mode: export the merged timeline as Chrome-trace"
             " JSON here (open in Perfetto / chrome://tracing)",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="emit the aggregated per-kind event counts (or the run-dir"
             " report dict) as JSON instead of text",
    )
    parser.add_argument(
        "--watch", action="store_true",
        help="run-dir mode: live terminal dashboard — tail the run's shards"
             " through the streaming aggregator and refresh step rate,"
             " per-fabric utilization, the alert feed, and the serving SLO"
             " tiles in place (Ctrl-C to stop)",
    )
    parser.add_argument(
        "--interval", type=float, default=1.0,
        help="--watch: seconds between dashboard refreshes",
    )
    parser.add_argument(
        "--watch-iterations", type=int, default=0,
        help="--watch: stop after this many refreshes (0 = until"
             " interrupted; a bound exists for tests/CI)",
    )
    parser.add_argument(
        "--compare", nargs=2, metavar=("RUN_A", "RUN_B"), default=None,
        help="side-by-side diff of two run directories (step p50,"
             " bytes/step, MFU headline, top span shares, alert counts)",
    )
    parser.add_argument(
        "--plan", default=None,
        help="run-dir mode: join this scripts/torch_plan.py plan file against"
             " the realized run — adds the 'costmodel' section"
             " (predicted-vs-realized step time, the gate's"
             " costmodel_error) to the report",
    )
    parser.add_argument(
        "--plan-fabric", default=None,
        help="--plan: which fabric's predictions to join (default: the"
             " plan's only fabric, else required)",
    )
    args = parser.parse_args(argv)
    if args.compare:
        text, doc = compare_runs(
            args.compare[0], args.compare[1],
            straggler_factor=args.straggler_factor,
        )
        sys.stdout.write(json.dumps(doc) + "\n" if args.json else text)
        return 0
    if not args.logs and not args.run_dir:
        parser.error("need JSONL file(s), --run-dir, or --compare")
    if args.watch:
        if not args.run_dir:
            parser.error("--watch requires --run-dir")
        return watch_run(
            args.run_dir,
            interval=args.interval,
            iterations=args.watch_iterations,
        )

    if args.run_dir:
        text, report = run_report(
            args.run_dir,
            straggler_factor=args.straggler_factor,
            trace_out=args.trace_out,
        )
        if args.plan:
            plan = load_plan(args.plan)
            if plan is None:
                parser.error(f"--plan {args.plan}: not a readable plan JSON")
            try:
                report["costmodel"], line = join_plan(report, plan, args.plan_fabric)
            except ValueError as e:
                parser.error(f"--plan: {e}")
            text += line
        if args.json:
            sys.stdout.write(json.dumps(report) + "\n")
        else:
            sys.stdout.write(text)
        json_out = args.json_out or os.path.join("artifacts", "run_report.json")
        parent = os.path.dirname(json_out)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(json_out, "w") as f:
            json.dump(report, f, indent=1)
        sys.stderr.write(f"# report: wrote {json_out}\n")
        if report.get("fabric_matrix"):
            matrix_path = os.path.join(
                os.path.dirname(json_out) or ".", fabric_mod.MATRIX_NAME
            )
            fabric_mod.save_matrix(report["fabric_matrix"], matrix_path)
            sys.stderr.write(f"# report: wrote {matrix_path}\n")
        if report.get("fidelity_frontier"):
            frontier_path = os.path.join(
                os.path.dirname(json_out) or ".", "fidelity_frontier.json"
            )
            with open(frontier_path, "w") as f:
                json.dump(report["fidelity_frontier"], f, indent=1)
            sys.stderr.write(f"# report: wrote {frontier_path}\n")

    for path in args.logs:
        events, skipped = load_events_counted(path)
        if args.json:
            counts: Dict[str, int] = {}
            for e in events:
                k = e.get("event", "raw")
                counts[k] = counts.get(k, 0) + 1
            sys.stdout.write(json.dumps({"log": path, "events": counts}) + "\n")
        else:
            sys.stdout.write(
                render_report(events, name=path, skipped_lines=skipped)
            )
            if len(args.logs) > 1:
                sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
