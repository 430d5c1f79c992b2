#!/usr/bin/env python3
"""The run report of a port run directory: the machine-readable join that
the offline analyses produce and read, and its text sections for MFU, the
critical path and the fleet control plane.

It merges the directory's shards (``observe.runlog.merge_run``), then:

- the step statistics and stragglers (``observe.analytics``), each
  flagged rank joined with the phase (and, for collective-wait, the ring
  edge) its critical-path excess sat in;
- the effective bandwidth of the wire ledger against the step p50;
- the MFU join (``observe.mfu``): the audit's counted FLOPs against the
  steady-state p50, against the H100's bf16 peak;
- the span summary, the cross-rank critical path (``observe.critpath``)
  and the measured per-edge fabric matrix (``observe.fabric``);
- with ``--plan``, the join of a ``scripts/torch_plan.py`` plan with the
  realized run (``observe.costmodel.join_realized``: the model's
  ``error``);
- on a fleet scheduler's run directory (``launch fleet --run-dir``), the
  fleet section: each job's outcome, chip-seconds and preemptions, and
  the deadline-weighted goodput.

Usage (from the root of the repository)::

    python3 scripts/torch_report.py --run-dir runs/r7 --json-out out/run_report.json
    python3 scripts/torch_report.py --run-dir runs/r8 --plan out/plan.json --plan-fabric "NVLink4(H100)"

It writes the report to ``--json-out`` (default ``artifacts/
run_report.json``) and, where the run measured one, the fabric matrix
beside it (``fabric_matrix.json``, which ``scripts/torch_plan.py
--fabric-matrix`` and ``utils.bandwidth.fabric_model`` read), and prints
the text. The rest of the JAX package's ``scripts/report.py`` (its
failure, SLO, KV-pool, recovery, memory and fidelity sections, the
Chrome trace, ``--compare``, ``--watch``) is not ported. Imports no torch
beyond the port's ``observe`` package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from network_distributed_pytorch_tpu_torch.observe import analytics, costmodel, critpath  # noqa: E402
from network_distributed_pytorch_tpu_torch.observe import fabric as fabric_mod  # noqa: E402
from network_distributed_pytorch_tpu_torch.observe import mfu as mfu_mod  # noqa: E402
from network_distributed_pytorch_tpu_torch.observe import runlog  # noqa: E402


def _fmt_bytes(n: float) -> str:
    if abs(n) >= 1e6:
        return f"{n / 1e6:.2f} MB"
    if abs(n) >= 1e3:
        return f"{n / 1e3:.2f} KB"
    return f"{n:.0f} B"


def _fmt_rate(bps: float) -> str:
    if bps >= 1e9:
        return f"{bps / 1e9:.2f} GB/s"
    if bps >= 1e6:
        return f"{bps / 1e6:.2f} MB/s"
    return f"{bps / 1e3:.2f} KB/s"


def load_plan(path: str) -> Optional[Dict]:
    """A ``scripts/torch_plan.py`` plan document, or None when unreadable."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) and "fabrics" in doc else None


def _union_len(intervals: List[Tuple[float, float]]) -> float:
    """The total length a set of (start, end) intervals covers."""
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
    """The merged timeline's spans as time shares by name and idle gaps by
    rank. A span's ``t_run`` marks its close (its start is ``t_run -
    dur_s``). ``share`` divides a name's total time by the summed walls of
    the ranks (each rank's last event less its first); ``idle`` is the part
    of a rank's wall that no depth-0 span covers."""
    spans = [
        e for e in events
        if e.get("event") == "span" and isinstance(e.get("dur_s"), (int, float)) and e["dur_s"] >= 0
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
        slot = by_name.setdefault(s.get("name", "?"), {"count": 0, "total_s": 0.0, "max_s": 0.0})
        slot["count"] += 1
        slot["total_s"] += s["dur_s"]
        slot["max_s"] = max(slot["max_s"], s["dur_s"])
    for slot in by_name.values():
        slot["mean_s"] = slot["total_s"] / slot["count"]
        slot["share"] = slot["total_s"] / total_wall if total_wall > 0 else None
    idle_by_rank: Dict[str, Dict] = {}
    for r, (lo, hi) in sorted(walls.items(), key=lambda kv: (kv[0] is None, kv[0])):
        if r is None:  # the supervisor's log has no training work to idle
            continue
        ivals = [
            (max(lo, s["t_run"] - s["dur_s"]), min(hi, s["t_run"]))
            for s in spans
            if s.get("rank") == r and s.get("depth") == 0 and isinstance(s.get("t_run"), (int, float))
        ]
        if not ivals:
            continue
        covered = _union_len(ivals)
        wall = hi - lo
        idle_by_rank[str(r)] = {"wall_s": wall, "covered_s": covered, "idle_s": max(0.0, wall - covered)}
    return {"by_name": by_name, "total_wall_s": total_wall, "idle_by_rank": idle_by_rank}


def render_mfu_section(mfu_records: List[Dict]) -> List[str]:
    """MFU and the roofline verdict a phase (``MfuEvent`` records)."""
    lines = ["", "mfu & roofline (steady-state)", "-----------------------------"]
    if not mfu_records:
        lines.append("  no compile record carries a FLOPs count: run with the audit (an event log) to count them")
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


def render_critpath_section(crit: Optional[Dict], matrix: Optional[Dict], clock_skew_bound_s: float = 0.0) -> List[str]:
    """The blame shares by rank and by phase, the top gating edge and the
    measured per-edge table; empty without stepped, ranked spans."""
    if not isinstance(crit, dict):
        return []
    lines = ["", "critical path (cross-rank)", "--------------------------"]
    lines.append(
        f"  {crit['n_steps']} step(s) analyzed, collective-wait share of"
        f" the critical path {100 * crit['comm_share']:.1f}%"
        f" (merge tolerance +/- {clock_skew_bound_s * 1e3:.1f} ms)"
    )
    ranks = ", ".join(f"rank {r}: {100 * s:.1f}%" for r, s in crit["blame_by_rank"].items())
    lines.append(f"  blame by rank   {ranks}")
    phases = ", ".join(f"{p}: {100 * s:.1f}%" for p, s in crit["blame_by_phase"].items())
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
            f" {_fmt_bytes(matrix.get('per_step_edge_bytes', 0.0))}/step per link):"
        )
        for row in fabric_mod.edge_utilization(matrix):
            util = "  ".join(f"{name} {100 * u:5.1f}%" for name, u in sorted(row["utilization"].items()))
            lines.append(
                f"    {row['src']} -> {row['dst']}  "
                f"{_fmt_rate(row['bytes_per_s']):>12}  "
                f"wait p50 {row['wait_s_p50'] * 1e3:7.2f} ms  util {util}"
            )
        b = matrix.get("bottleneck") or {}
        if b:
            lines.append(f"    bottleneck edge: {b.get('src')} -> {b.get('dst')}")
    return lines


def fleet_summary_from_events(events: List[Dict]) -> Optional[Dict]:
    """The fleet control plane's aggregate over the scheduler's typed
    events (``job`` lifecycle, ``preempt``, ``schedule``, ``job_failed``):
    a row a job and the deadline-weighted goodput, completed work weighted
    1.0 when its deadline was met (or none was set) and 0.5 when missed,
    over every chip-second a terminal job held. None when the run scheduled
    nothing."""
    job_events = [e for e in events if e.get("event") == "job"]
    if not job_events:
        return None
    jobs: Dict[str, Dict] = {}
    for e in job_events:
        j = jobs.setdefault(
            str(e.get("job_id", "?")),
            {
                "kind": e.get("kind", ""), "priority": e.get("priority", 0), "state": "unfinished",
                "transitions": [], "preemptions": 0, "chip_seconds": None, "work_done": None, "met_deadline": None,
            },
        )
        state = e.get("state")
        j["transitions"].append(state)
        j["preemptions"] = max(j["preemptions"], int(e.get("preemptions", 0) or 0))
        if state in ("completed", "failed"):
            j["state"] = "quarantined" if state == "failed" else state
            j["chip_seconds"] = e.get("chip_seconds")
            j["work_done"] = e.get("work_done")
            j["met_deadline"] = e.get("met_deadline")
    schedules = [e for e in events if e.get("event") == "schedule"]
    terminal = [j for j in jobs.values() if j["state"] != "unfinished"]
    total_chip_s = sum(j["chip_seconds"] for j in terminal if isinstance(j["chip_seconds"], (int, float)))
    weighted = sum(
        (0.5 if j["met_deadline"] is False else 1.0) * j["work_done"]
        for j in terminal
        if j["state"] == "completed" and isinstance(j["work_done"], (int, float))
    )
    return {
        "n_jobs": len(jobs),
        "jobs": jobs,
        "completed": sorted(k for k, j in jobs.items() if j["state"] == "completed"),
        "quarantined": sorted(k for k, j in jobs.items() if j["state"] == "quarantined"),
        "unfinished": sorted(k for k, j in jobs.items() if j["state"] == "unfinished"),
        "preemptions": sum(1 for e in events if e.get("event") == "preempt"),
        "admissions": len(schedules),
        "planner_priced": sum(1 for e in schedules if e.get("planner") == "costmodel"),
        "total_chip_seconds": total_chip_s,
        "weighted_work": weighted,
        "goodput": (weighted / total_chip_s) if total_chip_s else None,
    }


def render_fleet_section(fleet: Dict) -> List[str]:
    lines = ["", "fleet control plane (gang scheduler)", "------------------------------------"]
    lines.append(
        f"  {fleet['n_jobs']} job(s): {len(fleet['completed'])} completed, {len(fleet['quarantined'])} quarantined,"
        f" {len(fleet['unfinished'])} unfinished; {fleet['preemptions']} preemption(s) over"
        f" {fleet['admissions']} admission(s) ({fleet['planner_priced']} planner-priced)"
    )
    for name, j in sorted(fleet["jobs"].items()):
        chip = j.get("chip_seconds")
        chip_txt = f"{chip:8.1f} chip-s" if chip is not None else "     n/a      "
        met = j.get("met_deadline")
        met_txt = "deadline met" if met else "deadline MISSED" if met is False else "no deadline"
        lines.append(
            f"  {name:<12} {j.get('kind', '?'):<5} prio {j['priority']:>3}  {j['state']:<12} {chip_txt}  {met_txt}"
            f"  {j['preemptions']} preemption(s)"
        )
    gp = fleet.get("goodput")
    if gp is not None:
        lines.append(
            f"  goodput  {gp:.4f} weighted-work/chip-s over {fleet['total_chip_seconds']:.1f} chip-s (higher is"
            " better)"
        )
    return lines


def run_report(run_dir: str) -> Tuple[str, Dict]:
    """Merge ``run_dir`` and run the analyses: ``(text, report dict)``. The
    dict's keys are the JAX package's ``scripts/report.py`` ones for what
    is ported here."""
    merged = runlog.merge_run(run_dir)
    world = merged.manifest.world_size
    stats = analytics.rank_step_stats(merged.events)
    stragglers = analytics.detect_stragglers(stats)
    p50s = [s["p50_s"] for s in stats.values() if s["n"]]
    step_p50 = analytics.percentile(p50s, 50) if p50s else None
    step_p95 = analytics.percentile([s["p95_s"] for s in stats.values() if s["n"]], 50) if p50s else None
    compile_events = [e for e in merged.events if e.get("event") == "compile"]
    overlap = next((e.get("overlap") for e in compile_events), None)
    collectives = [e for e in merged.events if e.get("event") == "collective"]
    bandwidth = (
        analytics.effective_bandwidth(step_p50, collectives, world, overlap=overlap)
        if collectives and step_p50 else None
    )

    # the MFU join: the audit's FLOPs count x the measured steady-state p50
    n_steps = sum(s["n"] for s in stats.values())
    mfu_records = [ev.record() for ev in mfu_mod.mfu_from_compile_records(compile_events, step_p50, n_steps=n_steps)]
    spans = span_summary(merged.events)

    crit = critpath.analyze(merged.events, world)
    matrix = fabric_mod.measure_fabric_matrix(merged.events, world)
    straggler_records = [ev.record() for ev in stragglers]
    if crit:
        # a flagged rank carries the phase (and, for collective-wait, the
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
            edges = [(e["edge_src"], e["edge_dst"]) for e in blamed if e.get("edge_src") is not None]
            if rec["blamed_phase"] == critpath.PHASE_COMM and edges:
                src, dst = max(set(edges), key=edges.count)
                rec["blamed_edge"] = {"src": src, "dst": dst}

    head = [f"run report: {run_dir}", f"  world {world}, {len(merged.events)} events"]
    if step_p50 is not None:
        head.append(f"  step p50 {step_p50 * 1e3:.2f} ms, p95 {step_p95 * 1e3:.2f} ms over {n_steps} steady step(s)")
    for ev in stragglers:
        head.append(f"  {ev.banner()}")
    sections = render_critpath_section(crit, matrix, clock_skew_bound_s=merged.clock_skew_bound_s)
    sections += render_mfu_section(mfu_records)
    # the fleet control plane, where the run is a fleet scheduler's
    fleet = fleet_summary_from_events(merged.events)
    if fleet:
        sections += render_fleet_section(fleet)
    text = "\n".join(head + sections) + "\n"

    report = {
        "schema": 1,
        "run_dir": os.path.abspath(run_dir),
        "world_size": world,
        "n_events": len(merged.events),
        "ranks": {str(r): {**merged.per_rank[r], **stats.get(r, {})} for r in sorted(merged.per_rank)},
        "step_p50_s": step_p50,
        "step_p95_s": step_p95,
        "stragglers": straggler_records,
        "bandwidth": bandwidth,
        "critpath": crit,
        "clock_skew_bound_s": merged.clock_skew_bound_s,
        "fabric_matrix": matrix,
        # the LAST compile event: the config the run finished on, what the
        # cost model calibrates from and joins its predictions against
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
        "mfu": mfu_records,
        "spans": spans,
        # None unless the run scheduled jobs (a fleet scheduler's run dir)
        "fleet": fleet,
    }
    return text, report


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
    parser.add_argument("--run-dir", required=True, help="a run directory (manifest and rank shards)")
    parser.add_argument(
        "--json-out", default=os.path.join("artifacts", "run_report.json"),
        help="where to write the machine-readable report",
    )
    parser.add_argument(
        "--plan", default=None,
        help="join this scripts/torch_plan.py plan with the realized run (the 'costmodel' section)",
    )
    parser.add_argument(
        "--plan-fabric", default=None,
        help="--plan: the fabric whose predictions to join (default: the plan's only fabric)",
    )
    args = parser.parse_args(argv)

    text, report = run_report(args.run_dir)
    if args.plan:
        plan = load_plan(args.plan)
        if plan is None:
            parser.error(f"--plan {args.plan}: not a readable plan")
        try:
            report["costmodel"], line = join_plan(report, plan, args.plan_fabric)
        except ValueError as e:
            parser.error(f"--plan: {e}")
        text += line
    sys.stdout.write(text)
    parent = os.path.dirname(args.json_out)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump(report, f, indent=1)
    sys.stderr.write(f"# report: wrote {args.json_out}\n")
    if report.get("fabric_matrix"):
        path = os.path.join(os.path.dirname(args.json_out) or ".", fabric_mod.MATRIX_NAME)
        fabric_mod.save_matrix(report["fabric_matrix"], path)
        sys.stderr.write(f"# report: wrote {path}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
