"""Cross-rank critical-path analysis over the merged span timeline: the
port's own copy of the JAX package's ``observe/critpath.py``. Imports no
torch.

The span plane is per rank; the wire ledger says every rank synchronises
at each step's collectives. Stitching the two gives a per-step causal
graph: each rank runs its chain of leaf spans (data_load, compute,
collective-wait, ...), and the step's collective joins all of them, so no
rank's step completes before the slowest rank reaches the join. The
longest path through that graph therefore runs along ONE rank's timeline
(the rank with the largest summed leaf-span time), and the output is the
BLAME: which rank gated the step, which of its phases carried the gap,
and, when that phase is collective-wait, which ring edge the wait sat on.

The gating phase is the phase with the largest EXCESS over the cross-rank
median of that phase, not the largest duration: a throttled link blames
collective-wait even where compute is larger on every rank. Rank r's
exposed comm wait sits on its outgoing ring edge (r, (r+1) mod W)
(``utils.bandwidth.ring_neighbors``).

A real training loop of either package has no ``step/comm`` span: its
collectives run inside ``step/compute``. On such a run the comm share is 0
and the blame falls on compute or ``data_load``; only a loop that spans
its exposed waits (the toy worker's simulated wire) shows collective-wait.

Cross-rank timings are stitched on the run log's clock model and inherit
its skew tolerance (``MergedRun.clock_skew_bound_s``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..utils import bandwidth as _bandwidth
from .analytics import percentile
from .events import CritPathEvent

PHASE_DATA = "data_load"
PHASE_COMPUTE = "compute"
PHASE_COMM = "collective-wait"
PHASES = (PHASE_DATA, PHASE_COMPUTE, PHASE_COMM)


def phase_of(span_name: str) -> str:
    """The three-way phase of a leaf span's name: anything carrying
    ``data_load`` is the input pipeline, anything carrying ``comm`` is
    exposed collective wait, and the rest (compute, checkpoint, eval)
    charges the compute lane."""
    name = str(span_name)
    if PHASE_DATA in name:
        return PHASE_DATA
    if "comm" in name:
        return PHASE_COMM
    return PHASE_COMPUTE


def _leaf_spans_by_step_rank(events: List[Dict]) -> Dict[int, Dict[int, List[Dict]]]:
    """{step: {rank: [leaf span records]}}. Container spans (any span
    another span of the same (step, rank) group names as its parent) are
    dropped so that nested trees do not charge their children twice."""
    grouped: Dict[Tuple[int, int], List[Dict]] = {}
    for e in events:
        if e.get("event") != "span":
            continue
        step, rank, dur = e.get("step"), e.get("rank"), e.get("dur_s")
        if step is None or rank is None:
            continue
        if not isinstance(dur, (int, float)) or dur < 0:
            continue
        grouped.setdefault((int(step), int(rank)), []).append(e)
    out: Dict[int, Dict[int, List[Dict]]] = {}
    for (step, rank), spans in grouped.items():
        parents = {s.get("parent_id") for s in spans if s.get("parent_id") is not None}
        leaves = [s for s in spans if s.get("span_id") not in parents]
        out.setdefault(step, {})[rank] = leaves or spans
    return out


def _phase_split(spans: List[Dict]) -> Dict[str, float]:
    split = {p: 0.0 for p in PHASES}
    for s in spans:
        split[phase_of(s.get("name") or "")] += float(s["dur_s"])
    return split


def step_blame(per_rank: Dict[int, Dict[str, float]], world_size: int, step: int) -> Optional[CritPathEvent]:
    """One step's blame verdict from its per-rank phase splits; None when
    no rank reported spans."""
    if not per_rank:
        return None
    totals = {r: sum(split.values()) for r, split in per_rank.items()}
    crit = max(sorted(totals), key=lambda r: totals[r])
    split = per_rank[crit]
    # excess over the cross-rank median per phase: what THIS rank spent
    # beyond what a typical rank spent there
    excess = {}
    for p in PHASES:
        med = percentile([per_rank[r][p] for r in per_rank], 50) or 0.0
        excess[p] = split[p] - med
    phase = max(PHASES, key=lambda p: excess[p])
    if excess[phase] <= 0:
        # no rank stands out (or a world of one): the critical rank's
        # largest phase
        phase = max(PHASES, key=lambda p: split[p])
    edge_src = edge_dst = None
    if phase == PHASE_COMM and world_size > 1:
        edge_src, edge_dst = crit, (crit + 1) % world_size
    return CritPathEvent(
        step=step,
        rank=crit,
        phase=phase,
        path_s=totals[crit],
        edge_src=edge_src,
        edge_dst=edge_dst,
        data_s=split[PHASE_DATA],
        compute_s=split[PHASE_COMPUTE],
        comm_s=split[PHASE_COMM],
    )


def analyze(events: List[Dict], world_size: int) -> Optional[Dict]:
    """The run's critical-path report from a merged event list.

    None when the run carries no stepped, ranked spans. Otherwise a dict
    with the per-step ``CritPathEvent`` records, the path-seconds-weighted
    blame shares by rank and by phase, the top gating edge, and
    ``comm_share``: the share of the summed critical-path seconds that the
    gating ranks spent in collective-wait (lower is better)."""
    by_step = _leaf_spans_by_step_rank(events)
    verdicts: List[CritPathEvent] = []
    for step in sorted(by_step):
        per_rank = {r: _phase_split(spans) for r, spans in by_step[step].items()}
        ev = step_blame(per_rank, world_size, step)
        if ev is not None:
            verdicts.append(ev)
    if not verdicts:
        return None
    total_path = sum(v.path_s for v in verdicts)
    blame_rank: Dict[int, float] = {}
    blame_phase: Dict[str, float] = {p: 0.0 for p in PHASES}
    edge_steps: Dict[Tuple[int, int], int] = {}
    for v in verdicts:
        blame_rank[v.rank] = blame_rank.get(v.rank, 0.0) + v.path_s
        blame_phase[v.phase] += v.path_s
        if v.edge_src is not None:
            edge = (v.edge_src, v.edge_dst)
            edge_steps[edge] = edge_steps.get(edge, 0) + 1
    top_edge = None
    if edge_steps:
        (src, dst), n = max(sorted(edge_steps.items()), key=lambda kv: kv[1])
        top_edge = {"src": src, "dst": dst, "blamed_steps": n}
    comm_s = sum(v.comm_s for v in verdicts)
    return {
        "schema": 1,
        "n_steps": len(verdicts),
        "world_size": world_size,
        "total_path_s": total_path,
        "comm_share": comm_s / total_path if total_path > 0 else 0.0,
        "blame_by_rank": {
            str(r): s / total_path if total_path > 0 else 0.0 for r, s in sorted(blame_rank.items())
        },
        "blame_by_phase": {p: s / total_path if total_path > 0 else 0.0 for p, s in blame_phase.items()},
        "top_edge": top_edge,
        "events": [v.record() for v in verdicts],
    }


def comm_waits_by_edge(events: List[Dict], world_size: int) -> Dict[Tuple[int, int], List[float]]:
    """Exposed-wait samples by ring edge: rank r's collective-wait leaf
    spans charged to its outgoing edge, the rule the live plane's per-edge
    detector and the fabric matrix share."""
    edges = {src: (src, dst) for src, dst in _bandwidth.ring_neighbors(world_size)}
    out: Dict[Tuple[int, int], List[float]] = {}
    for step_group in _leaf_spans_by_step_rank(events).values():
        for rank, spans in step_group.items():
            if rank not in edges:
                continue
            wait = sum(float(s["dur_s"]) for s in spans if phase_of(s.get("name") or "") == PHASE_COMM)
            if wait > 0:
                out.setdefault(edges[rank], []).append(wait)
    return out
