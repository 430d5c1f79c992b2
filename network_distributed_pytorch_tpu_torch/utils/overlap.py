"""Communication and compute overlap, from a profiler's kernel timeline:
the port's counterpart of the JAX package's ``utils/overlap.py``.

The JAX package reads collective windows from the scheduled HLO, whose
instruction order is the execution order. The port runs eagerly: the card
runs NCCL's kernels on streams of their own, so the evidence is the
timeline a ``torch.profiler`` trace recorded. :func:`overlap_report` takes
its kernels (:func:`kernels_from_chrome_trace` reads them from the trace
that ``utils.profiling.trace`` writes) and counts each NCCL kernel as a
collective window, overlapped where a compute kernel on another stream ran
during it, with the time they overlap. It returns the JAX package's keys,
so :func:`comm_attribution` is the same function. With no NCCL kernel (the
CPU, or a run of one process without a collective) the comm fields read 0,
as the JAX package's CPU report does.
"""

from __future__ import annotations

import json
from typing import Dict, List, Mapping, Sequence, Union


def is_collective(name: str) -> bool:
    return "nccl" in name.lower()


def kernels_from_chrome_trace(trace: Union[str, Mapping]) -> List[Dict]:
    """The device kernels of a Chrome trace (a path or the parsed JSON):
    ``{"name", "ts", "dur", "stream"}`` each, times in microseconds, in
    start order."""
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    events = trace.get("traceEvents", []) if isinstance(trace, Mapping) else trace
    out = [
        {"name": e.get("name", ""), "ts": float(e["ts"]), "dur": float(e.get("dur", 0.0)),
         "stream": (e.get("args") or {}).get("stream", e.get("tid"))}
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "kernel"
    ]
    return sorted(out, key=lambda k: k["ts"])


def overlap_report(kernels: Sequence[Mapping]) -> Dict[str, object]:
    """Overlap evidence of a kernel timeline (``name``, ``ts``, ``dur``,
    ``stream`` a kernel, microseconds). Each NCCL kernel is an asynchronous
    collective window; it is overlapped when a compute kernel on another
    stream runs inside it. The copy-window and synchronous-collective
    fields of the JAX package's report have no counterpart on the card
    (NCCL's collectives run on their own streams) and read 0."""
    comm = [k for k in kernels if is_collective(k["name"])]
    compute = [k for k in kernels if not is_collective(k["name"])]
    collectives = []
    total_overlap = 0.0
    for c in comm:
        start, end = c["ts"], c["ts"] + c["dur"]
        overlap = sum(
            max(0.0, min(end, k["ts"] + k["dur"]) - max(start, k["ts"]))
            for k in compute if k["stream"] != c["stream"]
        )
        total_overlap += overlap
        collectives.append({
            "kind": c["name"], "start_us": start, "dur_us": c["dur"], "overlap_us": overlap, "overlapped": overlap > 0,
        })
    overlapped = [c for c in collectives if c["overlapped"]]
    return {
        "scheduled": bool(kernels),
        "n_async_collectives": len(collectives),
        "n_overlapped": len(overlapped),
        "all_overlap": bool(collectives) and len(overlapped) == len(collectives),
        "collectives": collectives,
        "n_async_copy_windows": 0,
        "n_copy_windows_with_compute": 0,
        "n_sync_collectives": 0,
        "sync_collectives": [],
        "n_sync_gaps_with_compute": 0,
        "sync_interleaved": False,
        # the NCCL kernels that ran (their names carry the algorithm and protocol)
        "collective_emitters": sorted({c["name"] for c in comm}),
        "comm_us": sum(c["dur"] for c in comm),
        "overlap_us": total_overlap,
    }


def comm_attribution(overlap: Dict) -> Dict[str, float]:
    """Count-weighted attribution of the step's collectives: how many have
    compute inside or behind their window (``hidden``) against those on
    the critical path (``exposed``). Asynchronous collectives are hidden
    when compute runs inside them; synchronous chunk collectives when the
    interior gap after them holds compute (the last one of a chain is
    always exposed). ``exposed_fraction`` times the step time bounds the
    step's exposed communication time from above."""
    n_async = int(overlap.get("n_async_collectives") or 0)
    n_over = int(overlap.get("n_overlapped") or 0)
    n_sync = int(overlap.get("n_sync_collectives") or 0)
    interior = max(0, n_sync - 1)
    gaps = min(int(overlap.get("n_sync_gaps_with_compute") or 0), interior)
    total = n_async + n_sync
    hidden = min(n_over, n_async) + gaps
    hidden_fraction = hidden / total if total else 0.0
    return {
        "n_collectives": total,
        "n_hidden": hidden,
        "hidden_fraction": hidden_fraction,
        "exposed_fraction": 1.0 - hidden_fraction,
    }
