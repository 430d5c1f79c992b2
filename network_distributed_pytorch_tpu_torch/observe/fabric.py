"""The measured per-edge fabric matrix: the port's own copy of the JAX
package's ``observe/fabric.py``. Imports no torch.

``utils.bandwidth`` declares the fabric as one scalar a name; this module
MEASURES it a link from a merged run: the deduped wire ledger says how
many bytes each ring edge carried a step, the ranks' ``step/comm`` spans
say how long each rank's outgoing link was exposed, and the quotient is
an effective bandwidth per (src_rank, dst_rank) ring edge. The result is
saved as ``fabric_matrix.json`` and read back through
:func:`utils.bandwidth.fabric_model` by the cost model (the slowest edge
gates a ring), the live plane and the report's per-edge table.

With a roughly constant payload a step, bandwidth and latency cannot be
told apart from wait times: ``bytes_per_s`` is the EFFECTIVE
(latency-inclusive) rate at the measured payload, and ``latency_s`` the
least observed wait, an upper bound on the latency of one collective.

The real loop of either package has no ``step/comm`` span (its
collectives run inside ``step/compute``), so its runs give no matrix;
the toy worker's simulated wire does.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ..utils import bandwidth as _bandwidth
from .analytics import _dedupe_collectives, percentile

MATRIX_SCHEMA = 1
MATRIX_NAME = "fabric_matrix.json"

# span names whose durations count as exposed collective wait on the
# emitting rank's outgoing ring link (a substring, as the critical path's
# phases match it)
_COMM_SPAN_MARKER = "comm"


def _comm_waits_by_rank(events: List[Dict]) -> Dict[int, List[float]]:
    """Each rank's exposed-comm span durations, in event order."""
    waits: Dict[int, List[float]] = {}
    for e in events:
        if e.get("event") != "span":
            continue
        rank = e.get("rank")
        dur = e.get("dur_s")
        if rank is None or not isinstance(dur, (int, float)):
            continue
        name = str(e.get("name") or "")
        if _COMM_SPAN_MARKER in name:
            waits.setdefault(int(rank), []).append(float(dur))
    return waits


def measure_fabric_matrix(events: List[Dict], world_size: int) -> Optional[Dict]:
    """The per-edge matrix of a merged run's events.

    Edge (r, (r+1) mod W) is charged rank r's p50 ``step/comm`` wait; every
    ring link moves ``2 (W-1)/W`` times the deduped ledger's payload a step.
    None when the run carries no measurable evidence (one rank, no comm
    spans, or no ledger)."""
    edges_topo = _bandwidth.ring_neighbors(world_size)
    if not edges_topo:
        return None
    collectives = [e for e in events if e.get("event") == "collective"]
    per_step_bytes = sum(float(e.get("payload_bytes") or 0.0) for e in _dedupe_collectives(collectives))
    if per_step_bytes <= 0:
        return None
    per_edge_bytes = 2.0 * (world_size - 1) / world_size * per_step_bytes
    waits = _comm_waits_by_rank(events)
    rows: List[Dict] = []
    for src, dst in edges_topo:
        ws = waits.get(src) or []
        # the first wait of a rank rides the warm-up the step statistics drop
        eligible = ws[1:] if len(ws) > 1 else ws
        if not eligible:
            continue
        p50 = percentile(eligible, 50)
        if not p50 or p50 <= 0:
            continue
        rows.append({
            "src": src,
            "dst": dst,
            "bytes_per_s": per_edge_bytes / p50,
            # the least observed wait: an upper bound on one collective's latency
            "latency_s": min(eligible),
            "wait_s_p50": p50,
            "n_steps": len(eligible),
        })
    if not rows:
        return None
    worst = min(rows, key=lambda r: r["bytes_per_s"])
    return {
        "schema": MATRIX_SCHEMA,
        "topology": "ring",
        "world_size": world_size,
        "per_step_bytes": per_step_bytes,
        "per_step_edge_bytes": per_edge_bytes,
        "edges": rows,
        "bottleneck": {"src": worst["src"], "dst": worst["dst"]},
    }


def edge_utilization(matrix: Optional[Dict], fabrics: Optional[Dict[str, float]] = None) -> List[Dict]:
    """Each edge's utilisation of every named fabric's line rate (the
    report's per-edge table); empty without a matrix."""
    if not isinstance(matrix, dict):
        return []
    if fabrics is None:
        fabrics = _bandwidth.FABRICS_BYTES_PER_S
    rows = []
    for e in matrix.get("edges") or []:
        achieved = float(e.get("bytes_per_s") or 0.0)
        rows.append({
            **e,
            "utilization": {name: achieved / rate for name, rate in fabrics.items() if rate > 0},
        })
    return rows


def save_matrix(matrix: Dict, path: str) -> str:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(matrix, f, indent=1)
    os.replace(tmp, path)
    return path


def load_matrix(path: str) -> Optional[Dict]:
    """A saved matrix; None (never a raise) on a missing or malformed file,
    so that its readers fall back to the scalar model."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or not doc.get("edges"):
        return None
    return doc
