"""The bandwidth study's fabric model (the port's own copy of the JAX
package's ``utils/bandwidth.py``).

The reference compares distributed training over in-node links and 1, 10
and 100 GbE (its README) but reports no numbers. Given a step's measured
time and its bits on the wire, this models the communication time and the
step time on each fabric, so one run on one card gives the whole fabric
table.

Model: an all-reduce of B bytes over W workers on a fabric of per-link
bandwidth beta takes ``2 (W - 1) / W * B / beta`` (the ring bound) plus a
latency term per collective: the first-order model of the PowerSGD paper's
speedup claims.

:func:`fabric_model` is the one accessor of these numbers for the live
plane (``observe.analytics``, ``observe.live``): the scalar tables, and,
given a measured per-edge matrix (the JAX package's ``fabric_matrix.json``
layout), a ring whose slowest edge gates every reduction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# bytes/second. The GbE rows are the reference's fabrics at line rate. The
# in-node row is NVIDIA's published figure, not a measurement: the H100 SXM5
# data sheet ("NVIDIA H100 Tensor Core GPU" data sheet, form factor H100 SXM)
# gives NVLink 4 at 900 GB/s per GPU, both directions together; a ring moves
# data one way on each link, so the row takes half, 450 GB/s. The port's card
# measurements are taken on an NVIDIA H100 80GB HBM3 (SXM) at a 700.00 W
# power limit.
FABRICS_BYTES_PER_S: Dict[str, float] = {
    "1GbE": 0.125e9,
    "10GbE": 1.25e9,
    "100GbE": 12.5e9,
    "NVLink4(H100)": 450e9,
}

# seconds per collective: the reference's latency model for the GbE rows;
# the data sheet gives no latency for NVLink, so its row has none (the
# projection there is the bandwidth term alone, a lower bound)
LATENCY_S: Dict[str, float] = {
    "1GbE": 50e-6,
    "10GbE": 30e-6,
    "100GbE": 20e-6,
    "NVLink4(H100)": 0.0,
}


@dataclass
class FabricEstimate:
    fabric: str
    comm_time_s: float
    step_time_s: float
    comm_fraction: float


def ring_neighbors(world_size: int) -> List[Tuple[int, int]]:
    """The (src, dst) directed edge list of the rank ring: rank r sends to
    rank (r+1) mod W. One entry per rank; a 1-rank world has no edges."""
    if world_size < 2:
        return []
    return [(r, (r + 1) % world_size) for r in range(world_size)]


@dataclass
class EdgeEstimate:
    """One measured (or declared) link of the mesh. ``bytes_per_s`` is the
    EFFECTIVE rate at the measured payload (latency folded in when the
    measurement cannot separate the two)."""

    src: int
    dst: int
    bytes_per_s: float
    latency_s: float = 0.0


@dataclass
class FabricModel:
    """The fabric as the planner sees it: the named scalar tables always,
    plus (when a measured matrix is supplied) a per-edge matrix whose
    SLOWEST edge gates every ring reduction."""

    fabrics: Dict[str, float] = field(default_factory=lambda: dict(FABRICS_BYTES_PER_S))
    latency: Dict[str, float] = field(default_factory=lambda: dict(LATENCY_S))
    edges: List[EdgeEstimate] = field(default_factory=list)

    @property
    def per_edge(self) -> bool:
        return bool(self.edges)

    def bytes_per_s(self, fabric: str) -> float:
        return self.fabrics[fabric]

    def latency_s(self, fabric: str) -> float:
        return self.latency.get(fabric, 0.0)

    def bottleneck(self) -> Optional[EdgeEstimate]:
        """The slowest measured edge (None without a matrix)."""
        if not self.edges:
            return None
        return min(self.edges, key=lambda e: e.bytes_per_s)

    def ring_beta(self, fabric: str) -> float:
        """Effective per-link bandwidth for a ring reduction: the slowest
        edge when a measured matrix is present (every chunk traverses every
        link, so the worst link gates the whole ring), else the named
        fabric's scalar."""
        worst = self.bottleneck()
        if worst is not None and worst.bytes_per_s > 0:
            return worst.bytes_per_s
        return self.fabrics[fabric]

    def ring_latency_s(self, fabric: str) -> float:
        """Per-collective latency: the bottleneck edge's measured latency
        when present, else the named fabric's scalar."""
        worst = self.bottleneck()
        if worst is not None and worst.latency_s > 0:
            return worst.latency_s
        return self.latency.get(fabric, 0.0)

    def allreduce_time_s(
        self, payload_bytes: float, n_workers: int, fabric: str, n_collectives: int = 1
    ) -> float:
        beta = self.ring_beta(fabric)
        ring = 2.0 * (n_workers - 1) / max(n_workers, 1) * payload_bytes / beta
        return ring + n_collectives * self.ring_latency_s(fabric)


def fabric_model(matrix: Optional[Dict] = None) -> FabricModel:
    """The typed accessor every fabric consumer goes through.

    Without arguments: the scalar tables. With a matrix dict (``{"edges":
    [{"src", "dst", "bytes_per_s", "latency_s"}, ...]}``): a per-edge model
    whose ring semantics are slowest-edge-gates. Malformed edge rows are
    skipped rather than raised — a half-written artifact degrades to the
    scalar model."""
    model = FabricModel()
    if not isinstance(matrix, dict):
        return model
    for row in matrix.get("edges") or []:
        if not isinstance(row, dict):
            continue
        try:
            edge = EdgeEstimate(
                src=int(row["src"]),
                dst=int(row["dst"]),
                bytes_per_s=float(row["bytes_per_s"]),
                latency_s=float(row.get("latency_s", 0.0) or 0.0),
            )
        except (KeyError, TypeError, ValueError):
            continue
        if edge.bytes_per_s > 0:
            model.edges.append(edge)
    return model


def allreduce_time_s(
    payload_bytes: float, n_workers: int, fabric: str, n_collectives: int = 1
) -> float:
    beta = FABRICS_BYTES_PER_S[fabric]
    ring = 2.0 * (n_workers - 1) / max(n_workers, 1) * payload_bytes / beta
    return ring + n_collectives * LATENCY_S[fabric]


def bandwidth_table(
    bits_per_step: int,
    compute_time_s: float,
    n_workers: int,
    n_collectives: int = 3,
    fabrics: Sequence[str] = ("1GbE", "10GbE", "100GbE", "NVLink4(H100)"),
) -> Dict[str, FabricEstimate]:
    """Per-fabric step-time estimates for one training step. ``n_collectives``
    drives the latency term; pass the step's collective count as
    :func:`..parallel.comm.record_collectives` saw it (as
    ``experiments.bandwidth_study`` does): PowerSGD's P, Q and rank-1
    payloads and the loss all-reduce are 4, the packed exact path and the
    loss 2."""
    payload = bits_per_step / 8.0
    out: Dict[str, FabricEstimate] = {}
    for fabric in fabrics:
        comm = allreduce_time_s(payload, n_workers, fabric, n_collectives)
        # serialized comm/compute (an upper bound: a step may overlap them)
        total = compute_time_s + comm
        out[fabric] = FabricEstimate(fabric, comm, total, comm / total if total else 0.0)
    return out


def format_table(tables: Dict[str, Dict[str, FabricEstimate]]) -> str:
    """Render {config_name: bandwidth_table(...)} as an aligned text table."""
    fabrics = None
    lines = []
    for name, table in tables.items():
        if fabrics is None:
            fabrics = list(table)
            lines.append("config".ljust(24) + "".join(f.rjust(14) for f in fabrics))
        row = name.ljust(24)
        for f in fabrics:
            row += f"{table[f].step_time_s * 1e3:11.2f} ms"
        lines.append(row)
    return "\n".join(lines)
