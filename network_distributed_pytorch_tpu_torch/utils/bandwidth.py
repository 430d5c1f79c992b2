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
speedup claims. (The JAX package's per-edge ``FabricModel`` waits for the
port of the fabric measurement that feeds it.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

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
