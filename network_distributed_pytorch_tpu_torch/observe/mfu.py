"""MFU accounting and the roofline verdict: the port's own copy of the JAX
package's ``observe/mfu.py``. Imports no torch.

**The device tables.** ``PEAK_BF16_FLOPS`` (peak dense bf16 FLOP/s of one
card) and ``HBM_BYTES_PER_S`` (its HBM bandwidth), keyed by a substring of
the device kind (``torch.cuda.get_device_name``) - the longest match wins
("h100 pcie" before "h100"). The rows are the H100's, where the JAX
package's are TPU generations'.

**The FLOPs join.** The audit of a step's first call records its FLOPs on
the :class:`observe.events.CompileEvent` (``observe.ledger.count_flops``:
``torch.utils.flop_counter.FlopCounterMode`` plus the products of K5's
launches, which the counter does not see; ``flops_source`` is
``"flop_counter"``). At report time :func:`mfu_from_compile_records`
joins those counts with the measured steady-state step time: ``MFU =
flops_per_step / step_time / peak``. The peak is the bf16 one whatever
the step's dtype, so an fp32 step's MFU is taken against it too.

**The roofline verdict.** :func:`classify_roofline` names the limiter:

- ``comm-exposed``: the schedule's count-weighted exposed-communication
  fraction (``utils.overlap.comm_attribution``) is at least
  ``COMM_EXPOSED_THRESHOLD``;
- ``hbm``: the arithmetic intensity (FLOPs over bytes accessed) is below
  the device's ridge point (peak FLOP/s over HBM bytes/s);
- ``compute``: above the ridge, or the bytes are unknown. The port's audit
  leaves ``bytes_accessed_per_step`` None (eager PyTorch has no
  compile-time byte count), so a port run reads ``compute`` or
  ``comm-exposed``, never ``hbm``;
- ``unknown``: no peak for the device (the CPU publishes no verdict it
  cannot ground).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..utils import overlap as _overlap
from .events import MfuEvent

# Peak dense bf16 FLOP/s of one card by device-kind substring, without
# sparsity. Sources: NVIDIA's "H100 Tensor Core GPU Architecture" white
# paper, its table of peak rates (H100 SXM5 989.4 dense bf16 TFLOPS, H100
# PCIe 756); the "H100 Tensor Core GPU" data sheet for the H100 NVL (1,671
# TFLOPS with sparsity, so 835 dense). "NVIDIA H100 80GB HBM3" is the SXM.
PEAK_BF16_FLOPS: Dict[str, float] = {
    "h100": 989.4e12,
    "h100 pcie": 756e12,
    "h100 nvl": 835e12,
}

# HBM bytes/s of one card (the same data sheet's "GPU memory bandwidth"
# row: SXM 3.35 TB/s, PCIe 2 TB/s, NVL 3.9 TB/s; same keying rules). The
# ridge point peak/HBM separates compute-bound from HBM-bound.
HBM_BYTES_PER_S: Dict[str, float] = {
    "h100": 3.35e12,
    "h100 pcie": 2.0e12,
    "h100 nvl": 3.9e12,
}

# exposed-comm fraction at or above which the window is classified
# comm-exposed (count-weighted upper bound: see utils.overlap)
COMM_EXPOSED_THRESHOLD = 0.5

STEADY_STATE = "steady-state"


def _table_lookup(table: Dict[str, float], device_kind: str, platform: str) -> float:
    if platform and platform != "gpu":
        return 0.0
    kind = (device_kind or "").lower()
    for key in sorted(table, key=len, reverse=True):
        if key in kind:
            return table[key]
    return 0.0


def peak_flops(device_kind: str, platform: str = "gpu") -> float:
    """Peak bf16 FLOP/s for the device kind, or 0.0 when unknown (CPU)."""
    return _table_lookup(PEAK_BF16_FLOPS, device_kind, platform)


def hbm_bandwidth(device_kind: str, platform: str = "gpu") -> float:
    """HBM bytes/s for the device kind, or 0.0 when unknown."""
    return _table_lookup(HBM_BYTES_PER_S, device_kind, platform)


def classify_roofline(
    flops_per_step: float,
    bytes_accessed_per_step: Optional[float],
    peak_flops_per_s: float,
    hbm_bytes_per_s: Optional[float],
    exposed_comm_fraction: Optional[float] = None,
) -> Dict[str, Optional[float]]:
    """The roofline verdict plus the numbers it was derived from (see the
    module docstring for the decision order)."""
    out: Dict[str, Optional[float]] = {
        "bound": "unknown",
        "arithmetic_intensity": None,
        "ridge_flops_per_byte": None,
    }
    if bytes_accessed_per_step and bytes_accessed_per_step > 0 and flops_per_step > 0:
        out["arithmetic_intensity"] = flops_per_step / bytes_accessed_per_step
    if peak_flops_per_s > 0 and hbm_bytes_per_s and hbm_bytes_per_s > 0:
        out["ridge_flops_per_byte"] = peak_flops_per_s / hbm_bytes_per_s
    if not peak_flops_per_s > 0:
        return out
    if exposed_comm_fraction is not None and exposed_comm_fraction >= COMM_EXPOSED_THRESHOLD:
        out["bound"] = "comm-exposed"
    elif (
        out["arithmetic_intensity"] is not None
        and out["ridge_flops_per_byte"] is not None
        and out["arithmetic_intensity"] < out["ridge_flops_per_byte"]
    ):
        out["bound"] = "hbm"
    else:
        out["bound"] = "compute"
    return out


def _exposed_fraction(overlap: Optional[Dict]) -> Optional[float]:
    """Count-weighted exposed-comm fraction from a CompileEvent's overlap
    extract; None when the schedule carries no collective evidence."""
    if not overlap:
        return None
    attribution = _overlap.comm_attribution(overlap)
    if not attribution["n_collectives"]:
        return None
    return attribution["exposed_fraction"]


def mfu_event(
    label: str,
    step_time_s: float,
    flops_per_step: float,
    n_steps: int = 0,
    flops_source: str = "analytic",
    device_kind: str = "",
    platform: str = "gpu",
    peak_flops_per_s: Optional[float] = None,
    bytes_accessed_per_step: Optional[float] = None,
    hbm_bytes_per_s_: Optional[float] = None,
    exposed_comm_fraction: Optional[float] = None,
    window: str = STEADY_STATE,
) -> MfuEvent:
    """The typed MFU verdict for one measured window. The peak and the HBM
    bandwidth default to the device tables; pass them where the record
    itself carries authoritative values (the toy worker, a card the tables
    do not know)."""
    peak = peak_flops_per_s if peak_flops_per_s is not None else peak_flops(device_kind, platform)
    hbm = hbm_bytes_per_s_ if hbm_bytes_per_s_ is not None else hbm_bandwidth(device_kind, platform)
    roofline = classify_roofline(flops_per_step, bytes_accessed_per_step, peak, hbm, exposed_comm_fraction)
    mfu = flops_per_step / step_time_s / peak if peak > 0 and step_time_s > 0 else None
    return MfuEvent(
        label=label,
        window=window,
        n_steps=n_steps,
        step_time_s=step_time_s,
        flops_per_step=flops_per_step,
        flops_source=flops_source,
        peak_flops_per_s=peak,
        mfu=mfu,
        bound=str(roofline["bound"]),
        device_kind=device_kind,
        bytes_accessed_per_step=bytes_accessed_per_step,
        arithmetic_intensity=roofline["arithmetic_intensity"],
        ridge_flops_per_byte=roofline["ridge_flops_per_byte"],
        hbm_bytes_per_s=hbm if hbm > 0 else None,
        exposed_comm_fraction=exposed_comm_fraction,
    )


def mfu_from_compile_records(
    compile_records: Sequence[Dict],
    step_time_s: Optional[float],
    n_steps: int = 0,
    window: str = STEADY_STATE,
) -> List[MfuEvent]:
    """The report-time join: one MFU verdict per compile record that
    recorded a FLOPs count (deduped by label: every rank and incarnation
    re-emits the same record), against the run's measured steady-state
    step time."""
    if not isinstance(step_time_s, (int, float)) or not step_time_s > 0:
        return []
    out: List[MfuEvent] = []
    seen = set()
    for rec in compile_records:
        label = rec.get("label", "")
        flops = rec.get("flops_per_step")
        if label in seen or not isinstance(flops, (int, float)) or flops <= 0:
            continue
        seen.add(label)
        peak = rec.get("peak_flops_per_s")
        out.append(
            mfu_event(
                label=label,
                step_time_s=float(step_time_s),
                flops_per_step=float(flops),
                n_steps=n_steps,
                flops_source=str(rec.get("flops_source") or "analytic"),
                device_kind=str(rec.get("device_kind") or ""),
                peak_flops_per_s=float(peak) if isinstance(peak, (int, float)) else None,
                bytes_accessed_per_step=rec.get("bytes_accessed_per_step"),
                exposed_comm_fraction=_exposed_fraction(rec.get("overlap")),
                window=window,
            )
        )
    return out
