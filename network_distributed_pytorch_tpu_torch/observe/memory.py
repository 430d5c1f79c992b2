"""Device memory, the JAX package's ``observe/memory.py`` for the port.

- :func:`device_memory_stats`: the caching allocator's view of one card
  (``torch.cuda.memory_stats``) in the JAX package's vocabulary:
  ``bytes_in_use`` is ``allocated_bytes.all.current``,
  ``peak_bytes_in_use`` is ``allocated_bytes.all.peak`` and
  ``bytes_limit`` is the card's total memory.
- :class:`MemorySampler`: one read every ``health_every`` steps, emitted as
  a :class:`~.events.MemoryEvent`. Where there is no card (the CPU) the
  first read comes back empty and the sampler turns itself off: no event
  and no log line after that.
- :func:`build_oom_report` and :func:`write_oom_report`: the post-mortem a
  guarded step writes when the card runs out of memory, its buffer
  classes ranked by bytes beside the last live sample.
- :func:`tree_bytes`: the bytes a nest of tensors holds (a KV cache, a
  block pool, the parameters).

The JAX package's compile-time footprint (``memory_footprint_fields``)
has no counterpart in eager PyTorch: a ``CompileEvent`` of the port leaves
those fields None, as the JAX package does on a backend without
``memory_analysis``. The module reads no clock: events are stamped by the
telemetry.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import torch

from .events import MemoryEvent

OOM_REPORT_NAME = "oom_report.json"


def device_memory_stats(device=None) -> Optional[Dict]:
    """``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}`` (floats)
    of a CUDA ``device`` (the current one when None); None where there is
    no CUDA device to read, as the JAX package returns None on the CPU."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return None
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    limit = torch.cuda.get_device_properties(device if device is not None else torch.cuda.current_device()).total_memory
    return {
        "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": float(limit),
    }


class MemorySampler:
    """A device-memory probe at the ``health_every`` cadence.

    ``sample(step)`` reads :func:`device_memory_stats` and emits one
    :class:`MemoryEvent` through the telemetry. The first read that comes
    back empty turns the sampler off for good (``enabled`` goes False): a
    CPU run reads once and then does nothing."""

    def __init__(self, telemetry, label: str = "", rank: Optional[int] = None, device=None):
        self._telemetry = telemetry
        self._label = label
        self._rank = rank
        self._device = device
        self.enabled = True
        self.last: Optional[MemoryEvent] = None

    def sample(self, step: int) -> Optional[MemoryEvent]:
        if not self.enabled:
            return None
        stats = device_memory_stats(self._device)
        if not stats:
            self.enabled = False
            return None
        event = MemoryEvent(
            step=int(step),
            bytes_in_use=stats["bytes_in_use"],
            peak_bytes_in_use=stats["peak_bytes_in_use"],
            bytes_limit=stats["bytes_limit"],
            device_kind=torch.cuda.get_device_name(self._device),
            rank=self._rank,
            label=self._label,
        )
        self.last = event
        if self._telemetry is not None:
            self._telemetry.emit(event)
        return event


def tree_bytes(tree) -> int:
    """Bytes held by the tensors in ``tree`` (nested lists, tuples and dict
    values); 0 for None or an empty nest, nothing for other leaves."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def build_oom_report(
    error: str = "",
    label: str = "",
    rank: Optional[int] = None,
    step: Optional[int] = None,
    last_memory: Optional[Dict] = None,
    footprint: Optional[Dict] = None,
    buffers: Optional[Dict[str, float]] = None,
) -> Dict:
    """The out-of-memory post-mortem: buffer classes ranked by bytes
    (largest first; ``top_buffer`` names the leading suspect), the last
    live ``MemoryEvent`` record and the footprint split where known."""
    ranked: List[Dict] = sorted(
        (
            {"name": str(name), "bytes": float(b)}
            for name, b in (buffers or {}).items()
            if isinstance(b, (int, float)) and b >= 0
        ),
        key=lambda row: -row["bytes"],
    )
    return {
        "schema": 1,
        "kind": "oom",
        "label": label,
        "rank": rank,
        "step": step,
        "error": str(error)[:2000],
        "last_memory": dict(last_memory) if last_memory else None,
        "footprint": dict(footprint) if footprint else None,
        "buffers": ranked,
        "top_buffer": ranked[0]["name"] if ranked else None,
    }


def write_oom_report(report: Dict, path: Optional[str] = None) -> str:
    """Write the post-mortem (by default ``artifacts/oom_report.json``)
    atomically: the process is about to die, and a torn file would be
    worse than none."""
    if path is None:
        path = os.path.join("artifacts", OOM_REPORT_NAME)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1, default=str)
    os.replace(tmp, path)
    return path
