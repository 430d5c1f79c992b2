"""Bare distributed initialisation, the reference's ``ddp_guide`` and the
JAX package's ``experiments/bare_init.py``: seed with ``seed + rank``, join
the process group, emit the banners (``NoteEvent``s of the run's
registry) and tear the group down. It shows that the rendezvous and the
collective backend (NCCL on the card, Gloo on the CPU) come up.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..observe.events import NoteEvent
from ..observe.telemetry import telemetry_from_config
from ..parallel.mesh import resolve_device
from ..utils.config import ExperimentConfig
from .common import process_group


def default_config() -> ExperimentConfig:
    return ExperimentConfig(training_epochs=0)


def run(config: Optional[ExperimentConfig] = None, device="cuda") -> Dict:
    config = config or default_config()
    device = resolve_device(device)
    np.random.seed(config.seed + config.process_id)  # the reference's ddp_guide/ddp_init.py:20-21
    torch.manual_seed(config.seed + config.process_id)
    telemetry = telemetry_from_config(config)
    note = lambda msg: telemetry.emit(NoteEvent(msg))  # noqa: E731
    try:
        note("==============================")
        note(f">>>>> Distributed Initialization (PyTorch, {'NCCL' if device.type == 'cuda' else 'Gloo'}) <<<<<")
        note(
            f"Init: process {config.process_id}/{config.num_processes - 1} (total {config.num_processes})"
            f" - coordinator ({config.coordinator_address})"
        )
        with process_group(config, device) as group:
            n = dist.get_world_size(group)
            backend = dist.get_backend(group)
            note(f"All processes initialized; backend {backend}, {n} devices")
            note("==============================\n")
    finally:
        telemetry.close()
    return {
        "experiment": "bare_init",
        "num_devices": n,
        "process_id": config.process_id,
        "backend": backend,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
