"""Bare distributed initialisation, the reference's ``ddp_guide`` and the
JAX package's ``experiments/bare_init.py``: seed with ``seed + rank``, join
the process group, print the banners and tear the group down. It shows that
the rendezvous and the collective backend (NCCL on the card, Gloo on the
CPU) come up.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import resolve_device
from ..utils.config import ExperimentConfig
from .common import process_group

_log = logging.getLogger(__name__)


def default_config() -> ExperimentConfig:
    return ExperimentConfig(training_epochs=0)


def run(config: Optional[ExperimentConfig] = None, device="cuda") -> Dict:
    config = config or default_config()
    device = resolve_device(device)
    np.random.seed(config.seed + config.process_id)  # the reference's ddp_guide/ddp_init.py:20-21
    torch.manual_seed(config.seed + config.process_id)
    _log.info("==============================")
    _log.info(">>>>> Distributed Initialization (PyTorch, %s) <<<<<", "NCCL" if device.type == "cuda" else "Gloo")
    _log.info(
        "Init: process %d/%d (total %d) - coordinator (%s)",
        config.process_id, config.num_processes - 1, config.num_processes, config.coordinator_address,
    )
    with process_group(config, device) as group:
        n = dist.get_world_size(group)
        backend = dist.get_backend(group)
        _log.info("All processes initialized; backend %s, %d devices", backend, n)
        _log.info("==============================\n")
    return {
        "experiment": "bare_init",
        "num_devices": n,
        "process_id": config.process_id,
        "backend": backend,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
