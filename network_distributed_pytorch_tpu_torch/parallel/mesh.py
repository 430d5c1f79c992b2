"""L1: process group and rendezvous over ``torch.distributed``.

The JAX package's ``DistributedConfig`` / ``initialize_distributed`` become
``torch.distributed.init_process_group``: NCCL for ranks on CUDA devices,
Gloo for ranks on the CPU, with the configured timeout. A failed rendezvous
raises; nothing falls through. A world of one still creates a group, so a
one-card run goes through NCCL like a larger one.
"""

from __future__ import annotations

import datetime
import socket
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    the CPU; asking for CUDA where there is no card raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


@dataclass
class DistributedConfig:
    process_id: int = 0
    num_processes: int = 1
    # init_method: "tcp://host:port", "file:///path" or "env://"; None = a
    # free localhost port for a world of one, the torchrun environment else
    coordinator_address: Optional[str] = None
    timeout_seconds: int = 600


def _free_localhost_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(config: DistributedConfig, device: torch.device):
    """Join (or create) the default process group and return it.

    On CUDA the rank's current device is set to ``device`` first, so NCCL
    binds the right card."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    backend = "nccl" if device.type == "cuda" else "gloo"
    init_method = config.coordinator_address
    if init_method is None:
        init_method = (
            f"tcp://127.0.0.1:{_free_localhost_port()}"
            if config.num_processes == 1
            else "env://"
        )
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend=backend,
        init_method=init_method,
        world_size=config.num_processes,
        rank=config.process_id,
        timeout=datetime.timedelta(seconds=config.timeout_seconds),
    )
    return dist.group.WORLD


def shutdown_distributed() -> None:
    """``destroy_process_group``; a no-op when no group exists."""
    if dist.is_initialized():
        dist.destroy_process_group()
