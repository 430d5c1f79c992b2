"""L1: process group and rendezvous over ``torch.distributed``.

The JAX package's ``DistributedConfig`` / ``initialize_distributed`` become
``torch.distributed.init_process_group``: NCCL for ranks on CUDA devices,
Gloo for ranks on the CPU, with the configured timeout. A failed rendezvous
raises; nothing falls through. A world of one still creates a group, so a
one-card run goes through NCCL like a larger one.

:func:`make_mesh` lays named axes over the ranks of the world, as the JAX
package's ``make_mesh`` lays them over devices: a mesh axis is the family
of subgroups along it, and :class:`ProcessMesh` gives each rank its
coordinate, the axes' sizes and its subgroup of each axis.
"""

from __future__ import annotations

import datetime
import itertools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

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
    # localhost store on a port the OS picks for a world of one, the
    # torchrun environment else
    coordinator_address: Optional[str] = None
    timeout_seconds: int = 600


def initialize_distributed(config: DistributedConfig, device: torch.device):
    """Join (or create) the default process group and return it.

    On CUDA the rank's current device is set to ``device`` first, so NCCL
    binds the right card. A world of one with no address gets its own
    store on localhost, bound to a port the OS picks in the same call: a
    port probed free and bound later can be taken in between (by another
    process, or by a socket of an earlier group on another address)."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    backend = "nccl" if device.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=config.timeout_seconds)
    init_method, store = config.coordinator_address, None
    if init_method is None:
        if config.num_processes == 1:
            store = dist.TCPStore(
                "127.0.0.1", 0, 1, is_master=True, timeout=timeout, wait_for_workers=False
            )
        else:
            init_method = "env://"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend=backend,
        init_method=init_method,
        store=store,
        world_size=config.num_processes,
        rank=config.process_id,
        timeout=timeout,
    )
    return dist.group.WORLD


def shutdown_distributed() -> None:
    """``destroy_process_group``; a no-op when no group exists."""
    if dist.is_initialized():
        dist.destroy_process_group()


class ProcessMesh:
    """Named axes over the ranks of a process group. ``coord`` is this
    rank's coordinate and
    ``groups`` maps each axis name to this rank's subgroup along it: the
    ranks whose coordinates differ only on that axis, in axis order, so a
    rank's index in the subgroup is its index on the axis."""

    def __init__(self, axis_names, axis_sizes, coord, groups):
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.axis_sizes: Tuple[int, ...] = tuple(axis_sizes)
        self.coord: Tuple[int, ...] = coord
        self.groups: Dict[str, object] = groups

    def _axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"mesh has axes {self.axis_names}, not {name!r}")
        return self.axis_names.index(name)

    def axis_size(self, name: str) -> int:
        return self.axis_sizes[self._axis(name)]

    def axis_index(self, name: str) -> int:
        """This rank's index along ``name`` (``lax.axis_index``)."""
        return self.coord[self._axis(name)]

    def group(self, name: str):
        """This rank's subgroup along ``name`` (None for a size-1 axis of a
        mesh of more than one rank)."""
        self._axis(name)
        return self.groups[name]


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]) -> ProcessMesh:
    """A mesh of ``axis_sizes`` over the ranks of the default group. Rank
    ``r`` takes the row-major coordinate ``unravel_index(r, axis_sizes)``,
    the last axis fastest: the place of device ``r`` in the JAX package's
    ``make_mesh``, so a batch shard lands on the same rank in both packages.

    Every rank calls it: subgroups are created with ``dist.new_group``,
    which every process must enter, in the same order, including the groups
    it is not in (NCCL and Gloo hang otherwise). A slice that spans the
    whole world reuses the default group, so a world of one creates no
    communicator of its own and still runs its collectives through the
    group's backend; in a mesh of more ranks, a size-1 axis has the group
    None, for which the collectives of ``parallel.comm`` are identities."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group")
    axis_sizes = tuple(int(n) for n in axis_sizes)
    axis_names = tuple(axis_names)
    if len(axis_sizes) != len(axis_names) or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"axis sizes {axis_sizes} and names {axis_names} do not pair up")
    world, me = dist.get_world_size(), dist.get_rank()
    if math.prod(axis_sizes) != world:
        raise ValueError(f"mesh axis sizes {axis_sizes} do not cover {world} ranks")
    coord = tuple(reversed(list(_unravel(me, axis_sizes))))
    strides = [math.prod(axis_sizes[i + 1 :]) for i in range(len(axis_sizes))]
    groups: Dict[str, object] = {}
    for a, name in enumerate(axis_names):
        for rest in itertools.product(*(range(n) for i, n in enumerate(axis_sizes) if i != a)):
            base = sum(c * s for c, s in zip(rest[:a] + (0,) + rest[a:], strides))
            members = [base + i * strides[a] for i in range(axis_sizes[a])]
            if len(members) == world:
                sub = dist.group.WORLD
            elif len(members) == 1:
                sub = None  # a size-1 axis of a larger mesh: nothing to send
            else:
                sub = dist.new_group(members)
            if me in members:
                groups[name] = sub
    # one collective on each new group, axis by axis, before any
    # point-to-point use: NCCL wants a group's first operation to span all
    # its ranks, and a pipeline's first sends pair only neighbours
    for name in axis_names:
        if groups[name] is not None and groups[name] is not dist.group.WORLD:
            dist.barrier(group=groups[name])
    return ProcessMesh(axis_names, axis_sizes, coord, groups)


def _unravel(index: int, sizes: Sequence[int]):
    """The digits of ``index`` in the mixed radix ``sizes``, LAST axis
    first."""
    for size in reversed(sizes):
        yield index % size
        index //= size
