"""Rank functions for the PyTorch port's multi-process tests.

This module imports torch and the port, never jax, so each rank spawned from
a test starts quickly. :func:`spawn` runs ``fn(rank, world, *args)`` in
``world`` fresh processes joined by a Gloo group with a ``file://``
rendezvous under the test's ``tmp_path`` (so parallel test workers never
share a port), and returns what each rank returned.
"""

from __future__ import annotations

import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu_torch.experiments.common import image_classifier_loss
from network_distributed_pytorch_tpu_torch.models.resnet import resnet18
from network_distributed_pytorch_tpu_torch.parallel.comm import (
    all_reduce_mean,
    chunked_all_reduce_mean,
)
from network_distributed_pytorch_tpu_torch.parallel.mesh import (
    DistributedConfig,
    initialize_distributed,
    shutdown_distributed,
)
from network_distributed_pytorch_tpu_torch.parallel.reducers import (
    ExactReducer,
    PowerSGDReducer,
    PowerSGDState,
)
from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Cap torch's intra-op threads while a port test module runs: the test
    shapes are small, and the suite shares the machine's cores with
    parallel test workers and spawned ranks."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)


def _entry(fn, rank, world, init_file, out_dir, args):
    torch.set_num_threads(1)
    group = initialize_distributed(
        DistributedConfig(
            process_id=rank,
            num_processes=world,
            coordinator_address=f"file://{init_file}",
            timeout_seconds=120,
        ),
        torch.device("cpu"),
    )
    try:
        torch.save(fn(rank, world, group, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown_distributed()


def spawn(fn, world: int, tmp_path, *args, timeout: float = 180.0):
    ctx = mp.get_context("spawn")
    init_file = os.path.join(str(tmp_path), "rendezvous")
    procs = [
        ctx.Process(target=_entry, args=(fn, rank, world, init_file, str(tmp_path), args))
        for rank in range(world)
    ]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for rank, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join()
            raise TimeoutError(f"rank {rank} did not finish in {timeout} s")
        if p.exitcode != 0:
            raise RuntimeError(f"rank {rank} exited with {p.exitcode}")
    return [torch.load(os.path.join(str(tmp_path), f"rank{r}.pt")) for r in range(world)]


def run_all(rank, world, group, calls):
    """Several rank functions in one spawn of ranks, so a test module pays
    the ranks' start-up (a fresh interpreter importing torch) once:
    ``calls`` is a list of ``(fn, args)``; returns each ``fn``'s result."""
    return [fn(rank, world, group, *args) for fn, args in calls]


# ---- comm and reducers ------------------------------------------------------


def comm_rank(rank, world, group, n, chunk_counts):
    """One all-reduce of a rank-specific buffer, then the same buffer as K
    chunked collectives for each K."""
    gen = torch.Generator().manual_seed(100 + rank)
    x = torch.randn(n, generator=gen)
    mono = chunked_all_reduce_mean(x.clone(), group, None)
    chunked = {k: chunked_all_reduce_mean(x.clone(), group, k) for k in chunk_counts}
    plain = all_reduce_mean(x.clone(), group)
    return {"x": x, "mono": mono, "chunked": chunked, "plain": plain}


def powersgd_rank(rank, world, group, sends_per_rank, q_memory, kwargs):
    """A warm-start chain of PowerSGD reductions; ``sends_per_rank[rank][s]``
    is this rank's list of torch-layout tensors at step ``s``."""
    sends_by_step = sends_per_rank[rank]
    reducer = PowerSGDReducer(**kwargs)
    state = reducer.init(sends_by_step[0])
    state = PowerSGDState(q_memory.clone(), state.generator)
    outs = []
    for sends in sends_by_step:
        state, out, mem, bits = reducer.reduce(state, sends, group)
        outs.append({"out": [o.contiguous() for o in out], "mem": mem, "bits": bits})
    return {"steps": outs, "q_memory": state.q_memory}


def powersgd_ef_rank(rank, world, group, grads_per_rank, q_memory, kwargs):
    """An error-feedback chain (``reduce_ef``, memories carried from step to
    step) on each compress pipeline, from the same Q; ``grads_per_rank[rank][s]``
    is this rank's list of torch-layout gradients at step ``s``."""
    out = {}
    for impl in ("xla", "pallas"):
        reducer = PowerSGDReducer(compress_impl=impl, **kwargs)
        grads = grads_per_rank[rank]
        state = PowerSGDState(q_memory.clone(), reducer.init(grads[0]).generator)
        mems = [torch.zeros_like(g) for g in grads[0]]
        steps = []
        for g in grads:
            state, delta, mems, bits = reducer.reduce_ef(state, g, mems, group)
            steps.append({"out": [d.contiguous() for d in delta], "mem": [m.contiguous() for m in mems], "bits": bits})
        out[impl] = {"steps": steps, "q_memory": state.q_memory}
    return out


def exact_rank(rank, world, group, sends_per_rank):
    _, out, mem, bits = ExactReducer().reduce({}, sends_per_rank[rank], group)
    return {"out": out, "mem": mem, "bits": bits}


# ---- training ---------------------------------------------------------------


def powersgd_train_rank(rank, world, group, state_dict, q_memory, batches, lr):
    """Two ``ef_momentum`` PowerSGD steps of the small ResNet-18 from carried
    weights; ``batches`` are global batches, each rank takes its slice."""
    model = resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device="cpu")
    model.load_state_dict(state_dict)
    reducer = PowerSGDReducer(random_seed=1, compression_rank=4, matricize="last")
    step = make_train_step(image_classifier_loss(), reducer, model, lr, 0.9, "ef_momentum", group)
    state = step.init_state()
    state.reducer_state = PowerSGDState(q_memory.clone(), state.reducer_state.generator)
    losses = []
    for x, y in batches:
        b = len(x) // world
        local = (torch.from_numpy(x[rank * b : (rank + 1) * b]), torch.from_numpy(y[rank * b : (rank + 1) * b]))
        state, loss = step(state, local)
        losses.append(float(loss))
    detach = lambda d: {k: v.detach().clone() for k, v in d.items()}
    return {
        "losses": losses,
        "params": detach(state.params),
        "momenta": detach(state.momenta),
        "memories": detach(state.memories),
        "buffers": detach(state.model_state),
        "bits_per_step": step.bits_per_step,
    }


class TinyConvNet(torch.nn.Module):
    """A stateless model (no BatchNorm) for the exact-DDP check, where a
    sharded batch must give exactly the large-batch gradient."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(3)
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.fc = torch.nn.Linear(4 * 8 * 8, 10)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(0.2 * torch.randn(p.shape, generator=gen))

    def forward(self, x_nhwc):
        x = torch.relu(self.conv(x_nhwc.permute(0, 3, 1, 2)))
        return self.fc(x.flatten(1))


def exact_ddp_steps(rank, world, group, batches):
    """``sgd`` steps with the exact reducer; each rank takes its slice of
    every global batch. Returns the final parameters and the losses."""
    model = TinyConvNet()
    step = make_train_step(image_classifier_loss(), ExactReducer(), model, 0.05, 0.9, "sgd", group)
    state = step.init_state()
    losses = []
    for x, y in batches:
        b = len(x) // world
        local = (torch.from_numpy(x[rank * b : (rank + 1) * b]), torch.from_numpy(y[rank * b : (rank + 1) * b]))
        state, loss = step(state, local)
        losses.append(float(loss))
    return {"params": {k: v.detach().clone() for k, v in state.params.items()}, "losses": losses}


def numpy_batches(seed: int, n_steps: int, batch: int, hw: int = 32):
    rng = np.random.RandomState(seed)
    return [
        (
            rng.randn(batch, hw, hw, 3).astype(np.float32),
            rng.randint(0, 10, size=batch).astype(np.int32),
        )
        for _ in range(n_steps)
    ]
