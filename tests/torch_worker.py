"""Rank functions for the PyTorch port's multi-process tests.

This module imports torch and the port, never jax, so each rank spawned from
a test starts quickly. :func:`spawn` runs ``fn(rank, world, *args)`` in
``world`` fresh processes joined by a Gloo group with a ``file://``
rendezvous under the test's ``tmp_path`` (so parallel test workers never
share a port), and returns what each rank returned.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import signal

import numpy as np
import pytest
import torch
import torch.distributed as dist

from network_distributed_pytorch_tpu_torch import launch
from network_distributed_pytorch_tpu_torch.experiments import bandwidth_study, exact_cifar10, imdb_baseline
from network_distributed_pytorch_tpu_torch.experiments.common import (
    average_model_state,
    image_classifier_loss,
    resilient_train_loop,
)
from network_distributed_pytorch_tpu_torch.models.cnn import SmallCNN
from network_distributed_pytorch_tpu_torch.models.import_weights import fsdp_state_from_jax, train_state_from_jax
from network_distributed_pytorch_tpu_torch.models.resnet import resnet18
from network_distributed_pytorch_tpu_torch.parallel import compression
from network_distributed_pytorch_tpu_torch.parallel.comm import (
    all_reduce_mean,
    chunked_all_reduce_mean,
    record_collectives,
    recorded_bits,
    ring_all_reduce_mean,
)
from network_distributed_pytorch_tpu_torch.parallel.compression import QSGDReducer, SignSGDReducer, TopKReducer
from network_distributed_pytorch_tpu_torch.parallel.fsdp import make_fsdp_train_step
from network_distributed_pytorch_tpu_torch.parallel.hierarchical import HierarchicalReducer, make_hierarchical_groups
from network_distributed_pytorch_tpu_torch.parallel.localsgd import (
    drift_stats,
    make_diloco_train_fn,
    make_local_sgd_train_fn,
    make_streaming_diloco_train_fn,
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
from network_distributed_pytorch_tpu_torch.resilience import (
    ChaosPlan,
    FaultSpec,
    PreemptionGuard,
    make_topology,
    reshard_from_checkpoint,
)
from network_distributed_pytorch_tpu_torch.resilience.reshard import mesh_coord, split_tp_leaf
from network_distributed_pytorch_tpu_torch.utils.checkpoint import (
    TopologyMismatchError,
    read_topology,
    restore_checkpoint,
    restore_checkpoint_sharded,
    restore_latest,
    save_checkpoint,
)
from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig


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


def ring_rank(rank, world, group, xs, n_chunks):
    """This rank's ``xs[rank]`` through the explicit ring, through
    ``n_chunks`` chunked rings, and through one all-reduce-mean."""
    x = xs[rank]
    return {
        "ring": ring_all_reduce_mean(x.clone(), group),
        "chunked_ring": chunked_all_reduce_mean(x.clone(), group, n_chunks, "ring"),
        "mean": all_reduce_mean(x.clone(), group),
    }


def exact_layouts_rank(rank, world, group, sends_per_rank, layouts):
    """``ExactReducer.reduce`` of this rank's tensors under each layout
    (``{name: constructor kwargs}``): the reduced tensors and the bits."""
    out = {}
    for name, kw in layouts.items():
        _, reduced, mem, bits = ExactReducer(**kw).reduce({}, [t.clone() for t in sends_per_rank[rank]], group)
        assert all(torch.count_nonzero(m) == 0 for m in mem)
        out[name] = {"out": [t.contiguous() for t in reduced], "bits": bits}
    return out


def average_state_rank(rank, world, group):
    """``average_model_state`` over a small ResNet whose floating-point
    buffers hold ``rank + 1`` and whose batch counters hold ``10 + rank``."""
    model = resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device="cpu")
    with torch.no_grad():
        for name, b in model.named_buffers():
            b.fill_(10 + rank if name.endswith("num_batches_tracked") else rank + 1)
    average_model_state(model, group)
    return {k: v.clone() for k, v in model.named_buffers()}


def exact_cifar10_rank(rank, world, group, cfg_kwargs, steps):
    """``exact_cifar10.run`` of the small preset on this rank, joining the
    spawned group, with the evaluation after it."""
    cfg = ExperimentConfig(process_id=rank, num_processes=world, **cfg_kwargs)
    return exact_cifar10.run(cfg, preset="small", device="cpu", max_steps_per_epoch=steps, eval_after=True)


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


def multihost_rank(rank, world, group, init, batches, vocab_file, texts):
    """The port's form of the JAX package's ``tests/multiprocess_worker.py``:
    the initial weights placed from the host (``global_state_from_host``),
    each rank fed only its own contiguous shard of every global batch
    (``global_batch_from_local``), ``sgd`` steps with the exact reducer;
    and this rank's shard of a WordPiece encode (``encode_shard``)."""
    from network_distributed_pytorch_tpu_torch.data.multihost import global_batch_from_local, global_state_from_host
    from network_distributed_pytorch_tpu_torch.data.wordpiece import WordPieceTokenizer

    model = TinyConvNet()
    model.load_state_dict(global_state_from_host(init, "cpu"))
    step = make_train_step(image_classifier_loss(), ExactReducer(), model, 0.05, 0.9, "sgd", group)
    state = step.init_state()
    losses = []
    for x, y in batches:
        b = len(x) // world
        local = global_batch_from_local((x[rank * b : (rank + 1) * b], y[rank * b : (rank + 1) * b]), "cpu")
        state, loss = step(state, local)
        losses.append(float(loss))
    shard = WordPieceTokenizer(vocab_file, max_len=16).encode_shard(texts, world, rank)
    return {
        "params": {k: v.detach().clone() for k, v in state.params.items()}, "losses": losses,
        "shard": {k: torch.from_numpy(v) for k, v in shard.items()},
    }


def numpy_batches(seed: int, n_steps: int, batch: int, hw: int = 32):
    rng = np.random.RandomState(seed)
    return [
        (
            rng.randn(batch, hw, hw, 3).astype(np.float32),
            rng.randint(0, 10, size=batch).astype(np.int32),
        )
        for _ in range(n_steps)
    ]


# ---- gather-based compressors -------------------------------------------------


def plain_records(records):
    """``(kind, ranks, payload_bytes)`` of each record: plain tuples, which
    the ranks' results can carry back."""
    return [(r.kind, r.ranks, r.payload_bytes) for r in records]


class FedNoiseQSGD(QSGDReducer):
    """Stochastic QSGD whose rounding noise is given, one ``(n,)`` tensor a
    rank (the JAX package's key schedule, computed by the test)."""

    def __init__(self, noises):
        super().__init__(stochastic=True)
        self.noises = noises

    def noise(self, state, n, device, rank):
        return self.noises[rank].to(device)


def make_compressor(name: str, noises=None):
    """The compressor a test names: ``topk`` (10 %), ``signsgd``, ``qsgd``
    (deterministic rounding) or ``qsgd_stochastic`` (with ``noises``)."""
    if name == "topk":
        return TopKReducer(k_fraction=0.1)
    if name == "signsgd":
        return SignSGDReducer()
    if name == "qsgd":
        return QSGDReducer(random_seed=3, stochastic=False)
    if name == "qsgd_stochastic":
        return FedNoiseQSGD(noises)
    raise ValueError(name)


def compressor_rank(rank, world, group, name, sends_per_rank, noises=None):
    """One ``reduce`` of this rank's tensors: the result, the payloads this
    rank sent through ``all_gather`` and the collectives recorded."""
    sent = []
    inner = compression.all_gather
    compression.all_gather = lambda x, g: (sent.append(x.clone()), inner(x, g))[1]
    try:
        reducer = make_compressor(name, noises)
        sends = sends_per_rank[rank]
        with record_collectives() as records:
            _, out, mem, bits = reducer.reduce(reducer.init(sends), sends, group)
    finally:
        compression.all_gather = inner
    return {
        "out": out, "mem": mem, "bits": bits, "sent": sent, "records": plain_records(records),
        "bits_per_step": reducer.bits_per_step(sends, world),
    }


def compressor_train_rank(rank, world, group, name, batch, steps):
    """``steps`` ef_momentum steps of a tiny SmallCNN with compressor
    ``name`` on one fixed global batch, each rank on its half; the losses,
    the step's bits and the bits recorded in one step."""
    model = SmallCNN(width=4, image_size=8, device="cpu", seed=1)
    reducer = make_compressor(name) if name != "qsgd" else QSGDReducer(random_seed=1)
    step = make_train_step(image_classifier_loss(), reducer, model, 0.05, 0.9, "ef_momentum", group)
    state = step.init_state()
    x, y = batch
    b = len(x) // world
    local = (torch.from_numpy(x[rank * b : (rank + 1) * b]), torch.from_numpy(y[rank * b : (rank + 1) * b]))
    losses, recorded = [], None
    for _ in range(steps):
        with record_collectives() as records:
            state, loss = step(state, local)
        recorded = recorded_bits(records)
        losses.append(float(loss))
    return {"losses": losses, "bits_per_step": step.bits_per_step, "recorded_bits": recorded}


_DIST_CALLS = (
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object", "broadcast",
    "reduce", "reduce_scatter", "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
    "send", "recv", "batch_isend_irecv", "gather", "scatter",
)  # isend and irecv stay: P2POp accepts only the functions themselves


def bypass_rank(rank, world, group, sends_per_rank, batch):
    """Every ``torch.distributed`` collective issued while each reducer (and
    a training step) runs, counted at its outermost call, against the
    records of :func:`record_collectives`."""
    calls = {"n": 0, "depth": 0}

    def counted(fn):
        def wrapper(*args, **kwargs):
            calls["n"] += calls["depth"] == 0
            calls["depth"] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                calls["depth"] -= 1
        return wrapper

    saved = {name: getattr(dist, name) for name in _DIST_CALLS}
    for name, fn in saved.items():
        setattr(dist, name, counted(fn))
    out = {}
    try:
        sends = sends_per_rank[rank]
        reducers = {
            "exact": ExactReducer(), "exact_per_tensor": ExactReducer(packed=False),
            "exact_ring_chunks": ExactReducer(comm_chunks=3, comm_strategy="ring"),
            "exact_buckets": ExactReducer(bucket_bytes=64),
            "powersgd": PowerSGDReducer(compression_rank=2, matricize="last", n_power_iterations=1),
            "powersgd_fused": PowerSGDReducer(compression_rank=2, matricize="last", compress_impl="pallas"),
            "topk": TopKReducer(0.1), "signsgd": SignSGDReducer(), "qsgd": QSGDReducer(),
        }
        for name, reducer in reducers.items():
            before = calls["n"]
            with record_collectives() as records:
                reducer.reduce_ef(reducer.init(sends), sends, [torch.zeros_like(s) for s in sends], group)
            out[name] = (calls["n"] - before, len(records))
        model = SmallCNN(width=4, image_size=8, device="cpu", seed=1)
        step = make_train_step(image_classifier_loss(), TopKReducer(0.1), model, 0.05, 0.9, "ef_momentum", group)
        before = calls["n"]
        with record_collectives() as records:
            step(step.init_state(), tuple(torch.from_numpy(a) for a in batch))
        out["train_step"] = (calls["n"] - before, len(records))
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
    return out


# ---- local SGD and DiLoCo -------------------------------------------------------


class LinReg(torch.nn.Module):
    """``x @ w + b`` from zeros, the JAX package's local-SGD test problem."""

    def __init__(self, n_in=16, n_out=4):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(n_in, n_out))
        self.b = torch.nn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return x @ self.w + self.b


def mse_loss(model, batch):
    x, y = batch
    return torch.mean((model(x) - y) ** 2)


def regression_problem(seed=0, n=64):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(16, 4).astype(np.float32)
    x = rng.randn(n, 16).astype(np.float32)
    return x, (x @ w_true).astype(np.float32)


def shard(batch, rank, world):
    """This rank's contiguous slice of a global numpy batch, as tensors."""
    b = len(batch[0]) // world
    return tuple(torch.from_numpy(np.ascontiguousarray(a[rank * b : (rank + 1) * b])) for a in batch)


def _clone(d):
    return {k: v.detach().clone() for k, v in d.items()}


def round_parity_rank(rank, world, group, sd, q_port, rounds, lr):
    """Local SGD and DiLoCo (exact and PowerSGD outer reducers, the latter
    from the injected Q) on the tiny SmallCNN over ``rounds`` (each a list
    of global batches); after each round the parameters, losses and the
    bits recorded, and at the end the per-rank state."""
    out = {}
    for kind in ("local_sgd", "diloco_exact", "diloco_powersgd"):
        model = SmallCNN(width=4, image_size=8, device="cpu")
        model.load_state_dict(sd)
        h = len(rounds[0])
        if kind == "local_sgd":
            fn = make_local_sgd_train_fn(image_classifier_loss(), model, lr, 0.9, h, "sgd", group)
        else:
            reducer = (
                PowerSGDReducer(random_seed=1, compression_rank=2, matricize="last")
                if kind == "diloco_powersgd" else ExactReducer()
            )
            fn = make_diloco_train_fn(
                image_classifier_loss(), model, inner_learning_rate=lr, sync_every=h, reducer=reducer, group=group
            )
        state = fn.init_state()
        if kind == "diloco_powersgd":
            state.reducer_state = PowerSGDState(q_port.clone(), state.reducer_state.generator)
        per_round = []
        for batches in rounds:
            with record_collectives() as records:
                state, losses = fn(state, [shard(b, rank, world) for b in batches])
            per_round.append({
                "params": _clone(state.params), "losses": losses.clone(),
                "recorded_bits": recorded_bits(records), "collectives": len(records),
            })
        res = {"rounds": per_round, "bits_per_round": fn.bits_per_round, "buffers": _clone(dict(model.named_buffers()))}
        if kind == "local_sgd":
            res["momenta"] = _clone(state.momenta)
        else:
            res.update(
                memories=_clone(state.memories), outer_momenta=_clone(state.outer_momenta),
                inner_momenta=_clone(state.inner_opt),
            )
            if kind == "diloco_powersgd":
                res["q_memory"] = state.reducer_state.q_memory.clone()
        out[kind] = res
    return out


def h1_local_sgd_vs_ddp_rank(rank, world, group, steps):
    """Local SGD at H = 1 with plain SGD, and exact DDP's plain-SGD step, on
    the regression problem: each one's losses and final parameters."""
    batch = shard(regression_problem(), rank, world)
    model = LinReg()
    local = make_local_sgd_train_fn(mse_loss, model, 0.05, sync_every=1, algorithm="sgd_plain", group=group)
    lstate, llosses = local.init_state(), []
    for _ in range(steps):
        lstate, losses = local(lstate, [batch])
        llosses.append(float(losses[0]))
    ddp_model = LinReg()
    ddp = make_train_step(mse_loss, ExactReducer(), ddp_model, 0.05, algorithm="sgd_plain", group=group)
    dstate, dlosses = ddp.init_state(), []
    for _ in range(steps):
        dstate, loss = ddp(dstate, batch)
        dlosses.append(float(loss))
    return {"local": (llosses, _clone(lstate.params)), "ddp": (dlosses, _clone(dstate.params))}


def identity_outer_rank(rank, world, group, rounds, h):
    """DiLoCo at the identity outer step (outer lr 1, no momentum, exact)
    and local SGD, ``rounds`` rounds of ``h`` steps on the regression
    problem: their losses and parameters after each round."""
    batch = shard(regression_problem(), rank, world)
    diloco = make_diloco_train_fn(
        mse_loss, LinReg(), inner_learning_rate=0.05, outer_learning_rate=1.0, outer_momentum=0.0,
        sync_every=h, group=group,
    )
    local = make_local_sgd_train_fn(mse_loss, LinReg(), 0.05, sync_every=h, algorithm="sgd", group=group)
    out = {"diloco": [], "local": []}
    for name, fn in (("diloco", diloco), ("local", local)):
        state = fn.init_state()
        for _ in range(rounds):
            state, losses = fn(state, [batch] * h)
            out[name].append((losses.clone(), _clone(fn.eval_params(state))))
    return out


def padded_round_rank(rank, world, group):
    """The pad-and-mask contract on the regression problem: a round of 4
    slots fed 3 batches and a zero (or NaN) pad of weight 0, a round of 3,
    and a round of 4 with and without all-ones weights; parameters, losses
    and recorded bits of each."""
    batch = shard(regression_problem(), rank, world)
    zero_pad = tuple(torch.zeros_like(t) for t in batch)
    nan_pad = tuple(torch.full_like(t, float("nan")) for t in batch)
    out = {}
    for name, h, batches, weights in (
        ("zero_pad", 4, [batch] * 3 + [zero_pad], [1.0, 1.0, 1.0, 0.0]),
        ("nan_pad", 4, [batch] * 3 + [nan_pad], torch.tensor([1.0, 1.0, 1.0, 0.0])),
        ("short", 3, [batch] * 3, None),
        ("ones", 4, [batch] * 4, torch.ones(4)),
        ("none", 4, [batch] * 4, None),
    ):
        fn = make_diloco_train_fn(mse_loss, LinReg(), inner_learning_rate=0.05, sync_every=h, group=group)
        state = fn.init_state()
        with record_collectives() as records:
            state, losses = fn(state, batches, weights)
        out[name] = {
            "params": _clone(state.params), "momenta": _clone(state.inner_opt), "losses": losses.clone(),
            "recorded_bits": recorded_bits(records), "bits_per_round": fn.bits_per_round,
        }
    return out


def adamw_inner_rank(rank, world, group, rounds, h):
    """DiLoCo with a torch AdamW inner (the paper's recipe): the first and
    last losses, and the inner optimizer's step count on this rank."""
    batch = shard(regression_problem(), rank, world)
    fn = make_diloco_train_fn(
        mse_loss, LinReg(), sync_every=h, inner_algorithm="optax",
        inner_optimizer=lambda ps: torch.optim.AdamW(ps, lr=3e-2), group=group,
    )
    state = fn.init_state()
    losses = []
    for _ in range(rounds):
        state, round_losses = fn(state, [batch] * h)
        losses.append(round_losses.clone())
    steps = [int(s["step"]) for s in state.inner_opt.state.values()]
    return {"losses": losses, "adam_steps": steps, "params": _clone(state.params)}


def streaming_rank(rank, world, group, sd, rounds, lr, h):
    """Streaming DiLoCo (K = 2, exact outer reducer) on the tiny SmallCNN
    over ``rounds``, the parameters after each phase, the anchors, the
    recorded bits and the drift; then K = 1 against plain DiLoCo on the
    regression problem (four phases, the parameters after each)."""
    model = SmallCNN(width=4, image_size=8, device="cpu")
    model.load_state_dict(sd)
    stream = make_streaming_diloco_train_fn(image_classifier_loss(), model, lr, num_fragments=2, sync_every=h, group=group)
    state = stream.init_state()
    phases = []
    for batches in rounds:
        with record_collectives() as records:
            state, losses = stream(state, [shard(b, rank, world) for b in batches])
        phases.append({
            "params": _clone(state.params), "anchors": _clone(state.anchors), "losses": losses.clone(),
            "recorded_bits": recorded_bits(records), "phase": state.phase,
        })
    out = {
        "phases": phases, "bits_per_phase": stream.bits_per_phase, "fragments": stream.fragments,
        "memories": _clone(state.memories), "outer_momenta": _clone(state.outer_momenta),
        "drift": drift_stats(state, group), "eval_params": _clone(stream.eval_params(state)),
    }
    batch = shard(regression_problem(), rank, world)
    one = make_streaming_diloco_train_fn(mse_loss, LinReg(), 0.05, num_fragments=1, sync_every=h, group=group)
    plain = make_diloco_train_fn(mse_loss, LinReg(), inner_learning_rate=0.05, sync_every=h, group=group)
    s1, sp = one.init_state(), plain.init_state()
    k1 = []
    for r in range(4):
        s1, l1 = one(s1, [batch] * h, round_index=r)
        sp, lp = plain(sp, [batch] * h)
        k1.append({"stream": (l1.clone(), _clone(s1.params)), "plain": (lp.clone(), _clone(sp.params))})
    out["k1"] = k1
    return out


# ---- the hierarchical reducer and the study ---------------------------------------


def hierarchical_rank(rank, world, group, sends_per_rank, q_memory, steps):
    """On a 2 x (W / 2) grid: exact hierarchical against flat exact DDP
    (``steps`` sgd steps of the regression problem), one hierarchical
    PowerSGD reduction of this rank's tensors from the injected Q with its
    collectives recorded, and the groups' ranks."""
    inner, outer, inner_world, outer_world = make_hierarchical_groups(2, group)
    batch = shard(regression_problem(), rank, world)
    runs = {}
    for name, reducer in (
        ("hier", HierarchicalReducer(ExactReducer(), inner, outer, inner_world, outer_world)),
        ("flat", ExactReducer()),
    ):
        step = make_train_step(mse_loss, reducer, LinReg(), 0.05, 0.9, "sgd", group)
        state, losses = step.init_state(), []
        for _ in range(steps):
            state, loss = step(state, batch)
            losses.append(float(loss))
        runs[name] = (losses, _clone(state.params), step.bits_per_step)
    hier = HierarchicalReducer(
        PowerSGDReducer(compression_rank=2, matricize="last"), inner, outer, inner_world, outer_world
    )
    sends = sends_per_rank[rank]
    state = PowerSGDState(q_memory.clone(), hier.init(sends).generator)
    with record_collectives() as records:
        _, out, mem, bits = hier.reduce_ef(state, sends, [torch.zeros_like(s) for s in sends], group)
    return {
        "runs": runs, "out": [o.contiguous() for o in out], "mem": [m.contiguous() for m in mem], "bits": bits,
        "records": plain_records(records), "bits_by_fabric": hier.bits_by_fabric(sends),
        "inner_ranks": tuple(dist.get_process_group_ranks(inner)),
        "outer_ranks": tuple(dist.get_process_group_ranks(outer)),
    }


def study_rank(rank, world, group, global_batch):
    """``bandwidth_study.run`` of the small preset on this rank, joining the
    spawned group, one timed step and round a configuration."""
    cfg = ExperimentConfig(process_id=rank, num_processes=world)
    return bandwidth_study.run(
        cfg, preset="small", device="cpu", global_batch=global_batch, reducer_ranks=(2,),
        timed_steps=1, timed_rounds=1,
    )


# ---- checkpointed training ---------------------------------------------------

RESUME_EPOCHS, RESUME_STEPS, RESUME_BATCH, RESUME_HW = 3, 2, 16, 8


def resume_batches(epoch, steps=RESUME_STEPS, batch=RESUME_BATCH, hw=RESUME_HW):
    """The deterministic global batches of ``epoch``: class blobs, as the
    JAX package's resilient-loop test draws them."""
    rng = np.random.RandomState(1000 + epoch)
    means = np.random.RandomState(999).randn(10, hw, hw, 3)
    for _ in range(steps):
        y = rng.randint(0, 10, batch)
        yield (means[y] + 0.5 * rng.randn(batch, hw, hw, 3)).astype(np.float32), y.astype(np.int64)


class Crash(Exception):
    """A worker dying on entry to an epoch."""


def crashing_batches(crash_at_epoch):
    def fn(epoch):
        if epoch == crash_at_epoch:
            raise Crash()
        return resume_batches(epoch)

    return fn


class Events:
    """A telemetry sink that keeps ``(kind, step)`` of each failure event."""

    def __init__(self):
        self.seen = []

    def emit(self, event, record=None):
        # the loop's telemetry also carries its steps, epochs and spans
        from network_distributed_pytorch_tpu_torch.observe import FailureEvent

        if isinstance(event, FailureEvent):
            self.seen.append((event.kind, event.step))


def resnet_resume_setup(group, seed=3):
    """The small ResNet-18 (width 8, BatchNorm) under PowerSGD rank 2 with
    error feedback and momentum: the model, the step and a fresh state."""
    model = resnet18(num_classes=10, norm="batch", stem="cifar", width=8, device="cpu", seed=seed)
    reducer = PowerSGDReducer(random_seed=7, compression_rank=2, matricize="last")
    step = make_train_step(image_classifier_loss(), reducer, model, 0.05, 0.9, "ef_momentum", group)
    return model, step, step.init_state()


def snapshot(state):
    """Every tensor of a ``TrainState``, cloned: params, momenta, memories,
    the BN buffers (``num_batches_tracked`` included) and Q."""
    return {
        "params": _clone(state.params), "momenta": _clone(state.momenta), "memories": _clone(state.memories),
        "buffers": _clone(state.model_state), "q": state.reducer_state.q_memory.clone(),
    }


def _resume_loop(state_step, root, batches=resume_batches, **kw):
    _, step, state = state_step
    world = 1 if step.group is None else dist.get_world_size(step.group)
    rank = 0 if step.group is None else dist.get_rank(step.group)
    return resilient_train_loop(
        step, state, batches, RESUME_EPOCHS, root, torch.device("cpu"), rank=rank, world_size=world,
        topology=make_topology(world, global_batch=RESUME_BATCH, bits_per_step=step.bits_per_step), **kw,
    )


class _AfterStep:
    """A step that calls ``then()`` after its ``n``-th call."""

    def __init__(self, step, n, then):
        self.step, self.n, self.then, self.calls = step, n, then, 0

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, state, batch):
        out = self.step(state, batch)
        self.calls += 1
        if self.calls == self.n:
            self.then()
        return out


def resume_rank(rank, world, group, root):
    """Each resume of the small ResNet-18 against the uninterrupted run:
    a crash on entry to epoch 2 and a resume; ``guard.request()`` on rank 0
    after step 1 of epoch 1 and a resume; a real SIGTERM to rank 1 after
    the same step, which must stop both ranks there, and a resume."""
    out = {}
    state, _, _ = _resume_loop(resnet_resume_setup(group), os.path.join(root, "ref"))
    out["ref"] = snapshot(state)

    crash = os.path.join(root, "crash")
    try:
        _resume_loop(resnet_resume_setup(group), crash, batches=crashing_batches(2))
        raise AssertionError("the crashing run did not crash")
    except Crash:
        pass
    events = Events()
    state, _, out["crash_start_epoch"] = _resume_loop(resnet_resume_setup(group), crash, telemetry=events)
    out["crash"], out["crash_events"] = snapshot(state), events.seen

    for name, preempt in (("preempt", lambda g: g.request() if rank == 0 else None),
                          ("sigterm", lambda g: os.kill(os.getpid(), signal.SIGTERM) if rank == 1 else None)):
        path = os.path.join(root, name)
        setup = resnet_resume_setup(group)
        with PreemptionGuard() as guard:
            # after step 1 of epoch 1: the third step of the run
            stepper = _AfterStep(setup[1], RESUME_STEPS + 1, lambda: preempt(guard))
            _, logger, _ = _resume_loop((setup[0], stepper, setup[2]), path, preemption_guard=guard)
        out[f"{name}_stopped_after"] = len(logger.records)
        out[f"{name}_flags"] = (guard.requested, guard.checkpoint_saved)
        out[f"{name}_cursor"] = read_topology(os.path.join(path, "step_1"))["epoch_cursor"]
        events = Events()
        state, logger, out[f"{name}_start_epoch"] = _resume_loop(resnet_resume_setup(group), path, telemetry=events)
        out[name], out[f"{name}_events"] = snapshot(state), events.seen
        out[f"{name}_resumed_steps"] = len(logger.records)

    # a guard installed and never raised: one flag collective a step
    setup = resnet_resume_setup(group)
    with PreemptionGuard() as guard, record_collectives() as records:
        _resume_loop(setup, os.path.join(root, "flag"), preemption_guard=guard)
    out["flag_records"], out["bits_per_step"] = plain_records(records), setup[1].bits_per_step
    return out


# ---- the chaos plan at world 2 --------------------------------------------------

CHAOS_EPOCHS, CHAOS_STEPS, CHAOS_BATCH = 2, 3, 16


def chaos_batches_np(epoch, steps=CHAOS_STEPS, batch=CHAOS_BATCH, hw=RESUME_HW):
    """The chaos matrix's global batches: ``resume_batches`` of three steps."""
    return resume_batches(epoch, steps=steps, batch=batch, hw=hw)


def chaos_world_rank(rank, world, group, root):
    """``resilient_train_loop`` of the small ResNet-18 under four plans: none
    (``clean``), two step faults on rank 1 (``step_one``), a bad batch and
    a transient on rank 1 with the batch guard (``one``), and the same
    faults on every rank (``every``)."""
    out = {}
    plans = {
        "clean": ([], {}),
        "step_one": ([FaultSpec(kind="step_transient", step=1, rank=1), FaultSpec(kind="step_nan", step=3, rank=1)], {}),
        "one": ([FaultSpec(kind="loader_bad_batch", step=2, rank=1), FaultSpec(kind="step_transient", step=1, rank=1)],
                {"guard_batches": True, "expected_batch": CHAOS_BATCH}),
        "every": ([FaultSpec(kind="loader_bad_batch", step=2), FaultSpec(kind="step_transient", step=1)],
                  {"guard_batches": True, "expected_batch": CHAOS_BATCH}),
    }
    for name, (faults, kw) in plans.items():
        _, step, state = resnet_resume_setup(group)
        events = Events()
        with record_collectives() as records:
            state, logger, _ = resilient_train_loop(
                step, state, chaos_batches_np, CHAOS_EPOCHS, os.path.join(root, name), torch.device("cpu"),
                rank=rank, world_size=world, telemetry=events, chaos_plan=ChaosPlan(faults, seed=3) if faults else None,
                step_retries=2, **kw,
            )
        kinds = [k for k, _ in events.seen]
        out[name], out[f"{name}_kinds"], out[f"{name}_steps"] = snapshot(state), kinds, len(logger.records)
        out[f"{name}_records"], out[f"{name}_dropped"] = plain_records(records), kinds.count("bad_batch_dropped")
    return out


def smallcnn_jax_parity_rank(rank, world, group, root, jax_init):
    """``resilient_train_loop`` of the SmallCNN (width 4, 8x8 images) under
    PowerSGD rank 2 from the JAX run's initial state (``jax_init``, numpy
    leaves, converted by ``train_state_from_jax``): its final state."""
    model = SmallCNN(width=4, image_size=8, device="cpu")
    reducer = PowerSGDReducer(random_seed=7, compression_rank=2, matricize="last")
    step = make_train_step(image_classifier_loss(), reducer, model, 0.05, 0.9, "ef_momentum", group)
    state = train_state_from_jax(jax_init, rank, step.init_state(), model, reducer)
    state, logger, _ = _resume_loop((model, step, state), os.path.join(root, "jax_parity"))
    return {**snapshot(state), "losses": [r.loss for r in logger.records]}


def reshard_rank(rank, world, group, root):
    """Two steps of the small ResNet-18 at world ``world``, saved with its
    topology; then ranks 0 and 1 restore it as a world of two through the
    resharder. Returns each rank's rows before the save and, on ranks 0 and
    1, the restored state."""
    model, step, state = resnet_resume_setup(group)
    for batch in resume_batches(0):
        state, _ = step(state, shard(batch, rank, world))
    saved = snapshot(state)
    save_checkpoint(
        os.path.join(root, "ckpt"), state, step=0, group=group,
        topology=make_topology(world, global_batch=RESUME_BATCH, bits_per_step=step.bits_per_step),
    )
    pair = dist.new_group([0, 1])
    out = {"saved": saved}
    if rank < 2:
        _, _, fresh = resnet_resume_setup(pair, seed=5)  # other weights: every field must be restored
        worlds = []

        def resharder(path, topo):
            worlds.append(topo["world_size"])
            return reshard_from_checkpoint(path, fresh, saved_topology=topo, group=pair)

        restored, step_restored = restore_latest(os.path.join(root, "ckpt"), fresh, resharder=resharder, group=pair)
        out.update(restored=snapshot(restored), restored_step=step_restored, resharded_from=worlds)
    dist.barrier()
    return out


# ---- FSDP ----------------------------------------------------------------------------

# the reference's test_fsdp.py model: SmallCNN of width 4 on 8x8x3 images
FSDP_WIDTH, FSDP_HW = 4, 8


def fsdp_optimizer(algorithm, lr):
    return imdb_baseline.adamw(lr) if algorithm == "optax" else None


def fsdp_train_rank(rank, world, group, jax_init, algorithm, lr, batches, comm_chunks=None):
    """FSDP steps of the SmallCNN from the JAX FSDP state ``jax_init``
    (numpy leaves, read by attribute): the losses, the unsharded
    parameters and the length of each of this rank's shards."""
    model = SmallCNN(width=FSDP_WIDTH, image_size=FSDP_HW, device="cpu")
    states = fsdp_state_from_jax(jax_init, model, world)
    step = make_fsdp_train_step(
        image_classifier_loss(), model, lr, 0.9, algorithm, group, fsdp_optimizer(algorithm, lr), comm_chunks
    )
    state = step.init_state(states[rank])
    shard_len = {k: v.numel() for k, v in state.param_shards.items()}
    losses = []
    for batch in batches:
        state, loss = step(state, shard(batch, rank, world))
        losses.append(float(loss))
    return {"losses": losses, "params": step.unshard(state), "shard_len": shard_len}


def fsdp_bits_rank(rank, world, group, chunk_counts, batch):
    """One FSDP step of the SmallCNN for each K: what it put on the wire,
    and the step's own count by kind."""
    out = {}
    for k in chunk_counts:
        model = SmallCNN(width=FSDP_WIDTH, image_size=FSDP_HW, device="cpu")
        step = make_fsdp_train_step(image_classifier_loss(), model, 0.05, group=group, comm_chunks=k)
        state = step.init_state()
        with record_collectives() as records:
            step(state, shard(batch, rank, world))
        out[k] = {"records": plain_records(records), "bits_by_kind": step.bits_by_kind,
                  "collectives_by_kind": step.collectives_by_kind, "bits_per_step": step.bits_per_step}
    return out


def fsdp_vs_ddp_rank(rank, world, group, batches, chunk_counts):
    """The port's DDP ``sgd`` step and its FSDP step, monolithic and at each
    K, from the same seeded SmallCNN: losses and final parameters."""
    out = {}
    model = SmallCNN(width=FSDP_WIDTH, image_size=FSDP_HW, device="cpu", seed=2)
    ddp = make_train_step(image_classifier_loss(), ExactReducer(), model, 0.05, 0.9, "sgd", group)
    state = ddp.init_state()
    losses = []
    for batch in batches:
        state, loss = ddp(state, shard(batch, rank, world))
        losses.append(float(loss))
    out["ddp"] = {"losses": losses, "params": _clone(state.params)}
    for k in (None,) + tuple(chunk_counts):
        model = SmallCNN(width=FSDP_WIDTH, image_size=FSDP_HW, device="cpu", seed=2)
        step = make_fsdp_train_step(image_classifier_loss(), model, 0.05, 0.9, "sgd", group, comm_chunks=k)
        state = step.init_state()
        losses = []
        for batch in batches:
            state, loss = step(state, shard(batch, rank, world))
            losses.append(float(loss))
        out[k] = {"losses": losses, "params": step.unshard(state), "released": [p.numel() for p in model.parameters()]}
    try:
        step.eval_model_state(state, reduce="first")
        out["first_refused"] = False
    except ValueError:
        out["first_refused"] = True
    return out


def fsdp_dyadic_rank(rank, world, group, chunk_counts, xs, coeffs):
    """FSDP ``sgd`` steps of a bias-carrying linear map on integer inputs
    with an integer loss weighting, so every gradient, its sum over the
    ranks, the mean (times 1/4) and the update (lr 0.5) are exact: the
    parameters after two steps for each K, monolithic first."""

    def loss_fn(model, batch):
        x, c = batch
        return (model(x) * c).sum()

    out = {}
    for k in (None,) + tuple(chunk_counts):
        torch.manual_seed(0)
        model = torch.nn.Linear(13, 7)
        with torch.no_grad():
            model.weight.copy_(torch.arange(91.0).view(7, 13) - 40)
            model.bias.copy_(torch.arange(7.0))
        step = make_fsdp_train_step(loss_fn, model, 0.5, 0.5, "sgd", group, comm_chunks=k)
        state = step.init_state()
        for x, c in zip(xs, coeffs):
            state, _ = step(state, shard((x, c), rank, world))
        out[k] = step.unshard(state)
    return out


def exact_fsdp_rank(rank, world, group, cfg_kwargs, state_dict, steps):
    """``exact_cifar10.run(strategy="fsdp")`` at preset small from
    ``state_dict``, with the evaluation: the summary and the unsharded
    parameters at the end of training; then the launcher's ``exact_cifar10
    --strategy fsdp --comm-chunks 3`` on the same ranks."""
    kept = {}
    loop = exact_cifar10.train_loop

    def keep(step, state, *args, **kwargs):
        state, logger = loop(step, state, *args, **kwargs)
        kept["params"] = step.unshard(state)
        return state, logger

    exact_cifar10.train_loop = keep
    try:
        cfg = ExperimentConfig(process_id=rank, num_processes=world, **cfg_kwargs)
        summary = exact_cifar10.run(
            cfg, preset="small", device="cpu", max_steps_per_epoch=steps, eval_after=True, strategy="fsdp",
            pretrained_state_dict=state_dict,
        )
    finally:
        exact_cifar10.train_loop = loop
    launched = launch.main([
        "exact_cifar10", "--device", "cpu", "--global-batch", "16", "--epochs", "1", "--max-steps-per-epoch", "2",
        "--strategy", "fsdp", "--comm-chunks", "3",
    ])
    return {"summary": summary, "params": kept["params"], "launched": launched}


def _fsdp_tensors(state):
    """Every tensor of an ``FSDPState``, cloned (an optimizer's state by
    parameter index)."""
    out = {f"param_shards.{k}": v.detach().clone() for k, v in state.param_shards.items()}
    out.update({f"model_state.{k}": v.clone() for k, v in state.model_state.items()})
    if isinstance(state.opt_shards, dict):
        out.update({f"opt_shards.{k}": v.clone() for k, v in state.opt_shards.items()})
    else:
        for i, st in state.opt_shards.state_dict()["state"].items():
            out.update({f"opt_shards.{i}.{k}": v.clone() for k, v in st.items()})
    return out


def fsdp_checkpoint_rank(rank, world, group, root, batches):
    """For ``sgd`` and ``"optax"`` (AdamW): two FSDP steps of the ResNet-18
    (width 8, BatchNorm), saved; restored by ``restore_checkpoint_sharded``
    into a state of other weights, and by ``restore_latest(sharded=True)``;
    one more step from the restored state and from the original. Then a
    restore at a world of one (rank 0 alone) of a tagged and of an
    untagged checkpoint, which must be refused."""
    out = {}
    for algorithm in ("sgd", "optax"):

        def setup(seed):
            model = resnet18(num_classes=10, norm="batch", stem="cifar", width=8, device="cpu", seed=seed)
            step = make_fsdp_train_step(
                image_classifier_loss(), model, 0.05, 0.9, algorithm, group, fsdp_optimizer(algorithm, 1e-3)
            )
            return step, step.init_state()

        step, state = setup(3)
        for batch in batches[:2]:
            state, _ = step(state, shard(batch, rank, world))
        path = save_checkpoint(os.path.join(root, algorithm), state, step=0, group=group, topology=make_topology(world))
        saved = _fsdp_tensors(state)
        fresh_step, fresh = setup(5)
        restored = restore_checkpoint_sharded(path, fresh, group)
        got = {"restored": _fsdp_tensors(restored)}
        latest_step, latest = setup(6)
        latest, got["latest_step"] = restore_latest(os.path.join(root, algorithm), latest, group=group, sharded=True)
        got["latest"] = _fsdp_tensors(latest)
        _, loss = step(state, shard(batches[2], rank, world))
        _, resumed_loss = fresh_step(restored, shard(batches[2], rank, world))
        got.update(saved=saved, after=_fsdp_tensors(state), resumed=_fsdp_tensors(restored),
                   losses=(float(loss), float(resumed_loss)))
        out[algorithm] = got
    save_checkpoint(os.path.join(root, "untagged"), state, step=0, group=group)
    solo = dist.new_group([0])
    if rank == 0:
        model = resnet18(num_classes=10, norm="batch", stem="cifar", width=8, device="cpu")
        wrong = make_fsdp_train_step(image_classifier_loss(), model, 0.05, group=solo).init_state()
        out["refused"] = []
        for name in ("sgd", "untagged"):
            try:
                restore_checkpoint_sharded(os.path.join(root, name, "step_0"), wrong, solo)
                out["refused"].append(None)
            except TopologyMismatchError as e:
                out["refused"].append(str(e))
    dist.barrier()
    return out


@dataclasses.dataclass
class MeshCarry:
    """One rank's state on a data x fsdp x tensor mesh: its TP shard of
    ``w`` (the full ``b``), its data row of the memories; all its own."""

    PER_RANK_FIELDS = ("params", "memories", "model_state")
    params: dict
    memories: dict
    model_state: dict


def mesh_carry(full_w, b, mem, axes, rank):
    """Rank ``rank``'s :class:`MeshCarry` of ``full_w`` (split on axis 1),
    ``b`` and the data rows ``mem`` on the mesh ``axes``."""
    coord = mesh_coord(rank, axes)
    w = split_tp_leaf(full_w, axes["tensor"], 1)[coord["tensor"]]
    return MeshCarry(
        {"w": torch.from_numpy(np.ascontiguousarray(w)), "b": torch.from_numpy(b.copy())},
        {"m": torch.from_numpy(mem[coord["data"]].copy())}, {},
    )


def _mesh_tensors(carry):
    return {f"{f}.{k}": v.clone() for f in ("params", "memories") for k, v in getattr(carry, f).items()}


def mesh_reshard_rank(rank, world, group, root, full_w, b, mem, moves):
    """A data 2 x tensor 2 checkpoint on four ranks (``w`` TP-sharded on
    axis 1), then each move of ``moves`` (``(name, ranks, new mesh)``)
    through ``reshard_from_checkpoint`` (the first through
    ``restore_latest``'s resharder) on a group of those ranks, into a
    template of zeros; the same-mesh restore, and a restore by three ranks
    (data degree 3), which must be refused."""
    old = {"data": 2, "fsdp": 1, "tensor": 2}
    ckpt = os.path.join(root, "mesh")
    save_checkpoint(
        ckpt, mesh_carry(full_w, b, mem, old, rank), step=0, group=group,
        topology=make_topology(4, mesh_axes=old, tp_param_axes={"w": 1}),
    )
    path = os.path.join(ckpt, "step_0")

    def zeros(axes, r):
        rows = np.zeros((axes["data"],) + mem.shape[1:], mem.dtype)
        return mesh_carry(np.zeros_like(full_w), np.zeros_like(b), rows, axes, r)

    out = {}
    for i, (name, members, axes) in enumerate(moves):
        sub = group if len(members) == world else dist.new_group(members)
        if rank not in members:
            continue
        r = members.index(rank)
        template = zeros({"fsdp": 1, **axes}, r)
        if i == 0:
            carry, _ = restore_latest(
                ckpt, template, group=sub,
                resharder=lambda p, topo: reshard_from_checkpoint(p, template, topo, mesh_axes=axes, group=sub),
            )
        else:
            carry = reshard_from_checkpoint(path, template, mesh_axes=axes, group=sub)
        out[name] = _mesh_tensors(carry)
    out["same_mesh"] = _mesh_tensors(restore_checkpoint(path, zeros(old, rank), group, mesh_axes=old))
    trio = dist.new_group([0, 1, 2])
    if rank < 3:
        try:
            restore_checkpoint(path, zeros({"data": 3, "fsdp": 1, "tensor": 1}, rank), trio, mesh_axes={"data": 3})
            out["refused"] = None
        except TopologyMismatchError as e:
            out["refused"] = str(e)
    dist.barrier()
    return out


# ---- telemetry: the audit and the health probe on ranks ---------------------


def _telemetry_case(name, group):
    """A model and its step for one audited case of ``telemetry_rank``."""
    if name == "fsdp":
        model = SmallCNN(width=FSDP_WIDTH, image_size=FSDP_HW, device="cpu")
        step = make_fsdp_train_step(image_classifier_loss(), model, 0.05, group=group, comm_chunks=2)
        return model, step, step.init_state()
    model = SmallCNN(width=FSDP_WIDTH, image_size=FSDP_HW, device="cpu")
    algorithm = "sgd"
    if name == "exact_buckets_chunks":
        reducer = ExactReducer(bucket_bytes=2_000, comm_chunks=3)
    elif name == "exact_ring":
        reducer = ExactReducer(comm_strategy="ring")
    elif name == "powersgd_chunks":
        reducer, algorithm = PowerSGDReducer(compression_rank=2, matricize="last", comm_chunks=4), "ef_momentum"
    elif name == "hierarchical":
        inner, outer, inner_world, outer_world = make_hierarchical_groups(2, group)
        reducer = HierarchicalReducer(
            PowerSGDReducer(compression_rank=2, matricize="last"), inner, outer, inner_world, outer_world
        )
        algorithm = "ef_momentum"
    else:
        reducer = ExactReducer()
    step = make_train_step(image_classifier_loss(), reducer, model, 0.05, 0.9, algorithm, group)
    return model, step, step.init_state()


TELEMETRY_CASES = ("exact", "exact_buckets_chunks", "exact_ring", "powersgd_chunks", "hierarchical", "fsdp")


def telemetry_rank(rank, world, group, batches):
    """For each of ``TELEMETRY_CASES``: ``train_loop`` with the audit and a
    probe every step over ``batches`` (this rank's slice of each), its
    records in memory. Returns each case's records (JSON-plain dicts) and,
    for the PowerSGD case, this rank's own probe of its last step without
    a group (the local values the group's probe averages)."""
    from network_distributed_pytorch_tpu_torch.experiments.common import train_loop
    from network_distributed_pytorch_tpu_torch.observe import MemorySink, Telemetry
    from network_distributed_pytorch_tpu_torch.parallel.trainer import make_health_fn

    out = {}
    for name in TELEMETRY_CASES:
        model, step, state = _telemetry_case(name, group)
        sink = MemorySink()
        state, _ = train_loop(
            step, state, lambda epoch: iter(batches), 1, torch.device("cpu"), rank=rank, world_size=world,
            telemetry=Telemetry([sink]), audit=True, run_name=name, health_every=1,
        )
        out[name] = {"records": [{k: v for k, v in r.items() if k not in ("ts", "ts_mono")} for r in sink.records]}
        if name == "powersgd_chunks":
            local = make_health_fn(image_classifier_loss(), step.reducer, model, None)
            out[name]["local_probe"] = local(state, shard(batches[-1], rank, world))
    return out
