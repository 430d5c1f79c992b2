"""The port's ``device_prefetch`` and the training loop's host data plane
on the CPU, against the JAX package's:

- ``device_prefetch`` yields the input batches in order, as copies that a
  later batch never rewrites, at depths 0 to 3 and under
  ``NDP_PREFETCH_DEPTH``, pulling ``depth + 1`` batches before its first
  yield as the JAX one does; it records ``data_load/assemble`` (from
  ``iterate_batches``) and ``data_load/stage``, and its ``LoaderEvent``
  counts are the JAX ``device_prefetch``'s on the same batches;
- ``train_loop`` is bit for bit the same at ``prefetch=0`` and ``2``, and
  matches the JAX ``train_loop`` (its own test: ``tests/test_data.py``'s
  ``test_device_prefetch_preserves_trajectory``) within the loop tests'
  1e-4;
- ``accumulated_batches`` takes the native loader exactly where the JAX
  one does;
- a ``resilient_train_loop`` preempted mid-epoch at the default
  ``prefetch=2`` resumes onto the unfaulted run bit for bit, its cursor the
  steps consumed, and the resumed epoch stages only the batches it steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import network_distributed_pytorch_tpu.data as jax_data
from network_distributed_pytorch_tpu.data.loader import device_prefetch as jax_device_prefetch
from network_distributed_pytorch_tpu.experiments.common import accumulated_batches as jax_accumulated_batches
from network_distributed_pytorch_tpu.experiments.common import train_loop as jax_train_loop
from network_distributed_pytorch_tpu.observe import MemorySink as JaxMemorySink
from network_distributed_pytorch_tpu.observe import Telemetry as JaxTelemetry
from network_distributed_pytorch_tpu.observe.spans import recording as jax_recording
from network_distributed_pytorch_tpu.parallel import ExactReducer as JaxExactReducer
from network_distributed_pytorch_tpu.parallel import make_mesh
from network_distributed_pytorch_tpu.parallel.trainer import make_train_step as jax_make_train_step
from network_distributed_pytorch_tpu.parallel.trainer import stateless_loss
from network_distributed_pytorch_tpu_torch.data.loader import device_prefetch, iterate_batches
from network_distributed_pytorch_tpu_torch.experiments.common import (
    accumulated_batches,
    resilient_train_loop,
    train_loop,
)
from network_distributed_pytorch_tpu_torch.observe import MemorySink, Telemetry
from network_distributed_pytorch_tpu_torch.observe.spans import recording
from network_distributed_pytorch_tpu_torch.parallel.reducers import ExactReducer
from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step
from network_distributed_pytorch_tpu_torch.resilience import PreemptionGuard
from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig
from torch_worker import few_torch_threads, resnet_resume_setup, resume_batches, snapshot  # noqa: F401

TOL = 1e-4  # test_torch_training.py's parity tolerance after a few fp32 steps


def _batches(n=7, seed=0):
    """Batches whose shapes change twice (the slots are reallocated) and
    whose labels are int64, with a scalar leaf passed through."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        rows = 4 if i < 3 else 6 if i < 5 else 4
        out.append((rng.randn(rows, 3, 2).astype(np.float32), rng.randint(0, 9, rows).astype(np.int64), i))
    return out


class _Counting:
    """An iterator over ``batches`` that counts its pulls."""

    def __init__(self, batches):
        self.batches, self.pulled = list(batches), 0

    def __iter__(self):
        for b in self.batches:
            self.pulled += 1
            yield b


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_cpu_prefetch_yields_the_batches_in_order_as_copies(depth):
    src = _batches()
    source = _Counting(src)
    got = []
    gen = device_prefetch(iter(source), "cpu", depth=depth)
    for i, batch in enumerate(gen):
        if i == 0:
            assert source.pulled == min(depth + 1, len(src))  # the JAX function's lookahead
        got.append(batch)
    assert len(got) == len(src)
    for (x, y, i), (gx, gy, gi) in zip(src, got):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu" and gy.dtype == torch.int64
        assert np.array_equal(gx.numpy(), x) and np.array_equal(gy.numpy(), y) and gi == i
    # copies, not views of the slots that later batches rewrote
    assert len({t.data_ptr() for b in got for t in b[:2]}) == 2 * len(got)


@pytest.mark.parametrize("env_depth", ["0", "3"])
def test_prefetch_depth_env_overrides_the_argument(env_depth, monkeypatch):
    monkeypatch.setenv("NDP_PREFETCH_DEPTH", env_depth)
    source = _Counting(_batches())
    sink = MemorySink()
    with recording(Telemetry([sink])):
        gen = device_prefetch(iter(source), "cpu", depth=2)
        first = next(gen)
        assert source.pulled == int(env_depth) + 1
        rest = list(gen)
    assert len(rest) == 6 and np.array_equal(first[0].numpy(), _batches()[0][0])
    (event,) = sink.of_kind("loader")
    assert event["prefetch_depth"] == int(env_depth)


@pytest.mark.parametrize("kind", [tuple, list])
def test_prefetch_keeps_the_batch_type_and_passes_other_leaves(kind):
    src = _batches(4)
    got = list(device_prefetch(iter(kind(b) for b in src), torch.device("cpu"), depth=1))
    for (x, y, i), b in zip(src, got):
        assert type(b) is kind and b[2] == i
        assert np.array_equal(b[0].numpy(), x) and np.array_equal(b[1].numpy(), y)


@pytest.mark.parametrize("depth", [0, 2])
def test_spans_and_loader_event_are_the_jax_functions(depth):
    rng = np.random.RandomState(3)
    x, y = rng.randn(37, 5).astype(np.float32), rng.randint(0, 4, 37).astype(np.int32)
    sink, jsink = MemorySink(), JaxMemorySink()
    with recording(Telemetry([sink])):
        got = list(device_prefetch(iterate_batches([x, y], 8, seed=2), "cpu", depth=depth, label="l"))
    with jax_recording(JaxTelemetry([jsink])):
        # read at once: on the CPU backend the JAX function's device_put may
        # alias its staging slot, which a later batch rewrites
        want = [
            tuple(np.array(a) for a in b)
            for b in jax_device_prefetch(jax_data.iterate_batches([x, y], 8, seed=2), None, depth=depth, label="l")
        ]
    assert len(got) == len(want) == 4
    for (gx, gy), (wx, wy) in zip(got, want):
        assert np.array_equal(gx.numpy(), np.asarray(wx)) and np.array_equal(gy.numpy(), np.asarray(wy))
    names = [r["name"] for r in sink.of_kind("span")]
    assert names == [r["name"] for r in jsink.of_kind("span")]
    assert names.count("data_load/assemble") == names.count("data_load/stage") == 4
    (ev,), (jev,) = sink.of_kind("loader"), jsink.of_kind("loader")
    for k in ("label", "batches", "samples", "prefetch_depth", "native"):
        assert ev[k] == jev[k]
    assert (ev["batches"], ev["samples"], ev["prefetch_depth"]) == (4, 32, depth)
    assert ev["samples_per_s"] > 0 and 0 <= ev["wait_s"]


def test_an_abandoned_prefetch_closes_its_source():
    closed = []

    def source():
        try:
            for b in _batches():
                yield b
        finally:
            closed.append(True)

    gen = device_prefetch(source(), "cpu", depth=2)
    next(gen)
    gen.close()
    assert closed == [True]


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        next(device_prefetch(iter(_batches()), "cuda", depth=2))


class _Lin(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(8))

    def forward(self, x):
        return x @ self.w


def _linreg():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = (x @ rng.randn(8, 1).astype(np.float32))[:, 0]
    return x, y


def _port_loop(prefetch):
    x, y = _linreg()
    step = make_train_step(
        lambda m, b: ((m(b[0]) - b[1]) ** 2).mean(), ExactReducer(), _Lin(), 0.05, algorithm="sgd_plain"
    )
    sink = MemorySink()
    state, logger = train_loop(
        step, step.init_state(), lambda epoch: iterate_batches([x, y], 16, seed=7, epoch=epoch), 3,
        torch.device("cpu"), prefetch=prefetch, telemetry=Telemetry([sink]),
    )
    return state.params["w"].detach().clone(), [r.loss for r in logger.records], sink


def test_train_loop_is_bitwise_the_same_with_and_without_prefetch_and_matches_jax():
    w0, l0, sink0 = _port_loop(0)
    w2, l2, sink2 = _port_loop(2)
    assert torch.equal(w0, w2) and l0 == l2
    assert not sink0.of_kind("loader") and len(sink2.of_kind("loader")) == 3  # one an epoch
    stage = [r for r in sink2.of_kind("span") if r["name"] == "data_load/stage"]
    assert len(stage) == 12 and not [r for r in sink0.of_kind("span") if r["name"] == "data_load/stage"]
    x, y = _linreg()
    params = {"w": jnp.zeros((8,))}
    step = jax_make_train_step(
        stateless_loss(lambda p, b: ((b[0] @ p["w"] - b[1]) ** 2).mean()), JaxExactReducer(), params, 0.05,
        mesh=make_mesh(), algorithm="sgd_plain", donate_state=False,
    )

    def batches(epoch):
        yield from jax_data.iterate_batches([x, y], 16, seed=7, epoch=epoch)

    state, logger = jax_train_loop(step, step.init_state(params), batches, 3, prefetch=2)
    np.testing.assert_allclose(w2.numpy(), np.asarray(jax.device_get(state.params["w"])), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(l2, [r.loss for r in logger.records], rtol=TOL, atol=TOL)


@pytest.mark.parametrize(
    "arrays,accum",
    [
        (lambda r: [r.randn(40, 4).astype(np.float32), r.randint(0, 3, 40).astype(np.int32)], 1),
        (lambda r: [r.randn(40, 4).astype(np.float32), r.randint(0, 3, 40).astype(np.int32)], 2),
        (lambda r: [r.randint(0, 255, (40, 4)).astype(np.uint8), r.randint(0, 3, 40).astype(np.int32)], 1),
        (lambda r: [r.randn(40, 4).astype(np.float32), r.randn(40).astype(np.float32)], 1),
        (lambda r: [r.randn(40, 4).astype(np.float32), r.randint(0, 3, 40), r.randint(0, 3, 40)], 1),
    ],
)
def test_accumulated_batches_takes_the_native_loader_where_the_jax_one_does(arrays, accum, monkeypatch):
    data = arrays(np.random.RandomState(5))
    seen = []
    create = jax_data.NativeBatchLoader.maybe_create.__func__

    def spy(cls, *a, **kw):
        seen.append(create(cls, *a, **kw))
        return seen[-1]

    monkeypatch.setattr(jax_data.NativeBatchLoader, "maybe_create", classmethod(spy))
    cfg = ExperimentConfig(global_batch_size=8, accum_steps=accum, seed=3)
    gen = accumulated_batches(data, cfg, max_steps_per_epoch=3)
    jgen = jax_accumulated_batches(data, cfg, max_steps_per_epoch=3)
    for epoch in range(2):
        got, want = list(gen(epoch)), list(jgen(epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(g, w))
    native = gen.loader is not None
    assert native == (bool(seen) and seen[0] is not None) == (accum == 1 and data[0].dtype == np.float32
                                                              and len(data) == 2 and data[1].dtype.kind == "i")
    if native:
        assert gen.loader.last_stats["native"] and gen.loader.last_stats["batches"] >= 3


STEPS, EPOCHS = 4, 3


def _resumable(root, preempt_after=None, telemetry=None):
    model, step, state = resnet_resume_setup(None)
    calls = {"n": 0}
    guard = PreemptionGuard(label="t")
    inner = step

    class After:
        def __getattr__(self, name):
            return getattr(inner, name)

        def __call__(self, st, batch):
            out = inner(st, batch)
            calls["n"] += 1
            if calls["n"] == preempt_after:
                guard.request()
            return out

    state, logger, start = resilient_train_loop(
        After(), state, lambda epoch: resume_batches(epoch, steps=STEPS), EPOCHS, str(root), torch.device("cpu"),
        preemption_guard=guard, telemetry=telemetry,
    )
    return snapshot(state), calls["n"], start


def test_preempted_mid_epoch_at_prefetch_2_resumes_bit_for_bit(tmp_path):
    from network_distributed_pytorch_tpu_torch.utils.checkpoint import read_topology

    ref, n_ref, _ = _resumable(tmp_path / "ref")
    assert n_ref == STEPS * EPOCHS
    _, n_first, _ = _resumable(tmp_path / "run", preempt_after=STEPS + 2)  # epoch 1, after its step 2
    assert n_first == STEPS + 2
    topo = read_topology(str(tmp_path / "run" / "step_1"))
    assert topo["epoch_cursor"] == {"epoch": 1, "batches_done": 2}  # consumed, not staged
    sink = MemorySink()
    got, n_resumed, start = _resumable(tmp_path / "run", telemetry=Telemetry([sink]))
    assert (start, n_resumed) == (1, STEPS * EPOCHS - STEPS - 2)
    loaders = sink.of_kind("loader")
    assert [e["batches"] for e in loaders] == [STEPS - 2, STEPS]  # the skipped batches were never staged
    for field in ("params", "momenta", "memories", "buffers"):
        for k in ref[field]:
            assert torch.equal(got[field][k], ref[field][k]), (field, k)
    assert torch.equal(got["q"], ref["q"])
