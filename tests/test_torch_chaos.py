"""The port's fault injection and guarded step (``resilience/chaos.py``,
``resilience/guards.py``, ``utils/failure.retry_transient``) against the
JAX package's, and the chaos matrix through the port's
``resilient_train_loop``.

Exact equality with the JAX functions on the same inputs: the fault
registry, the plan's JSON round trip and its load-time validation, ``pop``
with its rank and incarnation filters, the positions ``chaos_batches``
poisons, the byte ``bitflip_checkpoint`` flips and the half
``tear_checkpoint`` keeps, what ``guarded_batches`` drops, ``ChaosStep``'s
injected errors, and ``retry_transient``'s seeded backoff schedule.

The matrix (the JAX package's ``tests/test_chaos.py:142-239``) on the small
ResNet-18 (BatchNorm) under PowerSGD with error feedback, one process: step
faults retried bit for bit against a clean run (params, momenta, memories,
Q and the BN buffers), loader faults dropped, checkpoint faults falling
back, the combined plan (its failure events the same as the JAX loop's on
the JAX SmallCNN), preemption resumed mid-epoch bit for bit, the ``oom``
fault's report. ``GuardedStep``'s snapshot: a real NaN leaves the state as
it was, an ``"optax"`` Adam state and the generators come back, and no copy
is made at ``retries=0``.

At world 2 on Gloo (one spawn for the module): the fault on rank 1 only
against the fault on every rank and against the clean run, bit for bit on
both ranks, with the batch verdict one ``"bad-batch-flag"`` collective a
batch, outside the step's bits.
"""

import json
import os
import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import network_distributed_pytorch_tpu.resilience.chaos as jchaos
import network_distributed_pytorch_tpu.resilience.guards as jguards
import network_distributed_pytorch_tpu.utils.failure as jfailure
from network_distributed_pytorch_tpu.experiments.common import resilient_train_loop as jax_resilient_train_loop
from network_distributed_pytorch_tpu.models import SmallCNN as JaxSmallCNN
from network_distributed_pytorch_tpu.observe import MemorySink as JaxMemorySink
from network_distributed_pytorch_tpu.observe import Telemetry as JaxTelemetry
from network_distributed_pytorch_tpu.parallel import PowerSGDReducer as JaxPowerSGD
from network_distributed_pytorch_tpu.parallel import make_mesh
from network_distributed_pytorch_tpu.parallel.trainer import make_train_step as jax_make_train_step
from network_distributed_pytorch_tpu.parallel.trainer import stateless_loss
from network_distributed_pytorch_tpu.utils import cross_entropy_loss
from network_distributed_pytorch_tpu_torch.experiments.common import image_classifier_loss, resilient_train_loop
from network_distributed_pytorch_tpu_torch.models.cnn import SmallCNN
from network_distributed_pytorch_tpu_torch.observe import MemorySink, Telemetry
from network_distributed_pytorch_tpu_torch.parallel.reducers import PowerSGDReducer
from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step
from network_distributed_pytorch_tpu_torch.resilience import chaos, guards
from network_distributed_pytorch_tpu_torch.resilience import (
    ChaosPlan,
    ChaosStep,
    ChaosTransientError,
    FaultSpec,
    GuardedStep,
    NonFiniteLossError,
    OutOfMemoryError,
    PreemptionGuard,
    chaos_batches,
    guarded_batches,
    is_oom_error,
)
from network_distributed_pytorch_tpu_torch.utils import failure
from network_distributed_pytorch_tpu_torch.utils.checkpoint import (
    REPLICATED_FILE,
    latest_step_path,
    read_topology,
    verify_checkpoint,
)
from torch_worker import (  # few_torch_threads: autouse
    CHAOS_BATCH,
    CHAOS_EPOCHS,
    CHAOS_STEPS,
    chaos_batches_np,
    chaos_world_rank,
    few_torch_threads,
    resnet_resume_setup,
    run_all,
    snapshot,
    spawn,
)

EVERY_KIND = [
    FaultSpec(kind=k, step=i, rank=i % 3 or None, incarnation=None if i % 5 == 0 else i % 2,
              payload={"ranks": [0, 2]} if k == "zone_outage" else {"x": i})
    for i, k in enumerate(chaos.FAULT_KINDS)
]


def _kinds(sink):
    return [r.get("kind") for r in sink.records if r.get("event") == "failure"]


def _telemetry():
    sink = MemorySink()
    return Telemetry([sink]), sink


def _bitwise(got, want, what):
    for field in ("params", "momenta", "memories", "buffers"):
        assert set(got[field]) == set(want[field]), f"{what}: {field}"
        for k, w in want[field].items():
            assert torch.equal(got[field][k], w), f"{what}: {field} {k}"
    assert torch.equal(got["q"], want["q"]), f"{what}: Q"


# ---- the plan against the JAX package's ------------------------------------


def test_registry_and_exit_codes_are_the_jax_packages():
    for name in ("LOADER_FAULTS", "STEP_FAULTS", "CHECKPOINT_FAULTS", "PROCESS_FAULTS", "CORRELATED_FAULTS",
                 "COMM_FAULTS", "HEALTH_FAULTS", "MEMORY_FAULTS", "FAULT_KINDS", "INJECTION_SITES"):
        assert getattr(chaos, name) == getattr(jchaos, name), name
    assert len(chaos.FAULT_KINDS) == 24
    chaos.check_fault_registry()
    assert (chaos.CHAOS_EXIT_CODE, chaos.PREEMPT_EXIT_CODE, chaos.CKPT_UNWRITABLE_EXIT_CODE) == (
        jchaos.CHAOS_EXIT_CODE, jchaos.PREEMPT_EXIT_CODE, jchaos.CKPT_UNWRITABLE_EXIT_CODE) == (43, 75, 44)
    # one definition, two names
    assert chaos.PREEMPT_EXIT_CODE is guards.PREEMPT_EXIT_CODE
    assert chaos.CKPT_UNWRITABLE_EXIT_CODE is guards.CKPT_UNWRITABLE_EXIT_CODE


def test_plan_json_round_trips_as_the_jax_package_s(tmp_path):
    port = ChaosPlan(EVERY_KIND, seed=11)
    want = jchaos.ChaosPlan([jchaos.FaultSpec(**json.loads(json.dumps(vars(f)))) for f in EVERY_KIND], seed=11)
    assert port.to_json() == want.to_json()
    assert ChaosPlan.from_json(want.to_json()).to_json() == want.to_json()
    path = port.save(str(tmp_path / "plan.json"))
    assert jchaos.ChaosPlan.load(path).to_json() == ChaosPlan.load(path).to_json() == want.to_json()


@pytest.mark.parametrize("bad", [
    {"faults": [{"kind": "proc_kill", "step": 0}, "zap"]},
    {"faults": [{"kind": "meteor", "step": 0}]},
    {"faults": [{"kind": "proc_kill", "step": 0, "at_rank": 1}]},
    {"faults": [{"kind": "proc_kill", "step": 0}, {"kind": "step_nan", "step": 1}, {"kind": "proc_exit", "step": "x"}]},
    {"faults": [{"kind": "zone_outage", "step": 0, "payload": {"ranks": []}}]},
    {"faults": [{"kind": "step_nan", "step": True}]},
    {"faults": [{"kind": "step_nan", "step": 0, "rank": "1"}]},
    {"faults": [{"kind": "step_nan", "step": 0, "incarnation": 1.5}]},
    {"faults": [{"kind": "step_nan", "step": 0, "payload": []}]},
])
def test_plan_validation_at_load_time_is_the_jax_package_s(bad):
    with pytest.raises(ValueError) as got:
        ChaosPlan.from_json(bad)
    with pytest.raises(ValueError) as want:
        jchaos.ChaosPlan.from_json(bad)
    assert str(got.value) == str(want.value)


def test_pop_and_incarnation_matching_are_the_jax_package_s():
    plans = ChaosPlan(EVERY_KIND), jchaos.ChaosPlan.from_json(ChaosPlan(EVERY_KIND).to_json())
    queries = [
        (kinds, step, rank, inc)
        for kinds in (chaos.STEP_FAULTS, chaos.PROCESS_FAULTS + chaos.CORRELATED_FAULTS, chaos.FAULT_KINDS)
        for step in range(len(EVERY_KIND))
        for rank in range(3)
        for inc in range(3)
    ]
    got = [plans[0].pop(*q) for q in queries]
    want = [plans[1].pop(*q) for q in queries]
    assert [vars(f) if f else None for f in got] == [vars(f) if f else None for f in want]
    assert sum(f is not None for f in got) > 10


def test_pop_peer_sees_the_other_ranks_faults_once():
    plan = ChaosPlan([FaultSpec(kind="step_transient", step=2, rank=1),
                      FaultSpec(kind="step_nan", step=3, rank=0, incarnation=None)])
    assert plan.pop_peer(chaos.STEP_FAULTS, 2, rank=1, world_size=2) is None  # its own, not a peer's
    assert plan.pop_peer(chaos.STEP_FAULTS, 2, rank=0, world_size=2).kind == "step_transient"
    assert plan.pop_peer(chaos.STEP_FAULTS, 2, rank=0, world_size=2) is None  # once
    assert plan.pop_peer(chaos.STEP_FAULTS, 3, rank=1, world_size=2, incarnation=4).kind == "step_nan"


def _src(epoch):
    rng = np.random.RandomState(epoch)
    for _ in range(4):
        yield rng.randn(8, 5, 3).astype(np.float32), rng.randint(0, 10, 8).astype(np.int32)


def test_chaos_batches_poison_what_the_jax_package_poisons():
    specs = [dict(kind="loader_bad_batch", step=0), dict(kind="loader_short_batch", step=1),
             dict(kind="loader_bad_batch", step=3), dict(kind="loader_bad_batch", step=5)]
    got_sink, want_sink = MemorySink(), JaxMemorySink()
    got = chaos_batches(_src, ChaosPlan([FaultSpec(**s) for s in specs], seed=4), telemetry=Telemetry([got_sink]))
    want = jchaos.chaos_batches(
        _src, jchaos.ChaosPlan([jchaos.FaultSpec(**s) for s in specs], seed=4), telemetry=JaxTelemetry([want_sink])
    )
    for epoch in (0, 1):
        for g, w in zip(got(epoch), want(epoch), strict=True):
            for a, b in zip(g, w, strict=True):
                np.testing.assert_array_equal(a, np.asarray(b))
    assert [(r["kind"], r["label"], r["step"]) for r in got_sink.records] == [
        (r["kind"], r["label"], r["step"]) for r in want_sink.records]
    assert len(got_sink.records) == 4
    # integer labels in the first leaf: out-of-range garbage, as in JAX
    ints = lambda e: iter([(np.arange(16, dtype=np.int64),)])  # noqa: E731
    g = next(chaos_batches(ints, ChaosPlan([FaultSpec(kind="loader_bad_batch", step=0)], seed=9))(0))
    w = next(jchaos.chaos_batches(ints, jchaos.ChaosPlan([jchaos.FaultSpec(kind="loader_bad_batch", step=0)], seed=9))(0))
    np.testing.assert_array_equal(g[0], w[0])
    assert (g[0] == np.iinfo(np.int64).max).sum() == 2


def test_guarded_batches_drop_what_the_jax_package_drops():
    def src(epoch):
        yield np.zeros((8, 2), np.float32), np.zeros(8, np.int64)
        yield np.full((8, 2), np.nan, np.float32), np.zeros(8, np.int64)
        yield np.zeros((4, 2), np.float32), np.zeros(4, np.int64)
        yield np.zeros((8, 2), np.float32), np.zeros(6, np.int64)
        yield np.ones((8, 2), np.float32), np.zeros(8, np.int64)

    for expected in (None, 8):
        got_sink, want_sink = MemorySink(), JaxMemorySink()
        got = list(guarded_batches(src, expected, Telemetry([got_sink]), label="x")(0))
        want = list(jguards.guarded_batches(src, expected, JaxTelemetry([want_sink]), label="x")(0))
        assert len(got) == len(want) and all(np.array_equal(g[0], w[0]) for g, w in zip(got, want))
        assert [(r["kind"], r["step"], r["message"]) for r in got_sink.records] == [
            (r["kind"], r["step"], r["message"]) for r in want_sink.records]


@pytest.mark.parametrize("fault", ["bitflip", "tear"])
def test_checkpoint_damage_is_the_jax_package_s(tmp_path, fault):
    dirs = []
    for side in ("port", "jax"):
        d = tmp_path / side / "step_0"
        d.mkdir(parents=True)
        (d / REPLICATED_FILE).write_bytes(bytes(range(256)) * 37)
        (d / "rank_00000.pt").write_bytes(b"\x01" * 100)
        (d / "_COMMITTED").write_text("{}")
        dirs.append(str(d))
    if fault == "bitflip":
        chaos.bitflip_checkpoint(dirs[0], seed=13)
        jchaos.bitflip_checkpoint(dirs[1], seed=13)
    else:
        chaos.tear_checkpoint(dirs[0])
        jchaos.tear_checkpoint(dirs[1])
    for name in (REPLICATED_FILE, "rank_00000.pt", "_COMMITTED"):
        paths = [os.path.join(d, name) for d in dirs]
        assert [os.path.exists(p) for p in paths][0] == os.path.exists(paths[1])
        if os.path.exists(paths[0]):
            assert open(paths[0], "rb").read() == open(paths[1], "rb").read(), name
    original = bytes(range(256)) * 37
    damaged = open(os.path.join(dirs[0], REPLICATED_FILE), "rb").read()
    if fault == "bitflip":
        assert sum(a != b for a, b in zip(damaged, original)) == 1
    else:
        assert damaged == original[: len(original) // 2]


def test_make_checkpoint_unwritable_round_trip(tmp_path):
    root = tmp_path / "ck"
    root.mkdir()
    chaos.make_checkpoint_unwritable(str(root))
    assert (os.stat(root).st_mode & 0o777) == 0o500
    chaos.restore_checkpoint_writable(str(root))
    assert (os.stat(root).st_mode & 0o777) == 0o700


def test_retry_transient_backoff_is_the_jax_package_s(monkeypatch):
    schedules = []
    for mod in (failure, jfailure):
        slept = []
        monkeypatch.setattr(mod.time, "sleep", slept.append)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 6:
                raise RuntimeError(f"blip {len(calls)}")
            return "ok"

        sink = MemorySink() if mod is failure else JaxMemorySink()
        tel = Telemetry([sink]) if mod is failure else JaxTelemetry([sink])
        out = mod.retry_transient(
            flaky, retries=5, backoff_seconds=0.5, max_backoff_seconds=3.0, jitter=0.25, telemetry=tel, label="L",
            rng=random.Random(17),
        )
        assert out == "ok"
        schedules.append((slept, [(r["kind"], r["label"], r["message"]) for r in sink.records]))
        monkeypatch.undo()
    assert schedules[0] == schedules[1]
    assert len(schedules[0][0]) == 5 and max(schedules[0][0]) <= 3.0 * 1.25
    # spent: the last error is raised, every attempt an event
    sink = MemorySink()
    with pytest.raises(RuntimeError, match="always"):
        failure.retry_transient(lambda: (_ for _ in ()).throw(RuntimeError("always")), retries=1,
                                backoff_seconds=0.0, telemetry=Telemetry([sink]))
    assert _kinds(sink) == ["retry", "retry"]


def test_chaos_step_raises_what_the_jax_package_raises():
    class Fake:
        bits_per_step = 123

        def __call__(self, state, batch):
            return state + 1, 0.5

    specs = [dict(kind="step_transient", step=0), dict(kind="step_nan", step=1),
             dict(kind="oom", step=2, payload={"bytes": 12345})]
    outs = []
    for mod, plan in ((chaos, ChaosPlan([FaultSpec(**s) for s in specs])),
                      (jchaos, jchaos.ChaosPlan([jchaos.FaultSpec(**s) for s in specs]))):
        wrapped = mod.ChaosStep(Fake(), plan, rank=3)
        assert wrapped.bits_per_step == 123
        got = []
        for i in range(4):
            try:
                state, loss = wrapped(0, None)
                got.append((state, None if loss == loss else "nan"))
            except RuntimeError as e:
                got.append((type(e).__name__, str(e)))
        outs.append(got)
    assert outs[0] == outs[1]
    assert is_oom_error(chaos.ChaosOutOfMemoryError(outs[0][2][1]))


def test_chaos_step_raises_the_twin_of_a_peer_s_fault():
    class Fake:
        def __call__(self, state, batch):
            return state + 1, 0.5

    plan = [FaultSpec(kind="step_transient", step=0, rank=1), FaultSpec(kind="step_nan", step=1, rank=1)]
    sinks = []
    for rank in (0, 1):
        tel, sink = _telemetry()
        wrapped = ChaosStep(Fake(), ChaosPlan(list(plan)), rank=rank, telemetry=tel, world_size=2)
        with pytest.raises(ChaosTransientError):
            wrapped(0, None)
        state, loss = wrapped(0, None)
        assert state == 0 and loss != loss
        assert wrapped(0, None) == (1, 0.5)
        sinks.append(_kinds(sink))
    assert sinks == [[], ["chaos_injected", "chaos_injected"]]  # the twin emits nothing


def test_is_oom_error_knows_the_cuda_allocator():
    err = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 20.00 GiB")
    assert isinstance(err, RuntimeError) and is_oom_error(err)
    assert is_oom_error(RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate(handle)"))
    assert is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate 8 bytes"))
    assert not is_oom_error(RuntimeError("NCCL error: unhandled system error"))
    assert not issubclass(OutOfMemoryError, RuntimeError) and not issubclass(jguards.OutOfMemoryError, RuntimeError)


# ---- GuardedStep on the port's in-place step ---------------------------------


def _batch(seed, hw=8, n=CHAOS_BATCH):
    x, y = next(chaos_batches_np(seed, steps=1, batch=n, hw=hw))
    return torch.from_numpy(x), torch.from_numpy(y)


def test_guarded_step_leaves_the_state_as_it_was_after_a_real_nan(tmp_path):
    model, step, state = resnet_resume_setup(None)
    state, _ = step(state, _batch(0))  # EF memories and momenta are non-zero
    before = snapshot(state)
    x, y = _batch(1)
    x[3, 2, 1, 0] = float("nan")
    tel, sink = _telemetry()
    guarded = GuardedStep(step, retries=2, backoff_seconds=0.0, telemetry=tel)
    with pytest.raises(NonFiniteLossError):
        guarded(state, (x, y))
    _bitwise(snapshot(state), before, "after the guard gave up")
    assert _kinds(sink) == ["retry"] * 3
    # and the next good step is the step an unguarded state takes
    _, ref_step, ref = resnet_resume_setup(None)
    ref, _ = ref_step(ref, _batch(0))
    ref, _ = ref_step(ref, _batch(2))
    state, _ = guarded(state, _batch(2))
    _bitwise(snapshot(state), snapshot(ref), "the next step")


def test_guarded_step_restores_optimizer_state_and_generators():
    model = SmallCNN(width=4, image_size=8, device="cpu")
    step = make_train_step(
        image_classifier_loss(), PowerSGDReducer(random_seed=7, compression_rank=2, matricize="last", reuse_query=False),
        model, 0.05, algorithm="optax", optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-3),
    )
    state = step.init_state()
    state, _ = step(state, _batch(0))
    calls = []

    def failing(st, batch):
        out = step(st, batch)  # writes everything, then "fails"
        torch.randn(3)
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("transient after the update")
        return out

    params = {k: v.clone() for k, v in state.params.items()}
    adam = {k: v.clone() for k, v in state.optimizer.state_dict()["state"][0].items()}
    gen_state = state.reducer_state.generator.get_state()
    cpu_rng = torch.get_rng_state()
    guarded = GuardedStep(failing, retries=1, backoff_seconds=0.0, telemetry=_telemetry()[0])
    guarded.snapshot.take(state)
    torch.randn(5)
    step(state, _batch(1))
    guarded.snapshot.restore(state)
    assert all(torch.equal(state.params[k], v) for k, v in params.items())
    assert all(torch.equal(state.optimizer.state_dict()["state"][0][k], v) for k, v in adam.items())
    assert torch.equal(state.reducer_state.generator.get_state(), gen_state)
    assert torch.equal(torch.get_rng_state(), cpu_rng)
    # a retried step lands where one clean step does
    model2 = SmallCNN(width=4, image_size=8, device="cpu")
    step2 = make_train_step(
        image_classifier_loss(), PowerSGDReducer(random_seed=7, compression_rank=2, matricize="last", reuse_query=False),
        model2, 0.05, algorithm="optax", optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-3),
    )
    ref = step2.init_state()
    ref, _ = step2(ref, _batch(0))
    torch.set_rng_state(cpu_rng)
    ref, _ = step2(ref, _batch(1))
    torch.set_rng_state(cpu_rng)
    state, _ = guarded(state, _batch(1))
    assert len(calls) == 2
    assert all(torch.equal(state.params[k], v) for k, v in ref.params.items())


def test_guarded_step_without_retries_makes_no_copy():
    _, step, state = resnet_resume_setup(None)
    guarded = GuardedStep(step, retries=0, telemetry=_telemetry()[0])
    assert guarded.snapshot is None
    state, loss = guarded(state, _batch(0))
    assert np.isfinite(float(loss))


def test_guarded_step_oom_writes_the_report_and_is_not_retried(tmp_path):
    _, step, state = resnet_resume_setup(None)
    before = snapshot(state)
    calls = []

    def dies(st, batch):
        calls.append(1)
        step(st, batch)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 80.00 GiB")

    tel, sink = _telemetry()
    path = str(tmp_path / "artifacts" / "oom_report.json")
    guarded = GuardedStep(dies, retries=2, telemetry=tel, label="t", rank=0, oom_report_path=path,
                          buffers_fn=lambda: {"params": 4.0, "ef_memory": 9.0})
    with pytest.raises(OutOfMemoryError):
        guarded(state, _batch(0))
    assert calls == [1]
    report = json.load(open(path))
    assert report["kind"] == "oom" and report["top_buffer"] == "ef_memory" and "80.00 GiB" in report["error"]
    assert _kinds(sink) == ["oom"]
    _bitwise(snapshot(state), before, "after the OOM")


# ---- the chaos matrix through resilient_train_loop (one process) ----------------


def _run(tmp_path, name, plan=None, **kw):
    _, step, state = resnet_resume_setup(None)
    tel, sink = _telemetry()
    state, logger, start = resilient_train_loop(
        step, state, lambda e: chaos_batches_np(e), CHAOS_EPOCHS, str(tmp_path / name), torch.device("cpu"),
        telemetry=tel, run_name=name, chaos_plan=plan, **kw,
    )
    return snapshot(state), sink, start, logger


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("clean"), "clean")


@pytest.mark.parametrize("kind", ["loader_bad_batch", "loader_short_batch"])
def test_chaos_matrix_loader_faults_dropped(tmp_path, kind):
    plan = ChaosPlan([FaultSpec(kind=kind, step=1)], seed=3)
    state, sink, _, logger = _run(tmp_path, kind, plan, guard_batches=True, expected_batch=CHAOS_BATCH)
    kinds = _kinds(sink)
    assert kinds.count("chaos_injected") == 1 and kinds.count("bad_batch_dropped") == 1
    assert len(logger.records) == CHAOS_EPOCHS * CHAOS_STEPS - 1
    assert all(torch.isfinite(v).all() for v in state["params"].values())


@pytest.mark.parametrize("kind", ["step_transient", "step_nan"])
def test_chaos_matrix_step_faults_retried_bit_exact(tmp_path, clean, kind):
    plan = ChaosPlan([FaultSpec(kind=kind, step=2)], seed=3)
    state, sink, _, _ = _run(tmp_path, kind, plan, step_retries=2)
    kinds = _kinds(sink)
    assert kinds.count("chaos_injected") == 1 and kinds.count("retry") == 1
    _bitwise(state, clean[0], kind)


@pytest.mark.parametrize("kind", ["ckpt_torn", "ckpt_bitflip"])
def test_chaos_matrix_checkpoint_faults_fall_back(tmp_path, clean, kind):
    plan = ChaosPlan([FaultSpec(kind=kind, step=1)], seed=3)
    _run(tmp_path, "ckpt", plan)
    root = str(tmp_path / "ckpt")
    if kind == "ckpt_torn":
        assert latest_step_path(root) == os.path.join(root, "step_0")
    else:
        assert latest_step_path(root) == os.path.join(root, "step_1")
        ok, reason = verify_checkpoint(os.path.join(root, "step_1"))
        assert not ok and "checksum mismatch" in reason
    state, sink, start, _ = _run(tmp_path, "ckpt")
    assert start == 1
    if kind == "ckpt_bitflip":
        assert "checkpoint_fallback" in _kinds(sink)
    ok, reason = verify_checkpoint(os.path.join(root, "step_1"))
    assert ok, reason
    _bitwise(state, clean[0], kind)  # epoch 1 re-trained from step_0: the same run


def _jax_combined(tmp_path, plan_json):
    model = JaxSmallCNN(width=4)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]

    def lf(p, b):
        x, y = b
        return cross_entropy_loss(model.apply({"params": p}, x), y)

    step = jax_make_train_step(
        stateless_loss(lf), JaxPowerSGD(random_seed=7, compression_rank=2, matricize="last"), params,
        learning_rate=0.05, momentum=0.9, algorithm="ef_momentum", mesh=make_mesh(devices=jax.devices()[:1]),
        donate_state=False,
    )
    sink = JaxMemorySink()
    batches = lambda e: (tuple(jnp.asarray(a) for a in b) for b in chaos_batches_np(e))  # noqa: E731
    jax_resilient_train_loop(
        step, step.init_state(params), batches, CHAOS_EPOCHS, checkpoint_dir=str(tmp_path / "jax"),
        telemetry=JaxTelemetry([sink]), run_name="combined", chaos_plan=jchaos.ChaosPlan.from_json(plan_json),
        step_retries=2, guard_batches=True, expected_batch=CHAOS_BATCH,
    )
    return sink


def test_chaos_full_matrix_combined_as_the_jax_loop(tmp_path):
    plan = ChaosPlan([
        FaultSpec(kind="loader_bad_batch", step=0), FaultSpec(kind="loader_short_batch", step=3),
        FaultSpec(kind="step_transient", step=1), FaultSpec(kind="step_nan", step=2),
    ], seed=5)
    state, sink, _, _ = _run(
        tmp_path, "combined", ChaosPlan.from_json(plan.to_json()), step_retries=2, guard_batches=True,
        expected_batch=CHAOS_BATCH,
    )
    kinds = _kinds(sink)
    assert kinds.count("chaos_injected") == 4 and kinds.count("bad_batch_dropped") == 2 and kinds.count("retry") == 2
    assert all(torch.isfinite(v).all() for v in state["params"].values())
    jax_sink = _jax_combined(tmp_path, plan.to_json())
    fields = lambda recs: sorted(  # noqa: E731
        (r["kind"], r.get("label") if r["kind"] == "chaos_injected" else "", r.get("step"))
        for r in recs if r.get("event") == "failure" and r["kind"] != "retry"
    )
    assert fields(sink.records) == fields(jax_sink.records)
    assert [r["kind"] for r in jax_sink.records if r.get("event") == "failure"].count("retry") == 2


def test_preempt_grace_checkpoint_and_midepoch_resume(tmp_path, clean):
    plan = ChaosPlan([FaultSpec(kind="proc_preempt", step=1)], seed=3)
    root = tmp_path / "preempt"
    tel, sink = _telemetry()
    _, step, state = resnet_resume_setup(None)
    with PreemptionGuard(telemetry=tel) as guard:
        resilient_train_loop(
            step, state, lambda e: chaos_batches_np(e), CHAOS_EPOCHS, str(root), torch.device("cpu"),
            telemetry=tel, chaos_plan=plan, preemption_guard=guard,
        )
    assert guard.checkpoint_saved
    assert {"chaos_injected", "preempt_notice", "preempt_checkpoint"} <= set(_kinds(sink))
    assert read_topology(str(root / "step_0"))["epoch_cursor"] == {"epoch": 0, "batches_done": 2}
    resumed, sink, start, _ = _run(tmp_path, "preempt")
    assert start == 0
    assert "+2 steps" in next(r["message"] for r in sink.records if r.get("kind") == "resumed")
    _bitwise(resumed, clean[0], "preempt")


def test_oom_fault_writes_the_report_and_stops(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    plan = ChaosPlan([FaultSpec(kind="oom", step=1, payload={"bytes": 1 << 34})])
    with pytest.raises(OutOfMemoryError):
        _run(tmp_path, "oom", plan, step_retries=2)
    report = json.load(open(tmp_path / "artifacts" / "oom_report.json"))
    assert report["step"] == 1 and "RESOURCE_EXHAUSTED" in report["error"]
    assert report["top_buffer"] in ("params", "momenta", "ef_memory")


@pytest.mark.skipif(os.geteuid() == 0, reason="root ignores mode bits, so a chmod cannot refuse the next save")
def test_ckpt_unwritable_fault_exits_44(tmp_path):
    plan = ChaosPlan([FaultSpec(kind="ckpt_unwritable", step=0)])
    try:
        with pytest.raises(SystemExit) as e:
            _run(tmp_path, "ro", plan)
        assert e.value.code == 44
    finally:
        chaos.restore_checkpoint_writable(str(tmp_path / "ro"))


# ---- world 2 on Gloo: the fault on one rank ------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("chaos_world")
    out = {}
    thread = threading.Thread(
        target=lambda: out.update(ranks=spawn(run_all, 2, root, [(chaos_world_rank, (str(root),))], timeout=120))
    )
    thread.start()
    thread.join(150)
    assert not thread.is_alive(), "the ranks hung"
    return [r[0] for r in out["ranks"]]


def test_fault_on_one_rank_equals_fault_on_every_rank(world):
    for rank, out in enumerate(world):
        _bitwise(out["one"], out["every"], f"rank {rank}")
        assert all(torch.equal(out["one"]["params"][k], world[0]["one"]["params"][k]) for k in out["one"]["params"])
        assert out["one_steps"] == out["every_steps"] == CHAOS_EPOCHS * CHAOS_STEPS - 1


def test_step_faults_on_one_rank_retry_every_rank_bit_exact(world):
    for rank, out in enumerate(world):
        _bitwise(out["step_one"], out["clean"], f"rank {rank}")
        assert out["step_one_kinds"].count("retry") == 2
        assert out["step_one_kinds"].count("chaos_injected") == (2 if rank == 1 else 0)


def test_batch_verdict_is_one_collective_a_batch_outside_the_bits(world):
    for rank, out in enumerate(world):
        kinds = [k for k, _, _ in out["one_records"]]
        assert kinds.count("bad-batch-flag") == CHAOS_EPOCHS * CHAOS_STEPS
        assert out["one_dropped"] == 1


def test_step_nan_without_retries_is_recorded_not_a_crash(tmp_path):
    """Without ``step_retries`` an injected NaN reaches the loop as the
    step's loss (a host float): it is logged, and the state does not move
    for that step, as in the JAX loop."""
    plan = ChaosPlan([FaultSpec(kind="step_nan", step=1)])
    _, sink, _, logger = _run(tmp_path, "nan", plan)
    losses = [r.loss for r in logger.records]
    assert len(losses) == CHAOS_EPOCHS * CHAOS_STEPS and np.isnan(losses[1])
    assert np.isfinite(np.delete(losses, 1)).all() and _kinds(sink) == ["chaos_injected"]
