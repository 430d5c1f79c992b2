"""The port's fence hooks, collective watchdog, deadline guard and comm
fault injector against the JAX package's.

- The fence hooks: a chunked all-reduce on two Gloo ranks calls them at
  each chunk's launch and once at the retire with the infos the JAX
  package's hooks get on two CPU devices (rank r's against device r's),
  the reduced bits unchanged; the reducers' payloads carry the JAX tags.
  With no hook the path is untouched: the fence is never entered, no
  stream is waited for, and a step issues the same aten ops and
  collectives and lands on the same bits as with a hook.
- The watchdog's counters and expiry, and the injector's throttle, stall,
  flap, slow edge and partition lifecycles, against the JAX classes fed
  the same calls (the sleeps recorded, not slept).
- The deadline guard on a real step: a retry lands bit for bit on a clean
  step from the same state, then a step is degraded, then K escalate.
- Two ranks with a stall on rank 1 only: neither hangs, both retry, and
  the parameters equal the clean run's bit for bit.

Timing: a run that must not expire uses a 30 s deadline floor; the stall
that must expire sleeps 20 times its deadline (2 s against 0.1 s).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from network_distributed_pytorch_tpu.observe import MemorySink as JaxMemorySink
from network_distributed_pytorch_tpu.observe import Telemetry as JaxTelemetry
from network_distributed_pytorch_tpu.parallel import comm as jax_comm
from network_distributed_pytorch_tpu.parallel import make_mesh
from network_distributed_pytorch_tpu.parallel.reducers import ExactReducer as JaxExactReducer
from network_distributed_pytorch_tpu.parallel.reducers import PowerSGDReducer as JaxPowerSGDReducer
from network_distributed_pytorch_tpu.resilience import chaos as jax_chaos
from network_distributed_pytorch_tpu.resilience import guards as jax_guards
from network_distributed_pytorch_tpu_torch.experiments.common import image_classifier_loss, process_group
from network_distributed_pytorch_tpu_torch.models.cnn import SmallCNN
from network_distributed_pytorch_tpu_torch.observe import MemorySink, Telemetry
from network_distributed_pytorch_tpu_torch.parallel import comm
from network_distributed_pytorch_tpu_torch.parallel.reducers import ExactReducer
from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step
from network_distributed_pytorch_tpu_torch.resilience import chaos, guards
from network_distributed_pytorch_tpu_torch.resilience import (
    CollectiveWatchdog,
    CommDeadlineGuard,
    CommEscalationError,
    FaultSpec,
    GuardedStep,
    StateSnapshot,
)
from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig
from torch_adaptive_worker import fence_hooks_rank, stall_world_rank
from torch_worker import few_torch_threads, run_all, spawn  # few_torch_threads: autouse

WORLD = 2
N, K = 531, 3
SHAPES = [(6, 4), (4,), (3, 5)]  # JAX layout (in, out); the port's transposed
STALL_S, FLOOR_S = 2.0, 0.1


def _sends():
    rng = np.random.RandomState(8)
    return [[rng.randn(*s).astype(np.float32) for s in SHAPES] for _ in range(WORLD)]


def _port(a):
    return torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a))


def _jax_hooks(flat):
    """The JAX package's hooks on two CPU devices: the chunked all-reduce,
    then the bucketed exact reducer, then PowerSGD; per-device infos."""
    mesh = make_mesh(devices=jax.devices()[:WORLD])
    seen = []

    def hook(info):
        seen.append((info["tag"], info["chunk"], info["n_chunks"], info["payload_bytes"], info["phase"],
                     info["device_index"]))

    def per_device(records):
        return {d: [r[:5] for r in records if r[5] == d] for d in range(WORLD)}

    def shard(body, *xs):
        fn = jax.shard_map(body, mesh=mesh, in_specs=tuple(P("data") for _ in xs), out_specs=P("data"))
        return jax.block_until_ready(jax.jit(fn)(*xs))  # the host callbacks have run

    jax_comm.add_fence_hook(hook)
    try:
        shard(lambda x: jax_comm.chunked_all_reduce_mean(x[0], "data", K, tag="t")[None], flat)
        chunked = per_device(seen)
        seen.clear()
        stacked = [jnp.stack([jnp.asarray(w[i]) for w in _sends()]) for i in range(len(SHAPES))]
        exact = JaxExactReducer(bucket_bytes=64, comm_chunks=2)
        shard(lambda *s: exact.reduce({}, [x[0] for x in s], "data")[1][0][None], *stacked)
        exact_tags = per_device(seen)
        seen.clear()
        psgd = JaxPowerSGDReducer(random_seed=3, compression_rank=2)
        template = [jnp.zeros(s) for s in SHAPES]
        state0 = psgd.init(template)
        shard(lambda *s: psgd.reduce(state0, [x[0] for x in s], "data")[1][0][None], *stacked)
        psgd_tags = per_device(seen)
    finally:
        jax_comm.remove_fence_hook(hook)
    return chunked, exact_tags, psgd_tags


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    flat = np.random.RandomState(0).randn(WORLD, N).astype(np.float32)
    sends = [[_port(a) for a in w] for w in _sends()]
    calls = [
        (fence_hooks_rank, (torch.from_numpy(flat[0]), K, sends)),
        (stall_world_rank, (STALL_S, FLOOR_S)),
    ]
    out = spawn(run_all, WORLD, tmp_path_factory.mktemp("ranks"), calls)
    return {"flat": flat, "hooks": [r[0] for r in out], "stall": [r[1] for r in out]}


def test_fence_hooks_see_every_chunk_with_the_jax_infos(ranks):
    """Rank r's hook calls are the JAX package's on device r, field for
    field: three launches, then the retire of the whole payload; the bits
    do not change and on the CPU no stream is waited for."""
    chunked, _, _ = _jax_hooks(jnp.asarray(np.tile(ranks["flat"][:1], (WORLD, 1))))
    for rank, res in enumerate(ranks["hooks"]):
        got = [r[:5] for r in res["chunked"]]
        assert [r[5] for r in res["chunked"]] == [rank] * (K + 1)
        assert got == chunked[rank]
        assert [r[4] for r in got] == ["launch"] * K + ["retire"]
        assert torch.equal(res["hooked"], res["plain"])
        assert res["syncs"] == 0 and not res["active_after"]


def test_reducers_tag_their_payloads_as_the_jax_reducers_do(ranks):
    """The bucketed exact reducer's ``grads.b{i}`` chunks in the JAX order
    (its buckets are fenced one behind the other), with the same bytes;
    PowerSGD's ``powersgd.P``, ``powersgd.rank1`` and ``powersgd.Q`` the
    same calls (XLA runs the rank-1 payload, which depends on no P, before
    P's; the port issues them in program order, P, rank-1, Q)."""
    _, exact, psgd = _jax_hooks(jnp.zeros((WORLD, N)))
    for rank, res in enumerate(ranks["hooks"]):
        assert [r[:5] for r in res["exact"]] == exact[rank]
        fields = lambda rows: sorted((r[0], r[1], r[2], r[4]) for r in rows)  # noqa: E731
        assert fields(res["powersgd"]) == fields(psgd[rank])
        assert [r[0] for r in res["powersgd"] if r[4] == "launch"] == ["powersgd.P", "powersgd.rank1", "powersgd.Q"]


class _AtenOps(torch.utils._python_dispatch.TorchDispatchMode):
    """The aten ops a block issues, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _one_step(group, hook=None):
    model = SmallCNN(width=4, image_size=8, device="cpu", seed=2)
    step = make_train_step(image_classifier_loss(), ExactReducer(comm_chunks=3), model, 0.05, 0.9, "sgd", group)
    state = step.init_state()
    rng = np.random.RandomState(1)
    batch = (torch.from_numpy(rng.randn(4, 8, 8, 3).astype(np.float32)), torch.arange(4) % 10)
    if hook is not None:
        comm.add_fence_hook(hook)
    ops = _AtenOps()
    try:
        with comm.record_collectives() as records, ops:
            state, loss = step(state, batch)
    finally:
        if hook is not None:
            comm.remove_fence_hook(hook)
    return {k: v.detach().clone() for k, v in state.params.items()}, float(loss), records, ops.ops


def test_no_hook_leaves_the_step_as_it_was(monkeypatch):
    """With no hook registered the fence is never entered (it raises here)
    and no stream is waited for; a step with a registered hook issues the
    same aten ops and the same collectives and lands on the same bits."""
    with process_group(ExperimentConfig(), torch.device("cpu")) as group:
        seen = []
        with_hook = _one_step(group, seen.append)
        fence = comm._fence

        def refuse(*a, **k):
            raise AssertionError("the fence was entered with no hook registered")

        monkeypatch.setattr(comm, "_fence", refuse)
        syncs = comm.fence_syncs()
        plain = _one_step(group)
        monkeypatch.setattr(comm, "_fence", fence)
    assert comm.fence_syncs() == syncs
    assert [i["phase"] for i in seen] == ["launch"] * 3 + ["retire"]
    for k in plain[0]:
        assert torch.equal(plain[0][k], with_hook[0][k]), k
    assert plain[1] == with_hook[1]
    assert plain[2] == with_hook[2] and plain[3] == with_hook[3]


# ---- the watchdog and the injector against the JAX classes -------------------------


def _info(phase="launch", chunk=0, n_chunks=1, payload=4096, device=0, tag="grads"):
    return {"tag": tag, "chunk": chunk, "n_chunks": n_chunks, "payload_bytes": payload, "phase": phase,
            "device_index": device}


def _watchdog_script(CollectiveWatchdog, Telemetry, MemorySink, fabric):
    """The JAX test's script: a clean window, a blown one (0.5 s past a
    0.05 s deadline), a peer's launch, two degraded steps and the epoch
    counters; returns what it read."""
    sink = MemorySink()
    seen = []
    with CollectiveWatchdog(
        n_workers=8, fabric=fabric, slack=1.0, floor_s=0.05, escalate_after=2, telemetry=Telemetry([sink]), rank=0,
        label="t",
    ) as wd:
        wd.begin_attempt()
        wd(_info())
        wd(_info(phase="retire"))
        seen.append(wd.expired_this_attempt)
        wd.note_step(False)
        wd.begin_attempt()
        wd(_info(chunk=2, n_chunks=4))
        deadline = time.monotonic() + 5.0
        while not wd.expired_this_attempt and time.monotonic() < deadline:
            time.sleep(0.01)
        seen.append(wd.expired_this_attempt)
        seen.append({k: v for k, v in wd.fired[-1].items() if k != "deadline_s"})
        wd.begin_attempt()
        wd(_info(device=3))  # a peer's launch never arms rank 0's deadline
        time.sleep(0.1)
        seen.append(wd.expired_this_attempt)
        wd.note_step(True)
        seen.append(wd.should_escalate())
        wd.note_step(True)
        seen.append(wd.should_escalate())
        seen.append(wd.take_epoch())
        seen.append(wd.take_epoch())
        seen.append(wd.should_escalate())
    events = [(r["kind"], r["label"]) for r in sink.records if r.get("event") == "failure"]
    return seen, events


def test_watchdog_against_the_jax_watchdog():
    port = _watchdog_script(CollectiveWatchdog, Telemetry, MemorySink, "10GbE")
    ref = _watchdog_script(jax_guards.CollectiveWatchdog, JaxTelemetry, JaxMemorySink, "10GbE")
    assert port == ref
    assert port[0][1] is True and port[1] == [("comm_deadline", "grads[2/4]")]


INJECTOR_PLANS = {
    "throttle": [FaultSpec(kind="comm_throttle", step=1, payload={"bytes_per_s": 1e6, "max_sleep_s": 0.04,
                                                                  "duration_steps": 2})],
    "stall": [FaultSpec(kind="comm_stall", step=0, payload={"stall_seconds": 0.05, "chunk": 1})],
    "flap": [FaultSpec(kind="comm_flap", step=2)],
    "slow_edge": [FaultSpec(kind="comm_slow_edge", step=1, payload={"edge": [0, 1], "bytes_per_s": 1e6,
                                                                    "duration_steps": 3})],
    "partition": [FaultSpec(kind="comm_partition", step=2, rank=0, payload={"edge": [0, 1]}),
                  FaultSpec(kind="comm_heal", step=5, rank=0)],
    "partition_duration": [FaultSpec(kind="comm_partition", step=1, rank=0,
                                     payload={"edge": [0, 1], "duration_steps": 2, "max_sleep_s": 0.01})],
    "heal_throttle": [FaultSpec(kind="comm_throttle", step=0), FaultSpec(kind="comm_heal", step=2)],
}
CALLS = [_info(), _info(chunk=1), _info(device=1), _info(phase="retire"), _info(payload=10_000_000)]


def _injector_script(module, Telemetry, MemorySink, faults, monkeypatch):
    """Advance through 7 steps; at each, the flags and the sleeps the
    hook would take for ``CALLS`` (``time.sleep`` recorded, not slept)."""
    slept = []
    monkeypatch.setattr(module.time, "sleep", slept.append)
    sink = MemorySink()
    plan = module.ChaosPlan([module.FaultSpec(kind=f.kind, step=f.step, rank=f.rank, payload=dict(f.payload))
                             for f in faults])
    inj = module.CommFaultInjector(plan, rank=0, telemetry=Telemetry([sink]))
    trace = []
    for step in range(7):
        inj.advance(step)
        for info in CALLS:
            inj(dict(info))
        trace.append((inj.throttled, inj.stall_pending, inj.partitioned, inj.partition_edge, inj.throttle_edge,
                      inj.host_throttle_sleep_s(1e5), list(slept)))
        slept.clear()
    events = [(r["kind"], r["label"], r["step"]) for r in sink.records if r.get("event") == "failure"]
    return trace, events


@pytest.mark.parametrize("name", list(INJECTOR_PLANS))
def test_injector_lifecycle_against_the_jax_injector(name, monkeypatch):
    port = _injector_script(chaos, Telemetry, MemorySink, INJECTOR_PLANS[name], monkeypatch)
    ref = _injector_script(jax_chaos, JaxTelemetry, JaxMemorySink, INJECTOR_PLANS[name], monkeypatch)
    assert port == ref
    assert any(t[6] for t in port[0]) and port[1][0][0] == "chaos_injected"


def test_comm_kinds_have_their_consumer():
    for kind in chaos.COMM_FAULTS:
        assert chaos.INJECTION_SITES[kind] == "comm-hook" == jax_chaos.INJECTION_SITES[kind]
    assert not issubclass(CommEscalationError, RuntimeError) and issubclass(guards.CommDeadlineError, RuntimeError)


# ---- the deadline guard on a real step ------------------------------------------


class _ScriptedWatchdog:
    """The guard's contract double: an expiry verdict per attempt."""

    escalate_after = 3

    def __init__(self, verdicts):
        self._verdicts = list(verdicts)
        self._current = False
        self.noted = []

    def begin_attempt(self):
        self._current = self._verdicts.pop(0) if self._verdicts else False

    @property
    def expired_this_attempt(self):
        return self._current

    def note_step(self, degraded):
        self.noted.append(degraded)

    def should_escalate(self):
        return self.noted[-3:] == [True, True, True]


def _cnn_step():
    model = SmallCNN(width=4, image_size=8, device="cpu", seed=4)
    step = make_train_step(image_classifier_loss(), ExactReducer(), model, 0.05, 0.9, "ef_momentum", None)
    rng = np.random.RandomState(3)
    batches = [
        (torch.from_numpy(rng.randn(4, 8, 8, 3).astype(np.float32)), torch.from_numpy(rng.randint(0, 10, 4)))
        for _ in range(6)
    ]
    return model, step, step.init_state(), batches


def _tensors(state):
    return {f"{f}.{k}": v.detach().clone() for f in ("params", "momenta", "memories", "model_state")
            for k, v in getattr(state, f).items()}


@pytest.mark.parametrize("inner", ["plain", "guarded"])
def test_deadline_guard_retries_from_the_snapshot_then_degrades_then_escalates(inner):
    """Verdicts: clean; expired then clean (the retry starts from the state
    the step began with, so it lands bit for bit on a clean step); expired
    twice (degraded, the late state kept); then expired throughout, which
    escalates at the third degraded step in a row. Over a ``GuardedStep``
    with retries the guard reuses its snapshot, else it takes its own."""
    _, ref_step, ref_state, batches = _cnn_step()
    for b in batches[:2]:
        ref_state, _ = ref_step(ref_state, b)
    want = _tensors(ref_state)
    _, step, state, _ = _cnn_step()
    if inner == "guarded":
        step = GuardedStep(step, retries=2)
    wd = _ScriptedWatchdog([False, True, False, True, True] + [True] * 6)
    sink = MemorySink()
    guard = CommDeadlineGuard(step, wd, telemetry=Telemetry([sink]), label="t")
    assert guard.bits_per_step == step.bits_per_step  # delegation
    state, _ = guard(state, batches[0])
    state, _ = guard(state, batches[1])  # retried once from the snapshot
    got = _tensors(state)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert (guard._own_snapshot is None) == (inner == "guarded")
    state, _ = guard(state, batches[2])
    assert wd.noted == [False, False, True]
    guard(state, batches[3])
    with pytest.raises(CommEscalationError):
        guard(state, batches[4])
    kinds = [r["kind"] for r in sink.records if r.get("event") == "failure"]
    assert kinds.count("comm_step_retry") == 4 and kinds.count("comm_degraded") == 3


def test_snapshot_restore_is_bitwise_after_a_step():
    _, step, state, batches = _cnn_step()
    before = _tensors(state)
    snap = StateSnapshot()
    snap.take(state)
    state, _ = step(state, batches[0])
    snap.restore(state)
    after = _tensors(state)
    assert all(torch.equal(after[k], before[k]) for k in before)


# ---- two ranks, a stall on rank 1 -------------------------------------------------


def test_stall_on_one_rank_neither_hangs_nor_diverges(ranks):
    """Rank 1's collective stalls 2 s against a 0.1 s deadline: both ranks
    expire or agree that one did, retry the step together (one
    ``comm-deadline-flag`` agreement an attempt), finish every step, and
    land bit for bit on the clean run, the same on both ranks."""
    out = ranks["stall"]
    for rank, res in enumerate(out):
        clean, stalled = res["clean"], res["stalled"]
        assert clean["steps"] == stalled["steps"] == 8
        for k, v in clean["params"].items():
            assert torch.equal(stalled["params"][k], v), k
            assert torch.equal(out[0]["stalled"]["params"][k], stalled["params"][k]), k
        assert "comm_step_retry" in stalled["kinds"] and "comm_step_retry" not in clean["kinds"]
        assert ("chaos_injected" in stalled["kinds"]) == (rank == 1)
        flags = [r for r in stalled["records"] if r[0] == "comm-deadline-flag"]
        assert len(flags) >= 8 and all(r[2] == 4 for r in flags)
        assert "comm-deadline-flag" in {r[0] for r in clean["records"]}
    assert out[0]["stalled"]["kinds"].count("comm_step_retry") == out[1]["stalled"]["kinds"].count("comm_step_retry")
