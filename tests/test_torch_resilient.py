"""The port's ``resilient_train_loop`` at world 2 on Gloo (one spawn of two
ranks for the whole module):

- a crash on entry to epoch 2 and a resume, ``guard.request()`` on one
  rank after step 1 of epoch 1 and a resume, and a real SIGTERM to the
  other rank after the same step and a resume, each equal to the
  uninterrupted run bit for bit (params, momenta, EF memories, Q and the
  BatchNorm buffers, ``num_batches_tracked`` included) on the small
  ResNet-18 under PowerSGD with ``ef_momentum``; the SIGTERM stops both
  ranks at the same step;
- the preemption flag is one ``"preempt-flag"`` collective a step, outside
  the step's bits;
- the uninterrupted run of a SmallCNN from the JAX run's initial state
  (``train_state_from_jax``) against the JAX package's
  ``resilient_train_loop`` on a two-device mesh, within the training
  parity tolerance of ``test_torch_training.py`` (fp32, rtol = atol =
  1e-4 for params, momenta and memories).

And on one process: the guard, the watchdog, the heartbeat, the loop's
refusals and its hooks left off.
"""

import signal
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.experiments.common import resilient_train_loop as jax_resilient_train_loop
from network_distributed_pytorch_tpu.models import SmallCNN as JaxSmallCNN
from network_distributed_pytorch_tpu.parallel import PowerSGDReducer as JaxPowerSGD
from network_distributed_pytorch_tpu.parallel import make_mesh
from network_distributed_pytorch_tpu.parallel.trainer import make_train_step as jax_make_train_step
from network_distributed_pytorch_tpu.parallel.trainer import stateless_loss
from network_distributed_pytorch_tpu.utils import cross_entropy_loss
from network_distributed_pytorch_tpu_torch.experiments.common import adaptive_train_loop, resilient_train_loop, train_loop
from network_distributed_pytorch_tpu_torch.models.import_weights import resnet_state_dict_from_flax
from network_distributed_pytorch_tpu_torch.observe import FailureEvent
from network_distributed_pytorch_tpu_torch.resilience import PreemptionGuard
from network_distributed_pytorch_tpu_torch.utils.failure import HeartbeatMonitor, StepWatchdog
from torch_parity import to_numpy
from torch_worker import (  # few_torch_threads: autouse
    RESUME_EPOCHS,
    RESUME_HW,
    RESUME_STEPS,
    few_torch_threads,
    resnet_resume_setup,
    resume_batches,
    resume_rank,
    run_all,
    smallcnn_jax_parity_rank,
    spawn,
)

TOL = 1e-4  # test_torch_training.py's parity tolerance after a few fp32 steps
FIELDS = ("params", "momenta", "memories", "buffers", "q")


def _jax_setup():
    """The JAX package's SmallCNN step on two devices, its initial state,
    and that state with numpy leaves as ``train_state_from_jax`` reads it."""
    model = JaxSmallCNN(width=4)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, RESUME_HW, RESUME_HW, 3)))["params"]

    def lf(p, b):
        x, y = b
        return cross_entropy_loss(model.apply({"params": p}, x), y)

    step = jax_make_train_step(
        stateless_loss(lf), JaxPowerSGD(random_seed=7, compression_rank=2, matricize="last"), params,
        learning_rate=0.05, momentum=0.9, algorithm="ef_momentum", mesh=make_mesh(devices=jax.devices()[:2]),
        donate_state=False,
    )
    init = step.init_state(params)
    init_np = to_numpy(init)
    jax_init = types.SimpleNamespace(
        params=init_np.params, momenta=init_np.momenta, memories=init_np.memories,
        reducer_state=types.SimpleNamespace(q_memory=init_np.reducer_state.q_memory), model_state=None,
    )
    return step, init, jax_init


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks run while this process runs the JAX loop."""
    root = tmp_path_factory.mktemp("resilient")
    step, init, jax_init = _jax_setup()
    calls = [(resume_rank, (str(root),)), (smallcnn_jax_parity_rank, (str(root), jax_init))]
    spawned = {}
    thread = threading.Thread(target=lambda: spawned.update(out=spawn(run_all, 2, root, calls)))
    thread.start()
    try:
        batches = lambda epoch: (tuple(jnp.asarray(a) for a in b) for b in resume_batches(epoch))  # noqa: E731
        state, logger, _ = jax_resilient_train_loop(step, init, batches, RESUME_EPOCHS, checkpoint_dir=str(root / "jax"))
    finally:
        thread.join()
    out = spawned["out"]
    jax_run = (to_numpy(state), [r.loss for r in logger.records])
    return {"resume": [r[0] for r in out], "parity": [r[1] for r in out], "jax": jax_run}


def _bitwise(got, want, what):
    for field in FIELDS:
        g, w = got[field], want[field]
        if field == "q":
            assert torch.equal(g, w), f"{what}: Q"
            continue
        assert set(g) == set(w), f"{what}: {field}"
        for k in w:
            assert torch.equal(g[k], w[k]), f"{what}: {field} {k}"


@pytest.mark.parametrize("resume", ["crash", "preempt", "sigterm"])
def test_resume_equals_uninterrupted_bit_for_bit(ranks, resume):
    for rank, out in enumerate(ranks["resume"]):
        _bitwise(out[resume], out["ref"], f"rank {rank} {resume}")
        assert out["ref"]["buffers"]["norm_init.num_batches_tracked"].item() == RESUME_EPOCHS * RESUME_STEPS
    # the ranks kept their own memories and BN statistics, and the same params
    a, b = ranks["resume"]
    assert not torch.equal(a["ref"]["memories"]["conv_init.weight"], b["ref"]["memories"]["conv_init.weight"])
    assert not torch.equal(a["ref"]["buffers"]["norm_init.running_mean"], b["ref"]["buffers"]["norm_init.running_mean"])
    assert all(torch.equal(a["ref"]["params"][k], b["ref"]["params"][k]) for k in a["ref"]["params"])


def test_crash_resumes_at_the_next_epoch(ranks):
    for out in ranks["resume"]:
        assert out["crash_start_epoch"] == 2
        assert out["crash_events"] == [("resumed", 1)]


@pytest.mark.parametrize("resume", ["preempt", "sigterm"])
def test_preemption_stops_every_rank_at_the_same_step(ranks, resume):
    """``request()`` on rank 0, or a real SIGTERM to rank 1 alone, after
    step 1 of epoch 1: both ranks stop after that step with an emergency
    checkpoint whose cursor is (1, 1), and the resume re-enters epoch 1
    past it."""
    for out in ranks["resume"]:
        assert out[f"{resume}_stopped_after"] == RESUME_STEPS + 1
        assert out[f"{resume}_flags"] == (True, True)
        assert out[f"{resume}_cursor"] == {"epoch": 1, "batches_done": 1}
        assert out[f"{resume}_start_epoch"] == 1
        assert out[f"{resume}_resumed_steps"] == RESUME_EPOCHS * RESUME_STEPS - (RESUME_STEPS + 1)
        assert out[f"{resume}_events"] == [("resumed", 1)]


def test_preempt_flag_is_one_collective_a_step_outside_the_bits(ranks):
    for out in ranks["resume"]:
        kinds = [k for k, _, _ in out["flag_records"]]
        assert kinds.count("preempt-flag") == RESUME_EPOCHS * RESUME_STEPS
        step_bytes = sum(b for k, _, b in out["flag_records"] if k == "all-reduce")
        assert 8 * step_bytes == out["bits_per_step"] * RESUME_EPOCHS * RESUME_STEPS
        assert set(kinds) == {"all-reduce", "preempt-flag", "checkpoint"}


def test_uninterrupted_run_matches_the_jax_loop(ranks):
    """The port's loop from the JAX run's initial state against the JAX
    loop, rank by rank."""
    jax_final, jax_losses = ranks["jax"]
    named = lambda tree: resnet_state_dict_from_flax({"params": tree})  # noqa: E731
    for rank, out in enumerate(ranks["parity"]):
        np.testing.assert_allclose(out["losses"], jax_losses, rtol=1e-5, atol=1e-5)
        for field, tree in (
            ("params", jax_final.params), ("momenta", jax_final.momenta),
            ("memories", jax.tree_util.tree_map(lambda a: a[rank], jax_final.memories)),
        ):
            for k, w in named(tree).items():
                np.testing.assert_allclose(out[field][k].numpy(), w.numpy(), rtol=TOL, atol=TOL, err_msg=f"{field} {k}")


# ---- one process --------------------------------------------------------------


def test_preemption_guard_restores_the_previous_handler():
    before = signal.getsignal(signal.SIGTERM)
    events = []

    class Sink:
        def emit(self, e):
            events.append(e)

    with PreemptionGuard(telemetry=Sink(), label="t") as guard:
        assert signal.getsignal(signal.SIGTERM) == guard._handle
        assert not guard.requested
        guard.request()
        assert guard.requested and not guard.checkpoint_saved
    assert signal.getsignal(signal.SIGTERM) == before
    assert [(e.kind, e.label) for e in events] == [("preempt_notice", "t")] and isinstance(events[0], FailureEvent)


def test_step_watchdog_fires_after_its_grace():
    fired = []
    wd = StepWatchdog(0.05, on_timeout=fired.append, compile_grace=1)
    with wd.watch("first"):  # spared
        time.sleep(0.15)
    with wd.watch("quick"):
        pass
    with wd.watch("slow"):
        time.sleep(0.3)
    assert fired == ["slow"] and wd.fired == ["slow"]
    wd.reset()
    assert wd.fired == []


def test_heartbeat_monitor_lists_stale_peers(tmp_path):
    a = HeartbeatMonitor(str(tmp_path), 0, 2, startup_grace_seconds=0.0)
    a.beat(epoch=3)
    assert a.peer_payloads()[0]["epoch"] == 3 and a.last_beats()[1] is None
    time.sleep(0.01)
    assert a.stale_peers(60.0) == [1]  # never beat, grace over
    HeartbeatMonitor(str(tmp_path), 1, 2).beat()
    assert a.stale_peers(60.0) == []


def test_loop_refuses_what_is_not_ported(tmp_path):
    """``chaos_plan``, ``step_retries`` and ``guard_batches`` are ported
    (``test_torch_chaos.py``) and run, and so is the adaptive loop
    (``test_torch_adaptive.py``), and now the supervisor's live plane and
    the adaptive loop's alert feed: the configuration takes the plane, and
    a critical alert on the feed descends the adaptive loop at once."""
    from network_distributed_pytorch_tpu_torch.resilience import (
        ChaosPlan,
        FallbackController,
        Rung,
        SupervisorConfig,
    )
    from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig

    for i, kw in enumerate(({"chaos_plan": ChaosPlan()}, {"step_retries": 2}, {"guard_batches": True})):
        _, step, state = resnet_resume_setup(None)
        _, logger, _ = resilient_train_loop(
            step, state, resume_batches, 1, str(tmp_path / str(i)), torch.device("cpu"), **kw
        )
        assert len(logger.records) == RESUME_STEPS
    assert ExperimentConfig(adaptive_comm=True).adaptive_comm
    assert SupervisorConfig(metrics_port=0).metrics_port == 0

    class Feed:
        """One critical alert, read after the second step."""

        def __init__(self):
            self.polls = 0

        def poll(self):
            self.polls += 1
            return [{"event": "alert", "alert": "grad_spike", "severity": "critical"}] if self.polls == 2 else []

    _, step, _ = resnet_resume_setup(None)
    controller = FallbackController(ladder=[Rung("a", {}), Rung("b", {"comm_chunks": 2})])
    feed = Feed()
    _, logger, controller = adaptive_train_loop(
        lambda overrides: step, resume_batches, 1, controller, torch.device("cpu"), alert_feed=feed
    )
    assert [(d.trigger, d.rung_after) for d in controller.decisions] == [("alert:grad_spike:critical", "b")]
    assert len(logger.records) == RESUME_STEPS and feed.polls == RESUME_STEPS


def test_loop_takes_the_trace_the_audit_and_the_probe(tmp_path):
    """``trace_dir``, ``audit`` and ``health_every`` reach the training
    loop: the trace is written, the first step's audit is exact and every
    step has its probe, in the same run log as the checkpoint's events."""
    from network_distributed_pytorch_tpu_torch.experiments.common import process_group
    from network_distributed_pytorch_tpu_torch.observe import MemorySink, Telemetry
    from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig

    sink = MemorySink()
    with process_group(ExperimentConfig(), torch.device("cpu")) as group:  # a world of one
        _, step, state = resnet_resume_setup(group)
        resilient_train_loop(
            step, state, resume_batches, 1, str(tmp_path / "ckpt"), torch.device("cpu"),
            telemetry=Telemetry([sink]), trace_dir=str(tmp_path / "trace"), audit=True, health_every=1,
            run_name="resilient",
        )
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    (audit,) = sink.of_kind("compile")
    assert audit["exact"] and audit["label"] == "resilient"
    assert len(sink.of_kind("train_health")) == len(sink.of_kind("step")) == RESUME_STEPS
    assert not sink.of_kind("failure")


def test_train_loop_hooks_default_off():
    """The hooks off, ``train_loop`` gives the states and losses it always
    gave; ``skip_steps`` leaves the first steps of ``start_epoch`` out and
    ``on_step_end`` returning True stops the loop."""
    runs = []
    for kw in ({}, {"start_epoch": 0, "skip_steps": 0, "watchdog": None, "heartbeat": None}):
        _, step, state = resnet_resume_setup(None)
        state, logger = train_loop(step, state, resume_batches, 2, torch.device("cpu"), **kw)
        runs.append((state.params, [r.loss for r in logger.records]))
    assert runs[0][1] == runs[1][1] and all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in runs[0][0])
    _, step, state = resnet_resume_setup(None)
    seen = []
    _, logger = train_loop(
        step, state, resume_batches, 3, torch.device("cpu"), start_epoch=1, skip_steps=1,
        on_step_end=lambda e, n, s: seen.append((e, n)) or (e, n) == (2, 1),
    )
    assert seen == [(1, 1), (2, 1)] and len(logger.records) == 2
