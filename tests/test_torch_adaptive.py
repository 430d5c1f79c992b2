"""The port's adaptive loop and its entry points against the JAX package.

- ``adaptive_train_loop`` on the small ResNet-18 at two Gloo ranks against
  the JAX loop on two CPU devices, from the same weights, batches and
  PowerSGD Q: a scripted controller descends at the end of epochs 0 and 1
  (exact DDP, then PowerSGD rank 2, then rank 1 in 2 chunks), at the
  reference's rate 0.001. The losses and parameters are held within
  rtol = atol = 1e-5 and each rank's BatchNorm means within 1e-4 (XLA
  and PyTorch sum the convolutions' backward in other orders; the running
  variances within rtol 1e-2, since the port keeps torch's unbiased
  estimate where flax keeps the biased one); the
  momenta, the sum of nine gradients of a random ResNet whose fp32
  gradient is ill-conditioned in both frameworks (``torch_parity``), as
  one vector within 1e-3 of the JAX momenta's norm (2.2e-4 measured on
  the CPU). At each switch the parameters and momenta are the same
  tensors and the EF memories 0.
- ``exact_cifar10.run(adaptive_comm=True)`` under a plan and a stall: the
  stall expires, the step is retried, and the run descends to the plan's
  compressed rung, each rung's first step audited byte-exact.
- The launcher's ``--adaptive-comm``, ``--comm-fabric`` and ``--plan``:
  ``apply_plan`` against the JAX launcher's, and every refusal before any
  rendezvous.

Timing: the parity runs take a 30 s deadline floor, so that no expiry can
come from the machine's load; the stall that must expire sleeps 1 s
against the 0.05 s default floor (20 times).
"""

import json

import jax
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu import launch as jax_launch
from network_distributed_pytorch_tpu.experiments.common import adaptive_train_loop as jax_adaptive_train_loop
from network_distributed_pytorch_tpu.experiments.common import image_classifier_loss as jax_image_classifier_loss
from network_distributed_pytorch_tpu.models import resnet18 as jax_resnet18
from network_distributed_pytorch_tpu.parallel import make_mesh
from network_distributed_pytorch_tpu.parallel.reducers import ExactReducer as JaxExactReducer
from network_distributed_pytorch_tpu.parallel.reducers import PowerSGDReducer as JaxPowerSGDReducer
from network_distributed_pytorch_tpu.parallel.trainer import make_train_step as jax_make_train_step
from network_distributed_pytorch_tpu.resilience import FallbackController as JaxFallbackController
from network_distributed_pytorch_tpu.resilience import Rung as JaxRung
from network_distributed_pytorch_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
from network_distributed_pytorch_tpu_torch import launch
from network_distributed_pytorch_tpu_torch.experiments import common, exact_cifar10
from network_distributed_pytorch_tpu_torch.models.import_weights import resnet_state_dict_from_flax
from network_distributed_pytorch_tpu_torch.models.cnn import SmallCNN
from network_distributed_pytorch_tpu_torch.observe import MemorySink, Telemetry
from network_distributed_pytorch_tpu_torch.parallel.reducers import ExactReducer
from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step
from network_distributed_pytorch_tpu_torch.resilience import ChaosPlan, FallbackController, FaultSpec, Rung
from network_distributed_pytorch_tpu_torch.resilience.chaos import CommFaultInjector
from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig
from torch_adaptive_worker import adaptive_parity_rank, alert_nudge_rank
from torch_parity import random_flax_variables, to_numpy
from torch_worker import few_torch_threads, run_all, spawn  # few_torch_threads: autouse

WORLD, EPOCHS, STEPS, BATCH, LR = 2, 3, 3, 16, 0.001  # the reference's exact_cifar10 rate
TOL = 1e-5  # losses and parameters
MOMENTA_REL = 1e-3  # the momenta as one vector: |port - jax| / |jax|
STATS_TOL = 1e-4
VAR_RTOL = 1e-2
LADDER = [
    ("baseline", {}),
    ("compress", {"reducer": "powersgd", "reducer_rank": 2}),
    ("compress-low-rank", {"reducer": "powersgd", "reducer_rank": 1, "comm_chunks": 2}),
]
MOVES = {0: +1, 1: +1}


class JaxScripted(JaxFallbackController):
    def __init__(self, moves, **kw):
        super().__init__(**kw)
        self.moves = dict(moves)

    def observe(self, health):
        delta = self.moves.get(health.epoch)
        return None if delta is None else self._move(delta, f"scripted:{delta}", health.epoch)


def _batches():
    rng = np.random.RandomState(11)
    return [
        [(rng.randn(BATCH, 32, 32, 3).astype(np.float32), rng.randint(0, 10, BATCH).astype(np.int32))
         for _ in range(STEPS)]
        for _ in range(EPOCHS)
    ]


def _jax_run(variables, batches):
    model = jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16)
    params = variables["params"]
    loss_fn = jax_image_classifier_loss(model, has_batch_stats=True)
    mesh = make_mesh(devices=jax.devices()[:WORLD])

    def factory(overrides):
        if overrides.get("reducer") == "powersgd":
            reducer = JaxPowerSGDReducer(random_seed=7, compression_rank=overrides["reducer_rank"], matricize="last",
                                         comm_chunks=overrides.get("comm_chunks"))
        else:
            reducer = JaxExactReducer(comm_chunks=overrides.get("comm_chunks"))
        return jax_make_train_step(loss_fn, reducer, params, LR, momentum=0.9, algorithm="ef_momentum", mesh=mesh,
                                   donate_state=False)

    controller = JaxScripted(MOVES, ladder=[JaxRung(n, o) for n, o in LADDER])
    state, logger, controller = jax_adaptive_train_loop(
        factory, params, {"batch_stats": variables["batch_stats"]}, lambda e: iter(batches[e]), EPOCHS, controller,
        fabric="10GbE", deadline_floor_s=30.0,
    )
    q = {
        name: np.asarray(JaxPowerSGDReducer(random_seed=7, compression_rank=o["reducer_rank"], matricize="last",
                                            comm_chunks=o.get("comm_chunks")).init(params).q_memory)
        for name, o in LADDER if o
    }
    return to_numpy(state), [r.loss for r in logger.records], controller, q


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    model = jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16)
    variables = to_numpy(random_flax_variables(model, (1, 32, 32, 3), seed=25))
    batches = _batches()
    j_state, j_losses, j_controller, q = _jax_run(variables, batches)
    sd = resnet_state_dict_from_flax(variables)
    call = (adaptive_parity_rank, (sd, variables["params"], q, LADDER, MOVES, batches, LR))
    ranks = spawn(run_all, WORLD, tmp_path_factory.mktemp("ranks"), [call])
    return j_state, j_losses, j_controller, [r[0] for r in ranks]


def test_decisions_and_the_carry(parity):
    _, _, j_controller, ranks = parity
    want = [(d.action, d.rung_before, d.rung_after, d.epoch) for d in j_controller.decisions]
    assert want == [("descend", "baseline", "compress", 0), ("descend", "compress", "compress-low-rank", 1)]
    for res in ranks:
        assert res["decisions"] == want and res["rung"] == "compress-low-rank"
        assert res["carried"] == [{"params_same": True, "momenta_same": True, "memories_zero": True}] * 2


def test_losses_params_momenta_and_statistics_match_the_jax_loop(parity):
    j_state, j_losses, _, ranks = parity
    want_params = resnet_state_dict_from_flax({"params": j_state.params})
    want_momenta = resnet_state_dict_from_flax({"params": j_state.momenta})
    stats = j_state.model_state["batch_stats"]
    for rank, res in enumerate(ranks):
        np.testing.assert_allclose(res["losses"], j_losses, rtol=TOL, atol=TOL)
        for name, w in want_params.items():
            np.testing.assert_allclose(res["params"][name].numpy(), w.numpy(), rtol=TOL, atol=TOL, err_msg=name)
        got = np.concatenate([res["momenta"][k].numpy().ravel() for k in want_momenta])
        want = np.concatenate([v.numpy().ravel() for v in want_momenta.values()])
        assert np.linalg.norm(got - want) <= MOMENTA_REL * np.linalg.norm(want)
        want_stats = resnet_state_dict_from_flax({"batch_stats": jax.tree_util.tree_map(lambda a: a[rank], stats)})
        for name, v in want_stats.items():
            if name.endswith("num_batches_tracked"):
                continue
            # the port keeps torch's unbiased running variance, flax the
            # biased one (test_torch_resnet.py): a factor n / (n - 1) on each
            # update, n >= 128 values a channel here
            tol = VAR_RTOL if name.endswith("running_var") else STATS_TOL
            np.testing.assert_allclose(res["buffers"][name].numpy(), v.numpy(), rtol=tol, atol=STATS_TOL,
                                       err_msg=name)


# ---- the entry point ----------------------------------------------------------------


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_exact_cifar10_descends_under_a_stall(tmp_path):
    """A plan ranking ``compress`` next to the baseline for NVLink, and a
    1 s stall at step 2: the deadline expires, the step is retried, and
    the epoch's verdict descends to ``compress``; every rung's first step
    audits byte-exact against its ``bits_per_step``, and the health probe
    runs every 2 steps on whichever rung is current."""
    plan_doc = tmp_path / "plan_doc.json"
    plan_doc.write_text(json.dumps({"ladder": {"NVLink4(H100)": ["baseline", "compress", "compress-low-rank"]}}))
    ChaosPlan([FaultSpec(kind="comm_stall", step=2, payload={"stall_seconds": 1.0})]).save(str(tmp_path / "chaos.json"))
    cfg = ExperimentConfig(
        training_epochs=2, global_batch_size=16, adaptive_comm=True, chaos_plan=str(tmp_path / "chaos.json"),
        plan_path=str(plan_doc), event_log=str(tmp_path / "events.jsonl"), log_every=0, health_every=2,
    )
    out = exact_cifar10.run(cfg, preset="small", device="cpu", max_steps_per_epoch=4)
    assert out["final_rung"] in ("compress", "compress-low-rank") and out["policy_decisions"] >= 1
    events = _events(tmp_path / "events.jsonl")
    kinds = [e.get("kind") for e in events if e.get("event") == "failure"]
    assert {"chaos_injected", "comm_deadline", "comm_step_retry"} <= set(kinds)
    policy = [e for e in events if e.get("event") == "policy"]
    assert (policy[0]["rung_before"], policy[0]["rung_after"], policy[0]["epoch"]) == ("baseline", "compress", 0)
    assert policy[0]["predicted_bytes_per_step"] < policy[0]["realized_bytes_per_step"]
    audits = [e for e in events if e.get("event") == "compile"]
    assert len(audits) == 1 + len(policy) and all(a["exact"] for a in audits)
    assert audits[0]["analytic_bytes"] == policy[0]["realized_bytes_per_step"]
    assert audits[1]["analytic_bytes"] == policy[0]["predicted_bytes_per_step"]
    assert len(out["losses"]) == 8 and np.isfinite(out["losses"]).all()
    health = [e for e in events if e.get("event") == "train_health"]
    assert [e["step"] for e in health] == [2, 4, 6, 8] and all(np.isfinite(e["grad_norm"]) for e in health)
    assert out["bits_per_step"] == 8 * audits[-1]["analytic_bytes"]


@pytest.mark.parametrize("audit", [False, True])
def test_no_deadline_watches_the_audited_step(audit):
    """A 0.5 s stall on the collective of step 0 and another on step 1,
    against the 0.05 s floor, on a SmallCNN in 2 chunks. Unaudited, both
    expire and both steps are retried. Audited, step 0 counts its FLOPs
    by dispatching every op through Python inside the chunks' windows, so
    no deadline watches it: only step 1 expires."""
    model = SmallCNN(width=4, image_size=8, device="cpu", seed=4)
    rng = np.random.RandomState(3)
    batches = [(rng.randn(4, 8, 8, 3).astype(np.float32), rng.randint(0, 10, 4)) for _ in range(3)]
    sink = MemorySink()
    telemetry = Telemetry([sink])
    plan = ChaosPlan([FaultSpec(kind="comm_stall", step=s, payload={"stall_seconds": 0.5}) for s in (0, 1)])
    common.adaptive_train_loop(
        lambda overrides: make_train_step(common.image_classifier_loss(), ExactReducer(comm_chunks=2), model, 0.05, 0.9,
                                          "ef_momentum", None),
        lambda epoch: iter(batches), 1, FallbackController([Rung("baseline", {})]), torch.device("cpu"),
        injector=CommFaultInjector(plan, telemetry=telemetry), telemetry=telemetry, audit=audit,
    )
    failures = [(r["kind"], r.get("step")) for r in sink.records if r.get("event") == "failure"]
    assert [f for f in failures if f[0] == "chaos_injected"] == [("chaos_injected", 0), ("chaos_injected", 1)]
    assert [f[1] for f in failures if f[0] == "comm_step_retry"] == ([1] if audit else [0, 1])
    assert len([f for f in failures if f[0] == "comm_deadline"]) == (1 if audit else 2)
    assert len([r for r in sink.records if r.get("event") == "compile"]) == int(audit)


def test_alert_feed_is_not_ported(tmp_path):
    """The alert feed is ported: on two Gloo ranks, an alert that lands
    between two steps nudges both ranks at the same step, although one of
    them reads the file a poll late. No hang, one rebuild each at step 5,
    parameters equal bit for bit across the ranks, and one agreement a
    step (kind ``alert-nudge``)."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    call = (alert_nudge_rank, (str(run_dir), 5, 1))
    ranks = [r[0] for r in spawn(run_all, WORLD, tmp_path, [call])]
    for res in ranks:
        # the initial build, then the rebuild after step 5 (the one the alert preceded)
        assert res["rebuilt_at"] == [0, 5], res["rebuilt_at"]
        assert res["decisions"] == [("descend", "alert:step_time_drift:warn", 1, "compress")]
        assert res["steps"] == 8 and res["nudge_agreements"] == 8
    a, b = ranks[0]["params"], ranks[1]["params"]
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---- the launcher -------------------------------------------------------------------


def _no_rendezvous(*args, **kwargs):
    raise AssertionError("a refusal must come before the rendezvous")


@pytest.mark.parametrize("kwargs,match", [
    ({"checkpoint_dir": "ckpt"}, "pick one"),
    ({"strategy": "fsdp"}, "adaptive_comm requires strategy='ddp'"),
])
def test_run_refuses_before_the_rendezvous(monkeypatch, tmp_path, kwargs, match):
    monkeypatch.setattr(common, "initialize_distributed", _no_rendezvous)
    cfg = exact_cifar10.default_config()
    cfg.adaptive_comm = True
    if "checkpoint_dir" in kwargs:
        kwargs = {"checkpoint_dir": str(tmp_path / "ckpt")}
    with pytest.raises(ValueError, match=match):
        exact_cifar10.run(cfg, device="cpu", **kwargs)


@pytest.mark.parametrize("argv,match", [
    (["powersgd_cifar10", "--adaptive-comm"], "--adaptive-comm is not supported by 'powersgd_cifar10'"),
    (["exact_cifar10", "--comm-fabric", "1GbE"], "--comm-fabric requires --adaptive-comm or --plan"),
    (["imdb_baseline", "--plan", "p.json"], "--plan is not supported by 'imdb_baseline'"),
    (["exact_cifar10", "--adaptive-comm", "--strategy", "fsdp"], "adaptive_comm requires strategy='ddp'"),
    (["exact_cifar10", "--adaptive-comm", "--checkpoint-dir", "ckpt"], "pick one"),
])
def test_launcher_refuses_before_the_rendezvous(monkeypatch, argv, match):
    monkeypatch.setattr(common, "initialize_distributed", _no_rendezvous)
    with pytest.raises(ValueError, match=match):
        launch.main(argv + ["--device", "cpu"])


def test_launcher_takes_only_the_port_fabrics():
    with pytest.raises(SystemExit):
        launch.build_parser().parse_args(["exact_cifar10", "--adaptive-comm", "--comm-fabric", "ICI(v5e)"])
    args = launch.build_parser().parse_args(["exact_cifar10", "--adaptive-comm"])
    assert launch.config_from_args(args).comm_fabric == "NVLink4(H100)"


PLAN_DOC = {"fabrics": {
    "10GbE": {"best": {"config": {"reducer": "exact", "comm_chunks": 4, "comm_strategy": "ring",
                                  "bucket_bytes": 1 << 20}}},
    "1GbE": {"best": {"config": {"reducer": "PowerSGDReducer", "reducer_rank": 2, "comm_chunks": 8}}},
    "ICI(v5e)": {"best": {"config": {"comm_chunks": 2}}},
}}


@pytest.mark.parametrize("argv", [
    ["exact_cifar10", "--comm-fabric", "10GbE"],
    ["exact_cifar10", "--comm-fabric", "10GbE", "--comm-chunks", "2"],
    ["exact_cifar10", "--comm-fabric", "1GbE"],
    ["powersgd_cifar10", "--comm-fabric", "1GbE", "--reducer-rank", "8"],
    ["exact_cifar10", "--comm-fabric", "100GbE", "--adaptive-comm"],
])
def test_apply_plan_as_the_jax_launcher(tmp_path, capsys, argv):
    """The knobs a plan sets (the command line's win), and its warnings,
    as the JAX launcher's ``apply_plan`` gives them; a fabric the plan
    does not name leaves the knobs as they are."""
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(PLAN_DOC))
    args = launch.build_parser().parse_args(argv + ["--plan", str(path)])
    cfg = launch.config_from_args(args)
    launch.apply_plan(cfg, args)
    port_err = capsys.readouterr().err
    j_args = jax_launch.build_parser().parse_args(argv + ["--plan", str(path)])
    j_cfg = JaxExperimentConfig()
    for name in ("comm_chunks", "comm_strategy", "bucket_bytes", "reducer_rank"):
        setattr(j_cfg, name, getattr(launch.config_from_args(args), name))
    jax_launch.apply_plan(j_cfg, j_args)
    jax_err = capsys.readouterr().err
    for name in ("comm_chunks", "comm_strategy", "bucket_bytes", "reducer_rank", "plan_path"):
        assert getattr(cfg, name) == getattr(j_cfg, name), name
    assert port_err == jax_err


def test_launcher_runs_adaptive_exact_cifar10(tmp_path):
    out = launch.main([
        "exact_cifar10", "--device", "cpu", "--global-batch", "16", "--epochs", "1", "--max-steps-per-epoch", "3",
        "--adaptive-comm", "--comm-fabric", "10GbE", "--json",
    ])
    assert out["final_rung"] == "baseline" and out["policy_decisions"] == 0 and out["steps"] == 3
