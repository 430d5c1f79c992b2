"""The offline cost model (``observe/costmodel.py``) and the planner
(``scripts/torch_plan.py``) against the JAX package's.

The same inputs go through both packages and the returned dicts and event
records must be equal: the JAX package's synthetic run reports
(``tests/test_costmodel.py``'s and variants), every config of the search
space, and one report that ``scripts/plan.py`` and ``scripts/
torch_plan.py`` both plan on the GbE rows. The pinned differences, by
name: the fabric rows (the port's ``NVLink4(H100)`` where the JAX package
has ``ICI(v5e)``), and ``INNER_FABRIC``, on which a hierarchical config's
inner level is priced; with the JAX package's ICI rate set to the port's
NVLink rate the hierarchical predictions agree too.

The planner replay: two toy ranks on a simulated 1GbE (``--sim-fabric``),
the report, ``torch_plan.py``, a run of the rung it picks, then
``torch_report.py --plan``: the prediction matches the run
(``costmodel.matched``) and the pick beats the default.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import pytest

from network_distributed_pytorch_tpu.observe import analytics as jax_analytics
from network_distributed_pytorch_tpu.observe import costmodel as jax_costmodel
from network_distributed_pytorch_tpu_torch import launch
from network_distributed_pytorch_tpu_torch.observe import costmodel, runlog, telemetry_for_run
from network_distributed_pytorch_tpu_torch.observe.events import PredictionEvent
from network_distributed_pytorch_tpu_torch.resilience import DEFAULT_LADDER, Supervisor, SupervisorConfig
from network_distributed_pytorch_tpu_torch.resilience.controller import ladder_from_plan
from network_distributed_pytorch_tpu_torch.utils import bandwidth

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)
TOY = os.path.join(TESTS_DIR, "torch_toy_supervised_worker.py")
MIB = 1 << 20
GBE = ["1GbE", "10GbE", "100GbE"]


def load_script(name, tag="costmodel"):
    spec = importlib.util.spec_from_file_location(f"_{tag}_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[f"_{tag}_{name}"] = mod
    spec.loader.exec_module(mod)
    return mod


def toy_report(**over):
    """The JAX package's synthetic report: 10 ms of compute, one exposed
    8 MiB all-reduce, an 80 ms step at 2 workers."""
    doc = {
        "run_dir": "synthetic",
        "step_p50_s": 0.08,
        "world_size": 2,
        "bandwidth": {
            "total": {"payload_bytes": 8 * MIB, "count": 1},
            "attribution": {"exposed_fraction": 1.0, "n_collectives": 1},
        },
        "compile": {"analytic_bytes": 8 * MIB, "comm_config": {"reducer": "exactreducer"}},
        "mfu": [{"flops_per_step": 2.0e9, "peak_flops_per_s": 1.0e12}],
        "spans": {"by_name": {"step/compute": {"mean_s": 0.01}}},
    }
    doc.update(over)
    return doc


REPORTS = {
    "toy": toy_report(),
    "four_workers": toy_report(world_size=4),
    "spanless": toy_report(spans=None, mfu=[]),
    "compressed": toy_report(
        bandwidth={"total": {"payload_bytes": 2 * MIB, "count": 1},
                   "attribution": {"exposed_fraction": 1.0, "n_collectives": 1}},
        compile={"analytic_bytes": 2 * MIB, "dense_grad_bytes": 8 * MIB,
                 "comm_config": {"reducer": "powersgd", "reducer_rank": 2}},
    ),
    "ratio_only": toy_report(compile={"analytic_bytes": MIB, "compression_ratio": 8.0,
                                      "comm_config": {"reducer": "PowerSGDReducer", "reducer_rank": 1}}),
    "hierarchical": toy_report(world_size=4, compile={"dense_grad_bytes": 8 * MIB,
                                                       "comm_config": {"reducer": "hierarchical"}}),
    "half_exposed": toy_report(bandwidth={"total": {"payload_bytes": 8 * MIB, "count": 3},
                                          "attribution": {"exposed_fraction": 0.5, "n_collectives": 3}}),
    "no_bandwidth": toy_report(bandwidth=None),
}
SOURCE_FABRICS = [None, "1GbE", "100GbE"]


@pytest.fixture
def same_inner_rate(monkeypatch):
    """The JAX package's ICI row at the port's NVLink rate: the one input
    its hierarchical pricing reads from that row."""
    bw = jax_analytics._load_utils_module("bandwidth")
    monkeypatch.setitem(bw.FABRICS_BYTES_PER_S, "ICI(v5e)", bandwidth.FABRICS_BYTES_PER_S["NVLink4(H100)"])


def test_constants_and_the_pinned_inner_fabric():
    for name in ("PLAN_SCHEMA", "DEFAULT_BYTES_FRACTION_PER_RANK", "POWERSGD_FLOPS_PER_ELEM_PER_RANK",
                 "MAX_PIPELINE_DEPTH", "MIN_COMPUTE_FRACTION", "KNOBS", "DEFAULT_SITES"):
        assert getattr(costmodel, name) == getattr(jax_costmodel, name), name
    assert costmodel.INNER_FABRIC == "NVLink4(H100)" and jax_costmodel.INNER_FABRIC == "ICI(v5e)"
    assert costmodel.INNER_FABRIC in bandwidth.FABRICS_BYTES_PER_S


CONFIGS = [
    {}, {"name": "rung", "reducer": "PowerSGDReducer", "comm_chunks": None}, {"reducer": "exactreducer"},
    {"reducer": "powersgd", "reducer_rank": 2, "sync_every": 8}, {"reducer": "hier", "outer_async": True, "sites": 3},
    {"comm_chunks": 4, "comm_strategy": "ring"}, {"bucket_bytes": 2 * MIB}, {"bucket_bytes": 1}, {"reducer": "topk"},
]


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_canonical_config_and_key_match(i):
    c = CONFIGS[i]
    assert costmodel.canonical_config(c, name="n") == jax_costmodel.canonical_config(c, name="n")
    assert costmodel.config_key(c) == jax_costmodel.config_key(c)


@pytest.mark.parametrize("source", SOURCE_FABRICS)
@pytest.mark.parametrize("name", sorted(REPORTS))
def test_calibrate_matches(name, source):
    got = costmodel.calibrate(REPORTS[name], source_fabric=source)
    want = jax_costmodel.calibrate(REPORTS[name], source_fabric=source)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.effective_flops_per_s == want.effective_flops_per_s


def test_calibrate_refusals_match():
    for bad in ({"world_size": 2}, {"step_p50_s": 0.0}, {"step_p50_s": float("nan")}):
        with pytest.raises(ValueError):
            costmodel.calibrate(bad)
        with pytest.raises(ValueError):
            jax_costmodel.calibrate(bad)


def search_space(calib):
    return costmodel.default_configs(calib) + costmodel.hierarchical_configs(calib, sites=2)


@pytest.mark.parametrize("fabric", GBE)
@pytest.mark.parametrize("name", sorted(REPORTS))
def test_predict_matches_on_every_config(name, fabric, same_inner_rate):
    calib = costmodel.calibrate(REPORTS[name], source_fabric="1GbE")
    jcalib = jax_costmodel.calibrate(REPORTS[name], source_fabric="1GbE")
    configs = search_space(calib)
    assert configs == jax_costmodel.default_configs(jcalib) + jax_costmodel.hierarchical_configs(jcalib, sites=2)
    for c in configs:
        assert costmodel.predict(calib, c, fabric) == jax_costmodel.predict(jcalib, c, fabric)
    matrix = {"edges": [{"src": 0, "dst": 1, "bytes_per_s": 4e9, "latency_s": 1e-5},
                        {"src": 1, "dst": 0, "bytes_per_s": 2.5e8, "latency_s": 5e-4}]}
    for c in configs:
        assert costmodel.predict(calib, c, fabric, matrix) == jax_costmodel.predict(jcalib, c, fabric, matrix)


def test_hierarchical_inner_level_is_priced_on_nvlink():
    """Without the monkeypatch, a hierarchical config over four workers
    (an inner level of two) differs, and only by the inner rate."""
    calib = costmodel.calibrate(REPORTS["four_workers"])
    jcalib = jax_costmodel.calibrate(REPORTS["four_workers"])
    c = {"reducer": "hierarchical", "reducer_rank": 1, "sync_every": 4}
    got, want = costmodel.predict(calib, c, "1GbE"), jax_costmodel.predict(jcalib, c, "1GbE")
    inner_w = 2
    wire = (2.0 * (inner_w - 1) / inner_w) * calib.dense_bytes
    per_step = calib.exposed_fraction * (1.0 + 1.0 / 4)
    nvlink, ici = bandwidth.FABRICS_BYTES_PER_S["NVLink4(H100)"], 200e9
    assert got["predicted_step_s"] - want["predicted_step_s"] == pytest.approx(
        per_step * (wire / nvlink - wire / ici), rel=1e-9)
    same = {k: v for k, v in got.items() if k not in ("predicted_step_s", "exposed_comm_s")}
    assert same == {k: v for k, v in want.items() if k not in ("predicted_step_s", "exposed_comm_s")}


def test_predict_refuses_the_other_package_s_rows():
    calib = costmodel.calibrate(toy_report())
    with pytest.raises(ValueError):
        costmodel.predict(calib, {}, "ICI(v5e)")
    with pytest.raises(ValueError):
        jax_costmodel.predict(jax_costmodel.calibrate(toy_report()), {}, "NVLink4(H100)")
    p = costmodel.predict(calib, {}, "NVLink4(H100)")
    assert p["latency_s"] == 0.0 and p["wire_s"] == pytest.approx(8 * MIB / 450e9)


@pytest.mark.parametrize("name", ["toy", "four_workers", "compressed"])
def test_slices_match(name, same_inner_rate):
    calib = costmodel.calibrate(REPORTS[name])
    jcalib = jax_costmodel.calibrate(REPORTS[name])
    assert dataclasses.asdict(costmodel.slice_calibration(calib, 8)) == dataclasses.asdict(
        jax_costmodel.slice_calibration(jcalib, 8))
    for kw in ({}, {"steps": 100}, {"steps": 100, "deadline_s": 5.0}, {"steps": 100, "deadline_s": 0.5}):
        for fabric in GBE:
            assert costmodel.price_slice(calib, 4, fabric, **kw) == jax_costmodel.price_slice(jcalib, 4, fabric, **kw)
            assert costmodel.search_slices(calib, [1, 2, 4, 8, 8, 0], fabric, **kw) == jax_costmodel.search_slices(
                jcalib, [1, 2, 4, 8, 8, 0], fabric, **kw)


def test_ladder_configs_match():
    assert costmodel.ladder_configs() == jax_costmodel.ladder_configs()
    assert [c["name"] for c in costmodel.ladder_configs()] == [r.name for r in DEFAULT_LADDER]


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_plan_events_and_join_match(name, same_inner_rate):
    calib = costmodel.calibrate(REPORTS[name])
    jcalib = jax_costmodel.calibrate(REPORTS[name])
    plan = costmodel.build_plan(calib, fabrics=GBE, configs=search_space(calib))
    jplan = jax_costmodel.build_plan(jcalib, fabrics=GBE, configs=search_space(calib))
    assert plan == jplan
    assert plan["schema"] == costmodel.PLAN_SCHEMA and plan["fabric_matrix"] is None
    got = [e.record() for e in costmodel.prediction_events(plan, rank=0)]
    assert all(isinstance(e, PredictionEvent) for e in costmodel.prediction_events(plan))
    assert got == [e.record() for e in jax_costmodel.prediction_events(jplan, rank=0)]
    # the realized join, on a run of the compress rung 10 % slower than predicted
    pred = next(p for p in plan["fabrics"]["1GbE"]["ranked"] if p["config"]["name"] == "compress-low-rank")
    run = toy_report(step_p50_s=pred["predicted_step_s"] * 1.1,
                     compile={"comm_config": {"reducer": "powersgd", "reducer_rank": 1}})
    for fabric, report, executed in (("1GbE", run, None), ("10GbE", run, {"comm_chunks": 4}), ("100GbE", run, None),
                                     ("1GbE", {"step_p50_s": None}, None), ("NVLink4(H100)", run, None)):
        assert costmodel.join_realized(plan, fabric, report, executed) == jax_costmodel.join_realized(
            jplan, fabric, report, executed)
    joined = costmodel.join_realized(plan, "1GbE", run)
    assert joined["matched"] and joined["error"] == pytest.approx(0.1 / 1.1)


def test_search_default_fabrics_are_the_port_rows():
    calib = costmodel.calibrate(toy_report())
    ranked = costmodel.search(calib)
    assert list(ranked) == ["1GbE", "10GbE", "100GbE", "NVLink4(H100)"]
    # the fabric flip the planner exists for: compression wins on 1 GbE,
    # the dense baseline on NVLink
    two = [{"name": "baseline"}, {"name": "compress", "reducer": "powersgd", "reducer_rank": 1}]
    ranked = costmodel.search(calib, fabrics=["1GbE", "NVLink4(H100)"], configs=two)
    assert ranked["1GbE"][0]["config"]["name"] == "compress"
    assert ranked["NVLink4(H100)"][0]["config"]["name"] == "baseline"


def test_planners_write_the_same_plan(tmp_path):
    """``scripts/plan.py`` and ``scripts/torch_plan.py`` on one report, on
    the GbE rows (the default search space, the hierarchical grid too)."""
    report = str(tmp_path / "report.json")
    with open(report, "w") as f:
        json.dump(toy_report(), f)
    plan_py, torch_plan = load_script("plan"), load_script("torch_plan")
    for extra in ([], ["--hierarchical", "--sites", "2"]):
        docs = []
        for tag, mod in (("jax", plan_py), ("port", torch_plan)):
            out, events = str(tmp_path / f"{tag}_plan.json"), str(tmp_path / f"{tag}_pred.jsonl")
            argv = ["--report", report, "--out", out, "--events-out", events, "--fabrics", ",".join(GBE),
                    "--source-fabric", "10GbE", *extra]
            assert mod.main(argv) == 0
            with open(out) as f, open(events) as g:
                docs.append((json.load(f), g.read()))
        assert docs[0] == docs[1]


def test_launch_applies_the_port_plan(tmp_path):
    """The launcher's ``--plan`` applies a plan of ``torch_plan.py`` for its
    fabric (the NVLink row by default) and the ladder takes its order."""
    calib = costmodel.calibrate(toy_report())
    configs = [costmodel.canonical_config(c) for c in (
        {"name": "baseline"}, {"name": "chunked-8", "comm_chunks": 8, "comm_strategy": "ring"})]
    plan = costmodel.build_plan(calib, configs=configs)
    assert plan["fabrics"]["NVLink4(H100)"]["best"]["config"]["name"] == "chunked-8"
    path = str(tmp_path / "plan.json")
    with open(path, "w") as f:
        json.dump(plan, f)
    args = launch.build_parser().parse_args(["exact_cifar10", "--plan", path])
    cfg = launch.config_from_args(args)
    launch.apply_plan(cfg, args)
    assert (cfg.comm_chunks, cfg.comm_strategy, cfg.plan_path) == (8, "ring", path)
    assert [r.name for r in ladder_from_plan(plan, "NVLink4(H100)")] == [r.name for r in DEFAULT_LADDER]


# ---- the planner replay ----------------------------------------------------------

REPLAY_STEPS, REPLAY_STEP_S = 10, 0.03
TOY_RUNGS = {"baseline": "baseline", "compress-low-rank": "compress", "localsgd": "localsgd"}


def _toy_run(root, tag, extra):
    run_dir = os.path.join(root, tag)
    os.makedirs(run_dir)

    def argv(rank, world, incarnation):
        return [
            sys.executable, TOY, "--rank", str(rank), "--world", str(world), "--steps", str(REPLAY_STEPS),
            "--state-dir", os.path.join(run_dir, "state"), "--result-dir", os.path.join(run_dir, "results"),
            "--step-seconds", str(REPLAY_STEP_S), "--payload-mult", "8", *extra,
        ]

    tel = telemetry_for_run(event_log=os.path.join(run_dir, runlog.SUPERVISOR_LOG), stdout=False)
    try:
        result = Supervisor(argv, 2, SupervisorConfig(max_restarts=0, backoff_base_s=0.05, poll_interval_s=0.05,
                                                      deadline_s=120.0), telemetry=tel, run_dir=run_dir).run()
    finally:
        tel.close()
    assert result.success, result
    return run_dir


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    """The default run, its report, the plan, the picked rung's run and its
    report joined with the plan."""
    root = str(tmp_path_factory.mktemp("replay"))
    report, torch_plan = load_script("torch_report"), load_script("torch_plan")
    default = _toy_run(root, "default", ["--sim-fabric", "1GbE"])
    default_json = os.path.join(root, "default_report.json")
    assert report.main(["--run-dir", default, "--json-out", default_json]) == 0
    plan_path, pred_path = os.path.join(root, "plan.json"), os.path.join(root, "pred.jsonl")
    assert torch_plan.main(["--report", default_json, "--out", plan_path, "--events-out", pred_path]) == 0
    with open(plan_path) as f:
        plan = json.load(f)
    pick = next(n for n in plan["ladder"]["1GbE"] if n in TOY_RUNGS)
    picked = _toy_run(root, "picked", ["--sim-fabric", "1GbE", "--rung", TOY_RUNGS[pick]])
    picked_json = os.path.join(root, "picked_report.json")
    assert report.main(["--run-dir", picked, "--json-out", picked_json, "--plan", plan_path,
                        "--plan-fabric", "1GbE"]) == 0
    with open(default_json) as f, open(picked_json) as g:
        return json.load(f), plan, pick, json.load(g), pred_path


def test_replay_matches_its_prediction(replay):
    default, plan, pick, picked, pred_path = replay
    assert plan["schema"] == 1 and list(plan["fabrics"]) == ["1GbE", "10GbE", "100GbE", "NVLink4(H100)"]
    assert pick != "baseline"  # compression (or a wider sync) wins on a slow fabric
    cm = picked["costmodel"]
    assert cm["matched"] is True and cm["fabric"] == "1GbE"
    assert cm["config_key"] == costmodel.config_key(dict(DEFAULT_LADDER[[r.name for r in DEFAULT_LADDER].index(pick)]
                                                         .overrides))
    assert cm["beats_default"] is True and picked["step_p50_s"] < default["step_p50_s"]
    assert cm["predicted_step_s"] > 0 and cm["error"] >= 0
    with open(pred_path) as f:
        preds = [json.loads(line) for line in f]
    assert preds and all(p["event"] == "prediction" and p["predicted_step_s"] > 0 for p in preds)
    print(f"\nplanner replay on a simulated 1GbE: default {default['step_p50_s'] * 1e3:.2f} ms, {pick}"
          f" predicted {cm['predicted_step_s'] * 1e3:.2f} ms, realized {cm['realized_step_s'] * 1e3:.2f} ms,"
          f" error {cm['error']:.3f}")


def test_replay_report_calibrates_like_the_jax_report(replay):
    default = replay[0]
    jax_report = load_script("report", tag="jaxcostmodel")
    _, ref = jax_report.run_report(default["run_dir"])
    for source in (None, "1GbE"):
        got = costmodel.calibrate(default, source_fabric=source)
        want = jax_costmodel.calibrate(ref, source_fabric=source)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
