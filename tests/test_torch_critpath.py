"""The cross-rank critical path (``observe/critpath.py``), the measured
fabric matrix (``observe/fabric.py``) and the run report of
``scripts/torch_report.py`` against the JAX package's.

The same inputs go through both packages and the returned dicts must be
equal: the JAX package's own synthetic spans and ledgers
(``tests/test_critpath.py``), and a port run directory from the game day
below, on which the JAX package's ``scripts/report.py::run_report`` and the
port's ``run_report`` must agree key by key for every key the port keeps.
The pinned difference: the fabric rows (``NVLink4(H100)`` against
``ICI(v5e)``), so the per-fabric utilisations and modeled times are held
on the GbE rows.

The game day: the port's ``Supervisor`` runs two ranks of the toy worker
on a simulated 10GbE (``--sim-fabric``) with a chaos ``comm_slow_edge`` on
rank 1's outgoing edge (1 -> 0) from step 2. The critical path's top
edge, the straggler's blamed edge and the matrix's bottleneck must all be
1 -> 0, and the matrix, read back through ``utils.bandwidth.fabric_model``,
gates the ring on that edge. The port's real loop has no ``step/comm``
span (its collectives run inside ``step/compute``): a run of it reads a
comm share of 0 (``test_real_loop_spans_blame_compute``).
"""

import importlib.util
import json
import os
import sys

import pytest

from network_distributed_pytorch_tpu.observe import critpath as jax_critpath
from network_distributed_pytorch_tpu.observe import fabric as jax_fabric
from network_distributed_pytorch_tpu_torch.observe import critpath, fabric, telemetry_for_run
from network_distributed_pytorch_tpu_torch.observe import runlog
from network_distributed_pytorch_tpu_torch.observe.events import CritPathEvent
from network_distributed_pytorch_tpu_torch.resilience import ChaosPlan, FaultSpec, Supervisor, SupervisorConfig
from network_distributed_pytorch_tpu_torch.utils import bandwidth
from torch_report_parity import REPORT_KEYS, assert_key_equal, assert_text_equal

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)
TOY = os.path.join(TESTS_DIR, "torch_toy_supervised_worker.py")
MIB = 1 << 20
GBE = ("1GbE", "10GbE", "100GbE")


def load_script(name, tag="critpath"):
    spec = importlib.util.spec_from_file_location(f"_{tag}_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[f"_{tag}_{name}"] = mod
    spec.loader.exec_module(mod)
    return mod


# ---- the JAX package's synthetic evidence ---------------------------------------


def _span(step, rank, name, dur, span_id=None, parent_id=None):
    return {
        "event": "span", "name": name, "dur_s": dur, "step": step, "rank": rank,
        "span_id": span_id or f"s{step}r{rank}{name}", "parent_id": parent_id,
    }


def _rank_step(step, rank, data=0.0, compute=0.01, comm=0.0):
    """One rank-step's leaf spans under a container (the toy's layout)."""
    container = f"c{step}r{rank}"
    spans = [
        {"event": "span", "name": "step", "dur_s": data + compute + comm, "step": step, "rank": rank,
         "span_id": container, "parent_id": None},
        _span(step, rank, "step/compute", compute, parent_id=container),
    ]
    if data > 0:
        spans.append(_span(step, rank, "data_load", data, parent_id=container))
    if comm > 0:
        spans.append(_span(step, rank, "step/comm", comm, parent_id=container))
    return spans


def _collective(rank, payload=MIB):
    return {
        "event": "collective", "label": "toy", "tag": "toy.grads", "layer": "reducer", "op": "all-reduce",
        "axis": "data", "dtype": "float32", "payload_bytes": payload, "rank": rank,
    }


def throttled(world=2, steps=4, slow_rank=1):
    events = []
    for step in range(steps):
        for r in range(world):
            slow = r == slow_rank and step >= 1
            events += _rank_step(step, r, compute=0.010, comm=0.050 if slow else 0.002)
    return events


def real_loop(steps=3):
    """The port's real loop's layout: data_load beside the step, whose
    collectives run inside step/compute."""
    events = []
    for step in range(steps):
        events.append(_span(step, 0, "data_load", 0.003))
        c = f"c{step}"
        events.append({"event": "span", "name": "step", "dur_s": 0.05, "step": step, "rank": 0, "span_id": c,
                       "parent_id": None})
        events.append(_span(step, 0, "step/compute", 0.045, parent_id=c))
        events.append(_span(step, 0, "step/loss_sync", 0.005, parent_id=c))
    return events


EVENT_CASES = {
    "throttled": (throttled(), 2),
    "three_ranks": (throttled(world=3, steps=5, slow_rank=2), 3),
    "data_stall": ([e for s in range(3) for r in range(2)
                    for e in _rank_step(s, r, data=0.04 if r == 0 else 0.001)], 2),
    "uniform": ([e for s in range(3) for r in range(2) for e in _rank_step(s, r, comm=0.002)], 2),
    "real_loop": (real_loop(), 1),
    "spanless": ([{"event": "span", "name": "step/compute", "dur_s": 0.01}], 2),
    "empty": ([], 2),
}


@pytest.mark.parametrize("name", sorted(EVENT_CASES))
def test_analyze_and_waits_match(name):
    events, world = EVENT_CASES[name]
    assert critpath.analyze(events, world) == jax_critpath.analyze(events, world)
    assert critpath.comm_waits_by_edge(events, world) == jax_critpath.comm_waits_by_edge(events, world)


@pytest.mark.parametrize("span_name", ["data_load", "step/comm", "step/compute", "checkpoint/save", "step/loss_sync",
                                       "data_load/stage", "comm/agree", ""])
def test_phase_of_matches(span_name):
    assert critpath.phase_of(span_name) == jax_critpath.phase_of(span_name)
    assert (critpath.PHASES, critpath.PHASE_DATA, critpath.PHASE_COMPUTE, critpath.PHASE_COMM) == (
        jax_critpath.PHASES, jax_critpath.PHASE_DATA, jax_critpath.PHASE_COMPUTE, jax_critpath.PHASE_COMM)


BLAME_CASES = [
    {0: {"data_load": 0.0, "compute": 0.040, "collective-wait": 0.002},
     1: {"data_load": 0.0, "compute": 0.040, "collective-wait": 0.002},
     2: {"data_load": 0.0, "compute": 0.041, "collective-wait": 0.020}},
    {0: {"data_load": 0.0, "compute": 0.040, "collective-wait": 0.002},
     1: {"data_load": 0.0, "compute": 0.040, "collective-wait": 0.002}},
    {0: {"data_load": 0.02, "compute": 0.010, "collective-wait": 0.0}},
    {},
]


@pytest.mark.parametrize("i", range(len(BLAME_CASES)))
def test_step_blame_matches(i):
    per_rank = BLAME_CASES[i]
    world = max(len(per_rank), 1)
    got = critpath.step_blame(per_rank, world, step=7)
    want = jax_critpath.step_blame(per_rank, world, step=7)
    assert (got is None) == (want is None)
    if got is not None:
        assert isinstance(got, CritPathEvent) and got.record() == want.record()


def test_real_loop_spans_blame_compute():
    """The real loop's spans: a comm share of 0, the blame on compute."""
    crit = critpath.analyze(real_loop(), 1)
    assert crit["comm_share"] == 0.0 and crit["blame_by_rank"] == {"0": 1.0}
    assert crit["blame_by_phase"]["compute"] == 1.0 and crit["top_edge"] is None


MATRIX_CASES = {
    "two_ranks": ([_collective(0), _collective(1)] + [e for s in range(5) for r, c in ((0, 0.01), (1, 0.1))
                                                     for e in _rank_step(s, r, comm=c)], 2),
    "three_ranks": ([_collective(0, 4 * MIB)] + throttled(world=3, steps=5, slow_rank=2), 3),
    "no_ledger": (throttled(), 2),
    "no_spans": ([_collective(0)], 2),
    "one_rank": ([_collective(0)] + _rank_step(0, 0, comm=0.01), 1),
}


@pytest.mark.parametrize("name", sorted(MATRIX_CASES))
def test_measure_fabric_matrix_matches(name, tmp_path):
    events, world = MATRIX_CASES[name]
    got = fabric.measure_fabric_matrix(events, world)
    assert got == jax_fabric.measure_fabric_matrix(events, world)
    assert (fabric.MATRIX_SCHEMA, fabric.MATRIX_NAME) == (jax_fabric.MATRIX_SCHEMA, jax_fabric.MATRIX_NAME)
    # the utilisation table: equal on the GbE rows; the in-node row is the
    # port's NVLink4(H100) where the JAX package has ICI(v5e)
    got_u, want_u = fabric.edge_utilization(got), jax_fabric.edge_utilization(got)
    assert len(got_u) == len(want_u)
    for g, w in zip(got_u, want_u):
        assert {k: v for k, v in g.items() if k != "utilization"} == {k: v for k, v in w.items() if k != "utilization"}
        assert {f: g["utilization"][f] for f in GBE} == {f: w["utilization"][f] for f in GBE}
        assert set(g["utilization"]) - set(GBE) == {"NVLink4(H100)"}
        assert set(w["utilization"]) - set(GBE) == {"ICI(v5e)"}
    if got is not None:
        path = str(tmp_path / fabric.MATRIX_NAME)
        fabric.save_matrix(got, path)
        assert fabric.load_matrix(path) == jax_fabric.load_matrix(path) == json.loads(json.dumps(got))


def test_load_matrix_refuses_what_the_jax_package_refuses(tmp_path):
    for name, text in (("bad.json", "{not json"), ("empty.json", '{"edges": []}'), ("list.json", "[1]")):
        (tmp_path / name).write_text(text)
        assert fabric.load_matrix(str(tmp_path / name)) is jax_fabric.load_matrix(str(tmp_path / name)) is None
    assert fabric.load_matrix(str(tmp_path / "absent.json")) is None


def test_matrix_feeds_the_fabric_model():
    """The loop from measurement to pricing: a measured
    matrix read back gates the ring on its slowest edge."""
    events, world = MATRIX_CASES["three_ranks"]
    matrix = fabric.measure_fabric_matrix(events, world)
    model = bandwidth.fabric_model(matrix)
    bn = model.bottleneck()
    assert model.per_edge and (bn.src, bn.dst) == (2, 0) == tuple(matrix["bottleneck"].values())
    assert model.ring_beta("100GbE") == min(e["bytes_per_s"] for e in matrix["edges"])


def test_render_sections_match():
    report, jax_report = load_script("torch_report"), load_script("report", tag="jaxcritpath")
    events, world = MATRIX_CASES["two_ranks"]
    crit = critpath.analyze(events, world)
    matrix = fabric.measure_fabric_matrix(events, world)
    got = report.render_critpath_section(crit, matrix, clock_skew_bound_s=0.002)
    want = jax_report.render_critpath_section(crit, matrix, clock_skew_bound_s=0.002)
    # the table's lines name the fabric rows (the pinned difference)
    assert [line for line in got if " util " not in line] == [line for line in want if " util " not in line]
    assert "  top gating edge 1 -> 0 (gated 5 step(s) in collective-wait)" in got
    assert report.render_critpath_section(None, None) == [] == jax_report.render_critpath_section(None, None)
    recs = [{"label": "toy", "mfu": 0.2, "peak_flops_per_s": 1e12, "flops_per_step": 2e9, "flops_source": "analytic",
             "step_time_s": 0.01, "bound": "comm-exposed", "exposed_comm_fraction": 1.0}]
    for r in (recs, []):
        assert report.render_mfu_section(r)[:3] == jax_report.render_mfu_section(r)[:3]
    assert report.render_mfu_section(recs) == jax_report.render_mfu_section(recs)
    assert report.span_summary(events) == jax_report.span_summary(events)
    assert report.span_summary([]) is jax_report.span_summary([]) is None


# ---- the game day -------------------------------------------------------------------

STEPS, STEP_S = 12, 0.02
SLOW = {"edge": [1, 0], "bytes_per_s": 2e7, "duration_steps": 999, "max_sleep_s": 0.25}


@pytest.fixture(scope="module")
def slow_edge_run(tmp_path_factory):
    """Two toy ranks on a simulated 10GbE, rank 1's edge to rank 0
    throttled from step 2: the run directory and both reports."""
    run_dir = str(tmp_path_factory.mktemp("slow_edge") / "run")
    os.makedirs(run_dir)
    plan = os.path.join(run_dir, "chaos.json")
    ChaosPlan([FaultSpec(kind="comm_slow_edge", step=2, rank=1, payload=SLOW)]).save(plan)

    def argv(rank, world, incarnation):
        return [
            sys.executable, TOY, "--rank", str(rank), "--world", str(world), "--steps", str(STEPS),
            "--state-dir", os.path.join(run_dir, "state"), "--result-dir", os.path.join(run_dir, "results"),
            "--step-seconds", str(STEP_S), "--sim-fabric", "10GbE", "--chaos-plan", plan,
        ]

    tel = telemetry_for_run(event_log=os.path.join(run_dir, runlog.SUPERVISOR_LOG), stdout=False)
    try:
        result = Supervisor(argv, 2, SupervisorConfig(max_restarts=0, backoff_base_s=0.05, poll_interval_s=0.05,
                                                      deadline_s=120.0), telemetry=tel, run_dir=run_dir).run()
    finally:
        tel.close()
    assert result.success, result
    report = load_script("torch_report")
    jax_report = load_script("report", tag="jaxcritpath")
    _, port = report.run_report(run_dir)
    _, ref = jax_report.run_report(run_dir)
    return run_dir, port, ref


def test_game_day_names_the_slow_edge(slow_edge_run):
    _, report, _ = slow_edge_run
    crit = report["critpath"]
    assert crit["n_steps"] == STEPS and crit["world_size"] == 2
    assert (crit["top_edge"]["src"], crit["top_edge"]["dst"]) == (1, 0)
    late = [e for e in crit["events"] if e["step"] >= 2]
    assert all((e["rank"], e["phase"], e["edge_src"], e["edge_dst"]) == (1, "collective-wait", 1, 0) for e in late)
    assert crit["comm_share"] > 0.5 and crit["blame_by_rank"]["1"] > 0.5
    matrix = report["fabric_matrix"]
    assert matrix["bottleneck"] == {"src": 1, "dst": 0}
    bn = bandwidth.fabric_model(matrix).bottleneck()
    assert (bn.src, bn.dst) == (1, 0)
    (straggler,) = report["stragglers"]
    assert straggler["rank"] == 1 and straggler["blamed_phase"] == "collective-wait"
    assert straggler["blamed_edge"] == {"src": 1, "dst": 0}
    # the toy's compile record joins into an MFU against its made-up peak
    (m,) = report["mfu"]
    assert m["flops_source"] == "analytic" and 0 < m["mfu"] < 1 and m["bound"] == "comm-exposed"


KEYS = ("step_p50_s", "step_p95_s", "world_size", "run_dir", "ranks", "compile", "mfu", "critpath", "fabric_matrix",
        "stragglers", "n_events", "clock_skew_bound_s", "schema")


@pytest.mark.parametrize("key", KEYS)
def test_report_matches_the_jax_report(slow_edge_run, key):
    _, port, ref = slow_edge_run
    assert port[key] == ref[key]


def test_report_spans_and_bandwidth_match(slow_edge_run):
    _, port, ref = slow_edge_run
    assert port["spans"]["by_name"] == ref["spans"]["by_name"]
    assert port["spans"] == ref["spans"]
    pb, rb = port["bandwidth"], ref["bandwidth"]
    assert pb["attribution"] == rb["attribution"]

    def gbe(view):
        return {k: ({f: v[f] for f in GBE} if k in ("utilization", "modeled_comm_s") else v) for k, v in view.items()}

    assert gbe(pb["total"]) == gbe(rb["total"])
    assert [gbe(r) for r in pb["by_tag"]] == [gbe(r) for r in rb["by_tag"]]
    assert set(pb["total"]["utilization"]) - set(GBE) == {"NVLink4(H100)"}


def test_report_cli_writes_the_matrix(slow_edge_run, tmp_path):
    run_dir, port, _ = slow_edge_run
    out = str(tmp_path / "out" / "report.json")
    assert load_script("torch_report").main(["--run-dir", run_dir, "--json-out", out]) == 0
    with open(out) as f:
        doc = json.load(f)
    assert doc["critpath"] == port["critpath"]
    matrix = fabric.load_matrix(str(tmp_path / "out" / fabric.MATRIX_NAME))
    assert matrix == json.loads(json.dumps(port["fabric_matrix"]))


def test_whole_report_and_text_match_the_jax_report(slow_edge_run):
    """Every key of the JAX report and its text, line by line, on the game
    day's run directory (the fabric rows pinned), its trace and the
    comparison of the run with itself."""
    run_dir, _, _ = slow_edge_run
    report, jax_report = load_script("torch_report"), load_script("report", tag="jaxcritpath")
    (text, port), (jtext, ref) = report.run_report(run_dir), jax_report.run_report(run_dir)
    for key in REPORT_KEYS:
        assert_key_equal(port, ref, key)
    assert assert_text_equal(text, jtext) > 0
    merged = runlog.merge_run(run_dir)
    assert report.chrome_trace(merged.events) == jax_report.chrome_trace(merged.events)
    assert report.compare_runs(run_dir, run_dir) == jax_report.compare_runs(run_dir, run_dir)
