"""The port's fleet control plane (``resilience/scheduler.py``, ``launch
fleet`` and the worker's choice of card) against the JAX package's
``resilience.scheduler`` on the same inputs.

- Manifests: the wire documents are equal from both packages and load
  across; the argv tokens substitute alike; a malformed submission raises
  the same exception type.
- The job spool: a malformed document's quarantine, the park bookkeeping
  and ``recover`` leave the same documents in both packages' spools.
- Admission: ``_viable_worlds`` over a grid of mesh axes and caps, and
  ``_grantable`` under reservations.
- Pricing: on one calibration both schedulers pick the same world on the
  rows both tables hold. The pinned difference: the port's default fabric
  is its in-node row, ``"NVLink4(H100)"``, which prices; the JAX
  package's, ``"tpu_ici"``, is in neither table and falls back.
- Leases: the JAX package's lease sequence (its ``tests/
  test_paged_serving.py``), equal grants and event records.
- ``launch.main(["fleet", ...])`` returns ``{"fleet_rc": 0}``; the worker's
  card (``launch.worker_cuda_device``): ``LOCAL_RANK`` wins, then the
  fleet's grant (the job's whole list by process id, or a lease of one),
  then the process id; a card the machine lacks raises.
- End to end, with subprocess workers: the JAX package's two-job fleet
  under both schedulers (summaries equal but for times), and a small
  SLO-preemption game day on the port's toy workers, run once by a
  module-scoped fixture: the training job preempted for the serving pool,
  parked, resumed and ending bit for bit where an uninterrupted run ends,
  the crash-looper quarantined, every request done once, and the port's
  fleet report section equal to the JAX package's ``scripts/report.py``
  on the fleet's log.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest

import network_distributed_pytorch_tpu.resilience.scheduler as jsched
from network_distributed_pytorch_tpu.observe import costmodel as jax_costmodel
from network_distributed_pytorch_tpu.observe.health import DetectorConfig as JaxDetectorConfig
from network_distributed_pytorch_tpu.resilience.supervisor import plan_mesh as jax_plan_mesh
from network_distributed_pytorch_tpu_torch import launch
from network_distributed_pytorch_tpu_torch.observe import costmodel, runlog
from network_distributed_pytorch_tpu_torch.observe.health import DetectorConfig
from network_distributed_pytorch_tpu_torch.resilience import (
    FleetConfig,
    FleetScheduler,
    JobManifest,
    JobSpool,
    plan_mesh,
)
from network_distributed_pytorch_tpu_torch.resilience import scheduler as sched_mod
from network_distributed_pytorch_tpu_torch.serving import FileSpool, WorkloadConfig, poisson_workload
from torch_report_parity import REPORT_KEYS, assert_key_equal, assert_text_equal

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)
TOY = os.path.join(TESTS_DIR, "torch_toy_supervised_worker.py")
TOY_SERVE = os.path.join(TESTS_DIR, "torch_toy_serving_worker.py")
MIB = 1 << 20


def load_script(name, tag="scheduler"):
    spec = importlib.util.spec_from_file_location(f"_{tag}_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[f"_{tag}_{name}"] = mod
    spec.loader.exec_module(mod)
    return mod


class Capture:
    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)

    def close(self):
        pass

    def records(self, kind=None):
        return [e.record() for e in self.events if kind is None or e.KIND == kind]


def spool_docs(root):
    """Every JSON document under ``root``, by path relative to it."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".json"):
                with open(os.path.join(dirpath, f)) as fh:
                    out[os.path.relpath(os.path.join(dirpath, f), root)] = json.load(fh)
    return out


def manifest_kwargs():
    return dict(
        job_id="svc",
        argv=["python", "-u", "w.py", "--rank", "{rank}", "--world", "{world}", "--dev", "{device_rank}",
              "--gen", "{incarnation}"],
        kind="serve", priority=5, deadline_s=30.0, min_world=2, max_world=4, steps=10.0,
        mesh_axes={"data": 2, "fsdp": 1, "tensor": 2}, env={"A": "1"}, preemptions=1, strikes=1, chip_seconds=2.5,
    )


# ---- manifests ---------------------------------------------------------------------


def test_manifest_wire_loads_across_and_argv_tokens_match():
    job, jjob = JobManifest(**manifest_kwargs()), jsched.JobManifest(**manifest_kwargs())
    assert job.to_wire() == jjob.to_wire()
    assert sched_mod.JOB_SCHEMA == jsched.JOB_SCHEMA and sched_mod._ARGV_TOKENS == jsched._ARGV_TOKENS
    assert (sched_mod.TRAIN, sched_mod.SERVE) == (jsched.TRAIN, jsched.SERVE)
    # each package loads the other's wire document, bookkeeping included
    wire = json.loads(json.dumps(jjob.to_wire()))
    assert JobManifest.from_wire(wire) == job
    assert jsched.JobManifest.from_wire(json.loads(json.dumps(job.to_wire()))) == jjob
    for args in ((1, 2, 3, 7), (0, 4, 0, 2)):
        assert job.worker_argv(*args) == jjob.worker_argv(*args)
    assert job.worker_argv(1, 2, 3, 7)[3:] == ["--rank", "1", "--world", "2", "--dev", "7", "--gen", "3"]


@pytest.mark.parametrize("bad", [
    {"job_id": "x", "argv": ["p"], "kind": "batch"},
    {"job_id": "x", "argv": ["p"], "min_world": 3, "max_world": 2},
    {"job_id": "x", "argv": ["p"], "min_world": 0},
    {"job_id": "x", "argv": []},
    {"job_id": "x", "argv": ["p"], "gpu_hours": 3},
    {"argv": ["p"]},
])
def test_malformed_manifest_raises_the_same_type(bad):
    with pytest.raises(Exception) as got:
        JobManifest.from_wire(dict(bad))
    with pytest.raises(Exception) as want:
        jsched.JobManifest.from_wire(dict(bad))
    assert got.type is want.type and got.type in (TypeError, ValueError)


# ---- the job spool -----------------------------------------------------------------


def _spool_scenario(pkg, root):
    """Submit, a malformed document, claims, a park with bookkeeping, a
    completion and a quarantine; the claimed ids."""
    spool = pkg.JobSpool(root)
    assert spool.submit([pkg.JobManifest(job_id="good", argv=["x"], preemption_budget=2),
                         pkg.JobManifest(job_id="later", argv=["y"], priority=3)]) == 2
    # a bad submission lands on the queue and sorts before "good"
    with open(os.path.join(spool._spool.queue_dir, "bad.json"), "w") as f:
        json.dump({"job_id": "bad", "argv": ["x"], "kind": "gpu-hours"}, f)
    claimed = []
    job = spool.claim()
    claimed.append(job.job_id)
    job.preemptions += 1
    job.strikes = 1
    job.chip_seconds = 12.5
    job.work_done = 3.0
    job.last_rc = 75
    spool.park(job)
    # re-submitting a parked id is a no-op
    assert spool.submit([pkg.JobManifest(job_id="good", argv=["x"])]) == 0
    again = spool.claim()
    claimed.append(again.job_id)
    bookkeeping = (again.preemptions, again.strikes, again.chip_seconds, again.work_done, again.last_rc)
    spool.complete(again, met_deadline=True)
    later = spool.claim()
    claimed.append(later.job_id)
    later.strikes = 3
    spool.quarantine(later, "strike 3/3")
    return {
        "claimed": claimed, "bookkeeping": bookkeeping, "queued": spool.queued(),
        "quarantined": spool.quarantined_ids(), "docs": spool_docs(root),
    }


def test_spool_quarantine_and_park_leave_the_same_documents(tmp_path):
    got = _spool_scenario(sched_mod, str(tmp_path / "port"))
    want = _spool_scenario(jsched, str(tmp_path / "jax"))
    assert got == want
    assert got["claimed"] == ["good", "good", "later"] and got["queued"] == 0
    assert got["bookkeeping"] == (1, 1, 12.5, 3.0, 75)
    assert got["quarantined"] == ["bad", "later"]
    assert "malformed manifest" in got["docs"][os.path.join("quarantine", "bad.json")]["quarantine_reason"]


def _recover_scenario(pkg, root):
    """A claim left by a dead scheduler; a replacement opens the spool and
    recovers; then the same under another incarnation of the claimant.
    What each claims, and the documents."""
    spool = pkg.JobSpool(root)
    spool.submit([pkg.JobManifest(job_id="a", argv=["x"], strikes=1), pkg.JobManifest(job_id="b", argv=["y"])])
    spool.claim()  # claimed, then the scheduler dies
    replacement = pkg.JobSpool(root)
    out = [replacement.recover()]
    job = replacement.claim()
    out.append(job.job_id)
    replacement.complete(job)
    out.append(replacement.claim())
    # the claim dir is the replacement's own (rank 0, incarnation 0); only a
    # later incarnation counts it dead, and re-queues it with the spool's
    # "requeues" count, which JobManifest.from_wire refuses
    later = pkg.JobSpool(root)
    later._spool = type(later._spool)(root, rank=0, incarnation=1)
    out += [later.recover(), later.claim(), later.quarantined_ids()]
    return out, spool_docs(root)


def test_recover_leaves_the_same_documents(tmp_path):
    """Both packages alike: a scheduler opening a dead one's spool claims as
    the same identity, so ``recover`` moves nothing and the dead claim
    stays; at a later incarnation the claim is re-queued and then
    quarantined as malformed (ROADMAP.md §C)."""
    got, docs = _recover_scenario(sched_mod, str(tmp_path / "port"))
    want, jdocs = _recover_scenario(jsched, str(tmp_path / "jax"))
    assert got == want == [0, "b", None, 1, None, ["a"]]
    assert docs == jdocs
    assert "requeues" in docs[os.path.join("quarantine", "a.json")]["quarantine_reason"]


# ---- admission ---------------------------------------------------------------------

MESHES = [None, {"data": 2, "fsdp": 2, "tensor": 2}, {"data": 1, "fsdp": 1, "tensor": 4}, {"data": 3, "tensor": 2}]


@pytest.mark.parametrize("axes", MESHES, ids=["dp", "2x2x2", "tp4", "3x2"])
def test_viable_worlds_match(tmp_path, axes):
    sched = FleetScheduler(JobSpool(str(tmp_path / "p")), FleetConfig(n_devices=8))
    jsch = jsched.FleetScheduler(jsched.JobSpool(str(tmp_path / "j")), jsched.FleetConfig(n_devices=8))
    for min_world in (1, 2, 3):
        for cap in range(min_world, 9):
            kw = dict(job_id="m", argv=["x"], min_world=min_world, max_world=8, mesh_axes=axes)
            worlds = sched._viable_worlds(JobManifest(**kw), cap)
            assert worlds == jsch._viable_worlds(jsched.JobManifest(**kw), cap)
            for w in worlds if axes else ():
                mesh = plan_mesh(axes, w, min_world)
                assert mesh == jax_plan_mesh(axes, w, min_world)
                assert mesh["data"] * mesh["fsdp"] * mesh["tensor"] == w


def test_grantable_under_reservations_matches(tmp_path):
    sched = FleetScheduler(JobSpool(str(tmp_path / "p")), FleetConfig(n_devices=8))
    jsch = jsched.FleetScheduler(jsched.JobSpool(str(tmp_path / "j")), jsched.FleetConfig(n_devices=8))
    for s in (sched, jsch):
        s._reserved.update({"svc": [0, 1], "pool": [5]})
        s._free = [0, 1, 2, 3, 5, 6]
    for job_id in ("dp", "svc", "pool"):
        got = sched._grantable(JobManifest(job_id=job_id, argv=["x"]))
        assert got == jsch._grantable(jsched.JobManifest(job_id=job_id, argv=["x"]))
    assert sched._grantable(JobManifest(job_id="dp", argv=["x"])) == [2, 3, 6]
    assert sched._grantable(JobManifest(job_id="svc", argv=["x"])) == [0, 1, 2, 3, 6]


# ---- pricing -----------------------------------------------------------------------


def toy_report():
    """The JAX package's synthetic report (``tests/test_costmodel.py``)."""
    return {
        "run_dir": "synthetic", "step_p50_s": 0.08, "world_size": 2,
        "bandwidth": {"total": {"payload_bytes": 8 * MIB, "count": 1},
                      "attribution": {"exposed_fraction": 1.0, "n_collectives": 1}},
        "compile": {"analytic_bytes": 8 * MIB, "comm_config": {"reducer": "exactreducer"}},
        "mfu": [{"flops_per_step": 2.0e9, "peak_flops_per_s": 1.0e12}],
        "spans": {"by_name": {"step/compute": {"mean_s": 0.01}}},
    }


@pytest.mark.parametrize("fabric", ["1GbE", "10GbE", "100GbE"])
@pytest.mark.parametrize("steps,deadline", [(None, None), (100.0, None), (100.0, 60.0), (100.0, 1.0)])
def test_price_picks_the_same_world_on_shared_rows(tmp_path, fabric, steps, deadline):
    calib, jcalib = costmodel.calibrate(toy_report()), jax_costmodel.calibrate(toy_report())
    sched = FleetScheduler(JobSpool(str(tmp_path / "p")), FleetConfig(n_devices=8, calibration=calib, fabric=fabric))
    jsch = jsched.FleetScheduler(
        jsched.JobSpool(str(tmp_path / "j")), jsched.FleetConfig(n_devices=8, calibration=jcalib, fabric=fabric)
    )
    kw = dict(job_id="t", argv=["x"], steps=steps, deadline_s=deadline, max_world=8)
    job, jjob = JobManifest(**kw), jsched.JobManifest(**kw)
    now = time.monotonic()
    sched._born["t"] = jsch._born["t"] = now
    got = sched._price(job, [1, 2, 4, 8])
    want = jsch._price(jjob, [1, 2, 4, 8])
    assert got == want and got["planner"] == "costmodel"


def test_default_fabric_is_the_port_row_and_prices(tmp_path):
    """The pinned difference: the JAX package's default fabric is a row of
    neither table, so its priced admission falls back; the port's default
    is its in-node row and prices."""
    assert FleetConfig().fabric == "NVLink4(H100)" == costmodel.INNER_FABRIC
    assert jsched.FleetConfig().fabric == "tpu_ici"
    calib, jcalib = costmodel.calibrate(toy_report()), jax_costmodel.calibrate(toy_report())
    sched = FleetScheduler(JobSpool(str(tmp_path / "p")), FleetConfig(n_devices=8, calibration=calib))
    jsch = jsched.FleetScheduler(jsched.JobSpool(str(tmp_path / "j")), jsched.FleetConfig(n_devices=8, calibration=jcalib))
    sched._born["t"] = jsch._born["t"] = time.monotonic()
    got = sched._price(JobManifest(job_id="t", argv=["x"], max_world=8), [1, 2, 4, 8])
    want = jsch._price(jsched.JobManifest(job_id="t", argv=["x"], max_world=8), [1, 2, 4, 8])
    assert got["planner"] == "costmodel" and got["world"] == costmodel.search_slices(
        calib, [1, 2, 4, 8], "NVLink4(H100)")[0]["world"]
    assert want["planner"] == "fallback" and want["reason"].startswith("pricing failed") and want["world"] == 1
    # the port's scheduler on the JAX package's default name falls back the
    # same way (the message lists each package's own rows)
    sched.cfg.fabric = "tpu_ici"
    fallback = sched._price(JobManifest(job_id="t", argv=["x"], max_world=8), [1, 2, 4, 8])
    assert fallback["reason"].replace("NVLink4(H100)", "ICI(v5e)") == want["reason"]
    assert {k: v for k, v in fallback.items() if k != "reason"} == {k: v for k, v in want.items() if k != "reason"}
    # without a calibration both fall back to the smallest viable world
    sched.cfg.calibration = jsch.cfg.calibration = None
    assert sched._price(JobManifest(job_id="t", argv=["x"]), [2, 4]) == jsch._price(
        jsched.JobManifest(job_id="t", argv=["x"]), [2, 4]) == {
        "world": 2, "planner": "fallback", "reason": "no calibration; smallest viable slice"}


# ---- leases ------------------------------------------------------------------------


def _lease_sequence(pkg, root):
    cap = Capture()
    sched = pkg.FleetScheduler(pkg.JobSpool(root), config=pkg.FleetConfig(n_devices=4), telemetry=cap)
    grants = [sched.lease("serve-pool", 2, reason="scale_up"), sched.leased("serve-pool")]
    grants.append(sched.lease("serve-pool", 5))  # partial: what the free list covers
    grants.append(sched.lease("serve-pool", 1))  # dry
    grants.append(sched.lease("serve-pool", 0))
    sched.lease_release("serve-pool", ranks=[1])
    grants.append(sched.leased("serve-pool"))
    sched.lease_release("serve-pool", ranks=[7])  # unknown: ignored
    sched.lease_release("serve-pool")
    grants.append(sched.leased("serve-pool"))
    sched.lease_release("serve-pool")  # again: a no-op
    sched._reserved["svc"] = [0]
    grants.append(sched.lease("other", 4))  # the reserved chip is not leased
    return grants, cap.records("schedule")


def test_lease_sequence_matches(tmp_path):
    got, got_events = _lease_sequence(sched_mod, str(tmp_path / "p"))
    want, want_events = _lease_sequence(jsched, str(tmp_path / "j"))
    assert got == want == [[0, 1], [0, 1], [2, 3], [], [], [0, 2, 3], [], [1, 2, 3]]
    assert got_events == want_events
    assert [e["world"] for e in got_events] == [2, 2, 0, 0, 3]
    assert all(e["planner"] == "lease" for e in got_events)


# ---- the worker's card -------------------------------------------------------------


@pytest.fixture
def no_placement_env(monkeypatch):
    for name in ("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK", "RESILIENCE_DEVICE_RANKS"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_card_choice_local_rank_wins(no_placement_env):
    no_placement_env.setenv("LOCAL_RANK", "0")
    no_placement_env.setenv("RESILIENCE_DEVICE_RANKS", json.dumps([2, 3]))
    assert launch.worker_cuda_device(1, 2, device_count=4) == "cuda:0"
    assert launch.worker_cuda_device(None, 1, device_count=1) == "cuda:0"


def test_card_choice_process_id_without_a_grant(no_placement_env):
    assert launch.worker_cuda_device(None, 1, device_count=1) == "cuda:0"
    assert launch.worker_cuda_device(3, 4, device_count=4) == "cuda:3"


@pytest.mark.parametrize("granted,pid,world,want", [
    ([2, 3], 0, 2, "cuda:2"),  # a supervised job's whole list, by rank
    ([2, 3], 1, 2, "cuda:3"),
    ([1], 0, 1, "cuda:1"),
    ([3], 2, 3, "cuda:3"),  # an autoscaler worker's own lease, worker id 2 of 3
])
def test_card_choice_follows_the_grant(no_placement_env, granted, pid, world, want):
    no_placement_env.setenv("RESILIENCE_DEVICE_RANKS", json.dumps(granted))
    assert launch.worker_cuda_device(pid, world, device_count=4) == want


@pytest.mark.parametrize("granted,pid,world", [([0, 1, 2], 0, 2), ([0, 1], None, 2), ([0, 1], 2, 2)])
def test_card_choice_refuses_a_grant_of_another_shape(no_placement_env, granted, pid, world):
    no_placement_env.setenv("RESILIENCE_DEVICE_RANKS", json.dumps(granted))
    with pytest.raises(ValueError):
        launch.worker_cuda_device(pid, world, device_count=4)


@pytest.mark.parametrize("env,pid,world", [
    ({"RESILIENCE_DEVICE_RANKS": "[1]"}, 0, 1),
    ({"RESILIENCE_DEVICE_RANKS": "[0, 1]"}, 1, 2),
    ({"LOCAL_RANK": "1"}, 0, 1),
    ({}, 1, 2),
])
def test_card_choice_raises_on_a_missing_card(no_placement_env, env, pid, world):
    for k, v in env.items():
        no_placement_env.setenv(k, v)
    with pytest.raises(RuntimeError, match="this machine has 1 card"):
        launch.worker_cuda_device(pid, world, device_count=1)


def test_worker_without_a_card_fails_before_any_work(no_placement_env):
    """The launcher's worker on a machine with no card: a granted card
    raises, nothing falls back to the CPU."""
    no_placement_env.setenv("RESILIENCE_DEVICE_RANKS", "[0]")
    with pytest.raises(RuntimeError, match="card 0"):
        launch.main(["bare_init"])


# ---- launch fleet ------------------------------------------------------------------


def test_launch_fleet_runs_a_job_and_quarantines_a_looper(tmp_path):
    jobs = [
        JobManifest(job_id="ok", argv=[sys.executable, "-c", "pass"], priority=1, steps=2.0).to_wire(),
        JobManifest(job_id="looper", argv=[sys.executable, "-c", "raise SystemExit(43)"], max_strikes=3,
                    max_restarts=0).to_wire(),
    ]
    with open(tmp_path / "jobs.json", "w") as f:
        json.dump(jobs, f)
    out = tmp_path / "summary.json"
    got = launch.main([
        "fleet", "--spool-dir", str(tmp_path / "spool"), "--devices", "2", "--run-dir", str(tmp_path / "run"),
        "--submit", str(tmp_path / "jobs.json"), "--out", str(out), "--max-wall-s", "60",
    ])
    assert got == {"fleet_rc": 0}
    with open(out) as f:
        summary = json.load(f)
    assert summary["completed"] == ["ok"] and summary["quarantined"] == ["looper"] and not summary["unfinished"]
    assert summary["jobs"]["looper"]["last_rc"] == 43 and summary["jobs"]["looper"]["strikes"] == 3
    # the fleet's log holds the same story, and the report reads it as the JAX report does
    events = runlog.merge_run(str(tmp_path / "run")).events
    fleet = load_script("torch_report").fleet_summary_from_events(events)
    assert fleet == load_script("report").fleet_summary_from_events(events)
    assert fleet["completed"] == ["ok"] and fleet["quarantined"] == ["looper"]
    assert fleet["jobs"]["looper"]["transitions"] == ["submitted", "started", "parked", "resumed", "parked",
                                                      "resumed", "failed"]


def test_launch_fleet_exits_1_while_a_job_is_unfinished(tmp_path):
    """The command's exit code is the scheduler's: a job still running at
    the fleet's wall cap is preempted and left unfinished."""
    with open(tmp_path / "jobs.json", "w") as f:
        json.dump([JobManifest(job_id="slow", argv=[sys.executable, "-c", "import time; time.sleep(60)"]).to_wire()], f)
    proc = subprocess.run(
        [sys.executable, "-m", "network_distributed_pytorch_tpu_torch.launch", "fleet", "--spool-dir",
         str(tmp_path / "spool"), "--devices", "1", "--submit", str(tmp_path / "jobs.json"), "--max-wall-s", "0.5",
         "--out", str(tmp_path / "summary.json")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1, proc.stderr[-2000:]
    with open(tmp_path / "summary.json") as f:
        assert json.load(f)["unfinished"] == ["slow"]


# ---- end to end --------------------------------------------------------------------


def _two_job_fleet(pkg, root):
    spool = pkg.JobSpool(os.path.join(root, "jobs"))
    spool.submit([
        pkg.JobManifest(job_id="ok", argv=[sys.executable, "-c", "pass"], steps=2.0),
        pkg.JobManifest(job_id="boom", argv=[sys.executable, "-c", "raise SystemExit(43)"], priority=1,
                        max_restarts=0, max_strikes=2),
    ])
    summary = pkg.FleetScheduler(
        spool, pkg.FleetConfig(n_devices=2, max_wall_s=60.0, term_grace_s=2.0), run_dir=os.path.join(root, "fleet")
    ).run()
    return summary, spool.quarantined_ids()


def _timeless(summary):
    out = json.loads(json.dumps(summary))
    for key in ("wall_s", "total_chip_seconds", "goodput"):
        out.pop(key, None)
    for rec in out["jobs"].values():
        rec.pop("chip_seconds")
    return out


def test_two_job_fleet_matches_the_jax_scheduler(tmp_path):
    got, got_q = _two_job_fleet(sched_mod, str(tmp_path / "p"))
    want, want_q = _two_job_fleet(jsched, str(tmp_path / "j"))
    assert _timeless(got) == _timeless(want)
    assert got_q == want_q == ["boom"]
    assert got["completed"] == ["ok"] and got["jobs"]["boom"]["last_rc"] == 43 and got["jobs"]["boom"]["strikes"] == 2
    assert got["weighted_work"] == 2.0 and got["goodput"] > 0.0 and got["total_chip_seconds"] > 0.0


TRAIN_STEPS = 30


def _train_argv(state_dir, result_dir, step_seconds, graceful=True):
    return [
        sys.executable, TOY, "--rank", "{rank}", "--world", "{world}", "--steps", str(TRAIN_STEPS),
        "--step-seconds", str(step_seconds), "--state-dir", state_dir, "--result-dir", result_dir,
        *(["--graceful-term"] if graceful else []),
    ]


@pytest.fixture(scope="module")
def game_day(tmp_path_factory):
    """The JAX package's fleet game day (its ``scripts/run_probe.py`` phase
    10) on the port's toy workers: a serving pool (priority 10, 2 chips)
    with a hair-trigger SLO detector, a training job (priority 1, 2 chips)
    and a crash-looper, on 4 chips; then the training job run again without
    the fleet, the oracle."""
    root = str(tmp_path_factory.mktemp("game_day"))
    req_dir = os.path.join(root, "requests")
    FileSpool(req_dir).ensure(poisson_workload(WorkloadConfig(n_requests=32, rate_rps=0.0, seed=7)))
    svc = JobManifest(
        job_id="svc", kind="serve", priority=10, min_world=2, max_world=2, steps=32, deadline_s=60.0,
        argv=[sys.executable, TOY_SERVE, "--rank", "{rank}", "--world", "{world}", "--spool-dir", req_dir,
              "--result-dir", os.path.join(root, "serve_results"), "--slots", "2", "--step-seconds", "0.02",
              "--max-wall-s", "45"],
    )
    # min_world == max_world: the toy state is world-sensitive, so the
    # resume must land at the world it was parked at
    train = JobManifest(
        job_id="train", kind="train", priority=1, min_world=2, max_world=2, steps=TRAIN_STEPS, deadline_s=120.0,
        argv=_train_argv(os.path.join(root, "train_state"), os.path.join(root, "train_results"), 0.1),
    )
    looper = JobManifest(job_id="looper", argv=[sys.executable, "-c", "raise SystemExit(43)"], max_strikes=3,
                         max_restarts=0)
    spool = JobSpool(os.path.join(root, "jobs"))
    spool.submit([svc, train, looper])
    fleet_dir = os.path.join(root, "fleet")
    summary = FleetScheduler(
        spool,
        config=FleetConfig(
            n_devices=4, max_wall_s=120.0, term_grace_s=3.0, escalation_sustain=1, escalation_cooldown_s=5.0,
            serve_detector=DetectorConfig(slo_target_s=1e-3, slo_sustain=1, cooldown=2),
        ),
        run_dir=fleet_dir,
    ).run()
    oracle = [
        subprocess.Popen([
            a.replace("{rank}", str(r)).replace("{world}", "2")
            for a in _train_argv(os.path.join(root, "oracle_state"), os.path.join(root, "oracle_results"), 0.005,
                                 graceful=False)
        ])
        for r in range(2)
    ]
    oracle_rcs = [p.wait(timeout=120) for p in oracle]
    return {"root": root, "summary": summary, "spool": spool, "fleet_dir": fleet_dir, "req_dir": req_dir,
            "oracle_rcs": oracle_rcs, "events": runlog.merge_run(fleet_dir).events}


def test_game_day_outcomes(game_day):
    s = game_day["summary"]
    assert s["completed"] == ["svc", "train"] and s["quarantined"] == ["looper"] and not s["unfinished"]
    assert s["preemptions"] >= 1 and s["jobs"]["train"]["preemptions"] >= 1
    assert s["jobs"]["looper"]["last_rc"] == 43 and s["jobs"]["looper"]["strikes"] == 3
    assert game_day["spool"].quarantined_ids() == ["looper"]
    assert s["goodput"] > 0.0


def test_game_day_preempts_for_the_burning_pool(game_day):
    events = game_day["events"]
    preempts = [e for e in events if e.get("event") == "preempt"]
    assert any(p["victim"] == "train" and p["beneficiary"] == "svc" and p["reason"] == "slo_burn" for p in preempts)
    states = [e["state"] for e in events if e.get("event") == "job" and e.get("job_id") == "train"]
    for want in ("preempting", "parked", "resumed", "completed"):
        assert want in states, states
    assert states.index("preempting") < states.index("parked") < states.index("resumed") < states.index("completed")
    # gang semantics: every admission a whole grant inside the inventory
    for e in events:
        if e.get("event") == "schedule":
            assert len(e["device_ranks"]) == e["world"] and set(e["device_ranks"]) <= {0, 1, 2, 3}


def test_game_day_resume_matches_the_uninterrupted_run(game_day):
    root = game_day["root"]
    assert game_day["oracle_rcs"] == [0, 0]
    for r in range(2):
        with open(os.path.join(root, "train_state", f"rank{r}.json")) as f:
            got = json.load(f)
        with open(os.path.join(root, "oracle_state", f"rank{r}.json")) as f:
            want = json.load(f)
        assert got == want


def test_game_day_serves_every_request_once(game_day):
    spool = FileSpool(game_day["req_dir"])
    assert spool.drained() and sorted(spool.done_ids()) == spool.manifest_ids()
    finished = []
    shard_dir = os.path.join(game_day["fleet_dir"], "jobs", "svc.seg0")
    for name in os.listdir(shard_dir):
        if name.startswith("events_rank"):
            events, _ = runlog.load_shard(os.path.join(shard_dir, name))
            finished += [e["request_id"] for e in events if e.get("event") == "request" and e["state"] == "finished"]
    assert sorted(finished) == spool.manifest_ids()


def test_game_day_fleet_report_matches_the_jax_report(game_day):
    events = game_day["events"]
    fleet = load_script("torch_report").fleet_summary_from_events(events)
    assert fleet == load_script("report").fleet_summary_from_events(events)
    s = game_day["summary"]
    assert fleet["completed"] == s["completed"] and fleet["quarantined"] == s["quarantined"]
    assert fleet["preemptions"] == s["preemptions"] and fleet["weighted_work"] == s["weighted_work"]
    assert fleet["goodput"] == pytest.approx(s["goodput"]) and fleet["goodput"] > 0
    text, report = load_script("torch_report").run_report(game_day["fleet_dir"])
    assert report["fleet"] == fleet and "fleet control plane" in text



def test_game_day_whole_report_matches_the_jax_report(game_day):
    text, report = load_script("torch_report").run_report(game_day["fleet_dir"])
    jtext, ref = load_script("report").run_report(game_day["fleet_dir"])
    for key in REPORT_KEYS:
        assert_key_equal(report, ref, key)
    assert_text_equal(text, jtext)
    assert report["fleet"]["goodput"] > 0 and "goodput" in text

def test_detector_config_fields_match():
    assert [f.name for f in dataclasses.fields(DetectorConfig)] == [
        f.name for f in dataclasses.fields(JaxDetectorConfig)]
