"""The port's supervising launcher (``resilience/supervisor.py`` and the
launcher's ``--supervise``) against real subprocesses and the JAX
package's supervisor.

The toy scenarios of the JAX package's ``tests/test_supervisor.py`` drive
the torch-free ``torch_toy_supervised_worker.py`` (millisecond restarts):
crash and resume, a hang caught by the heartbeat, the degraded shrink,
``allow_degraded=False``, SIGKILL's negative return code, graceful against
hard deaths, the quorum replan on a ``zone_outage``, ``host_flap`` and the
fail-fast exit code. Each is also run under the JAX package's
``Supervisor`` on the same worker, and the failure event kinds compared: at
a world of one they are the same list; at a world above one the port
restarts the whole generation (a ``torch.distributed`` group takes no new
member), so it adds ``worker_term`` for each survivor and re-runs a rank
that had finished (``test_world_2_restarts_the_whole_generation`` pins
it), and it gathers a zone outage's deaths before it replans, where the
JAX supervisor may first restart the rank it saw die first.

Exact equality with the JAX functions: ``plan_mesh``'s policy table, the
seeded backoff schedule, ``worker_argv_base`` and ``parse_mesh_shape``.
And the parent holds no card: the supervisor imports and runs a toy world
with torch blocked. ``launch exact_cifar10 --supervise`` on the CPU
restarts a killed worker, which resumes from its checkpoint.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

import network_distributed_pytorch_tpu.launch as jlaunch
import network_distributed_pytorch_tpu.resilience.supervisor as jsup
from network_distributed_pytorch_tpu.observe import MemorySink as JaxMemorySink
from network_distributed_pytorch_tpu.observe import Telemetry as JaxTelemetry
from network_distributed_pytorch_tpu_torch import launch
from network_distributed_pytorch_tpu_torch.observe import MemorySink, Telemetry
from network_distributed_pytorch_tpu_torch.resilience import (
    CKPT_UNWRITABLE_EXIT_CODE,
    PREEMPT_EXIT_CODE,
    ChaosPlan,
    FaultSpec,
    Supervisor,
    SupervisorConfig,
    device_ranks_from_env,
    mesh_from_env,
    plan_mesh,
)
from network_distributed_pytorch_tpu_torch.resilience.supervisor import ENV_DEVICE_RANKS, ENV_MESH

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)
TOY = os.path.join(TESTS_DIR, "torch_toy_supervised_worker.py")


def _kinds(sink):
    return [r.get("kind") for r in sink.records if r.get("event") == "failure"]


def _toy_argv(root, steps=6, plan_path=None, heartbeat=False, step_seconds=0.01, graceful_term=False):
    def argv_for_rank(rank, world, incarnation):
        argv = [
            sys.executable, TOY, "--rank", str(rank), "--world", str(world), "--steps", str(steps),
            "--state-dir", str(root / "state"), "--result-dir", str(root / "results"),
            "--step-seconds", str(step_seconds),
        ]
        if plan_path:
            argv += ["--chaos-plan", plan_path]
        if heartbeat:
            argv += ["--heartbeat-dir", str(root / "hb")]
        if graceful_term:
            argv += ["--graceful-term"]
        return argv

    return argv_for_rank


def _result(root, rank):
    with open(root / "results" / f"rank{rank}.json") as f:
        return json.load(f)


def _both(tmp_path, faults, world, config, steps=6, **toy):
    """The scenario under the port's supervisor and under the JAX
    package's, each in a directory of its own: ``(port, jax)`` of
    ``(result, sink, root, supervisor)``."""
    out = []
    for side, sup_mod, sink in (("port", None, MemorySink()), ("jax", jsup, JaxMemorySink())):
        root = tmp_path / side
        root.mkdir()
        plan_path = None
        if faults:
            plan_path = str(root / "plan.json")
            ChaosPlan(faults).save(plan_path)
        argv = _toy_argv(root, steps=steps, plan_path=plan_path, **toy)
        if side == "port":
            sup = Supervisor(argv, world_size=world, config=SupervisorConfig(**config), telemetry=Telemetry([sink]))
        else:
            sup = jsup.Supervisor(
                argv, world_size=world, config=jsup.SupervisorConfig(**config), telemetry=JaxTelemetry([sink])
            )
        out.append((sup.run(), sink, root, sup))
    return out


FAST = dict(backoff_base_s=0.01, poll_interval_s=0.02, deadline_s=60.0)


def test_toy_crash_restart_resume_at_world_1(tmp_path):
    (res, sink, root, _), (jres, jsink, _, _) = _both(
        tmp_path, [FaultSpec(kind="proc_exit", step=2)], 1, dict(max_restarts=2, **FAST)
    )
    assert res.success and res.total_restarts == 1 and not res.degraded
    r = _result(root, 0)
    assert r["value"] == 6 and r["incarnation"] == 1
    assert _kinds(sink) == _kinds(jsink) == ["worker_exit", "worker_restart", "worker_complete", "run_complete"]
    assert (jres.success, jres.total_restarts) == (True, 1)


def test_world_2_restarts_the_whole_generation(tmp_path):
    """Rank 1 exits at step 2 of a world of 2: rank 0 gets SIGTERM (a
    graceful shutdown), rank 1's budget is charged, both ranks come back
    with incarnation 1 on a fresh rendezvous, and both resume their own
    state. The JAX supervisor restarts rank 1 alone."""
    (res, sink, root, sup), (jres, jsink, jroot, _) = _both(
        tmp_path, [FaultSpec(kind="proc_exit", step=2, rank=1)], 2, dict(max_restarts=2, **FAST),
        steps=150, step_seconds=0.02,  # rank 0 outlives the 2 s in which deaths are gathered
    )
    assert res.success and res.total_restarts == 1 and not res.degraded and res.world_size == 2
    r0, r1 = _result(root, 0), _result(root, 1)
    assert r0["value"] == r1["value"] == 150 * 2
    assert (r0["incarnation"], r1["incarnation"]) == (1, 1)  # the whole generation
    assert (_result(jroot, 0)["incarnation"], _result(jroot, 1)["incarnation"]) == (0, 1)  # rank 1 alone
    terms = [r for r in sink.records if r.get("kind") == "worker_term"]
    assert [(t["rank"], t["incarnation"]) for t in terms] == [(0, 0)]
    assert "graceful shutdown for generation restart" in terms[0]["message"]
    restarts = [r for r in sink.records if r.get("kind") == "worker_restart"]
    assert [r["rank"] for r in restarts] == [1] and "generation restart of world 2" in restarts[0]["message"]
    assert sup.generation == 2 and sup.coordinator.startswith("file://") and sup.coordinator.endswith(".2")
    assert sorted(k for k in _kinds(sink) if k != "worker_term") == sorted(_kinds(jsink))
    assert jres.success and jres.total_restarts == 1


def test_toy_hang_detected_by_heartbeat(tmp_path):
    cfg = dict(max_restarts=2, heartbeat_dir=None, heartbeat_timeout_s=2.0, startup_grace_s=5.0, **FAST)
    outs = []
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
        cfg["heartbeat_dir"] = str(tmp_path / side / "hb")
        plan_path = str(tmp_path / side / "plan.json")
        ChaosPlan([FaultSpec(kind="proc_hang", step=2, payload={"hang_seconds": 60.0})]).save(plan_path)
        argv = _toy_argv(tmp_path / side, steps=5, plan_path=plan_path, heartbeat=True)
        sink = MemorySink() if side == "port" else JaxMemorySink()
        mod = (Supervisor, SupervisorConfig, Telemetry) if side == "port" else (
            jsup.Supervisor, jsup.SupervisorConfig, JaxTelemetry)
        outs.append((mod[0](argv, world_size=1, config=mod[1](**cfg), telemetry=mod[2]([sink])).run(), sink))
    (res, sink), (jres, jsink) = outs
    assert res.success and res.total_restarts == 1 and _result(tmp_path / "port", 0)["value"] == 5
    assert _kinds(sink) == _kinds(jsink)
    assert {"worker_hang", "worker_restart"} <= set(_kinds(sink))


def test_toy_degraded_world_shrink(tmp_path):
    (res, sink, root, _), (jres, jsink, _, _) = _both(
        tmp_path, [FaultSpec(kind="proc_exit", step=1, rank=1, incarnation=None)], 2,
        dict(max_restarts=1, **FAST), steps=5,
    )
    assert res.success and res.degraded and res.world_size == 1
    r0 = _result(root, 0)
    assert r0["world"] == 1 and r0["step"] == 5
    assert not os.path.exists(root / "results" / "rank1.json")
    assert "degraded_restart" in _kinds(sink)
    assert set(_kinds(sink)) - {"worker_term"} == set(_kinds(jsink)) - {"worker_term"}
    assert _kinds(sink).count("worker_restart") == _kinds(jsink).count("worker_restart") == 1
    assert (jres.success, jres.degraded, jres.world_size) == (True, True, 1)


def test_toy_no_degraded_declares_dead(tmp_path):
    (res, sink, _, _), (jres, jsink, _, _) = _both(
        tmp_path, [FaultSpec(kind="proc_exit", step=1, rank=1, incarnation=None)], 2,
        dict(max_restarts=1, allow_degraded=False, **FAST), steps=5,
    )
    assert not res.success and "max_restarts" in res.reason and "run_failed" in _kinds(sink)
    assert not jres.success and jres.reason == res.reason
    assert set(_kinds(sink)) - {"worker_term"} == set(_kinds(jsink))


def test_toy_sigkill_shows_negative_returncode(tmp_path):
    (res, sink, _, _), (_, jsink, _, _) = _both(
        tmp_path, [FaultSpec(kind="proc_kill", step=1)], 1, dict(max_restarts=2, **FAST), steps=4
    )
    assert res.success and res.total_restarts == 1
    exits = [r["message"] for r in sink.records if r.get("kind") == "worker_exit"]
    assert exits == ["exit code -9 (hard death)"]
    assert _kinds(sink) == _kinds(jsink)


def test_toy_graceful_vs_hard_death_classification(tmp_path):
    """A preemption notice honoured (exit 75) in the first life, a SIGKILL
    in the second: both restarted, classified graceful and hard."""
    faults = [FaultSpec(kind="proc_preempt", step=1, incarnation=0), FaultSpec(kind="proc_kill", step=2, incarnation=1)]
    (res, sink, root, _), (_, jsink, _, _) = _both(
        tmp_path, faults, 1, dict(max_restarts=2, **FAST), steps=4, graceful_term=True
    )
    assert res.success and res.total_restarts == 2 and _result(root, 0)["value"] == 4
    msgs = [r["message"] for r in sink.records if r.get("kind") == "worker_exit"]
    assert msgs == [f"exit code {PREEMPT_EXIT_CODE} (graceful death)", "exit code -9 (hard death)"]
    assert msgs == [r["message"] for r in jsink.records if r.get("kind") == "worker_exit"]
    assert _kinds(sink) == _kinds(jsink)


def test_toy_quorum_replan_on_zone_outage(tmp_path):
    cfg = dict(max_restarts=2, min_world_size=2, term_grace_s=0.5, mesh_axes={"data": 2, "tensor": 2},
               correlation_window_s=2.0, **FAST)
    (res, sink, root, _), (jres, jsink, _, _) = _both(
        tmp_path, [FaultSpec(kind="zone_outage", step=2, payload={"ranks": [2, 3]})], 4, cfg, steps=150,
        step_seconds=0.02,  # the survivors outlive the window in which deaths are gathered
    )
    for r, s in ((res, sink), (jres, jsink)):
        assert r.success and r.degraded and r.world_size == 2
        assert r.final_mesh == {"data": 2, "fsdp": 1, "tensor": 1}
        (reshape,) = [x for x in s.records if x.get("event") == "reshape"]
        assert reshape["correlated"] is True and reshape["dead_ranks"] == [2, 3]
    for rank in (0, 1):
        assert _result(root, rank)["world"] == 2 and _result(root, rank)["step"] == 150
    # the JAX supervisor may restart the zone's first-seen rank before the
    # second death completes the burst; the port gathers the generation's
    # deaths first, so it replans without that restart
    assert set(_kinds(sink)) <= set(_kinds(jsink)) and set(_kinds(jsink)) - set(_kinds(sink)) <= {"worker_restart"}
    assert "worker_restart" not in _kinds(sink)


def test_toy_host_flap_stays_independent(tmp_path):
    (res, sink, root, _), (jres, jsink, _, _) = _both(
        tmp_path, [FaultSpec(kind="host_flap", step=1, rank=1, incarnation=None, payload={"flaps": 2})], 2,
        dict(max_restarts=3, mesh_axes={"data": 2}, correlation_window_s=5.0, **FAST), steps=4,
    )
    assert res.success and not res.degraded and res.world_size == 2 and res.total_restarts == 2
    assert not [r for r in sink.records if r.get("event") == "reshape"]
    assert _result(root, 1)["incarnation"] == 2 and _result(root, 0)["incarnation"] == 2
    assert (jres.total_restarts, jres.degraded) == (2, False)
    # the generations re-run rank 0 too (a second worker_complete if it had finished)
    assert set(_kinds(sink)) - {"worker_term"} == set(_kinds(jsink))
    assert _kinds(sink).count("worker_restart") == _kinds(jsink).count("worker_restart") == 2


def test_toy_ckpt_unwritable_fails_fast(tmp_path):
    outs = []
    for side in ("port", "jax"):
        state = tmp_path / side / "state"
        state.mkdir(parents=True)
        (state / "rank0.json.tmp").mkdir()  # open(tmp, "w") -> EISDIR, even as root
        sink = MemorySink() if side == "port" else JaxMemorySink()
        mods = (Supervisor, SupervisorConfig, Telemetry) if side == "port" else (
            jsup.Supervisor, jsup.SupervisorConfig, JaxTelemetry)
        res = mods[0](_toy_argv(tmp_path / side, steps=4), 1, mods[1](max_restarts=3, **FAST),
                      telemetry=mods[2]([sink])).run()
        outs.append((res, sink))
    (res, sink), (jres, jsink) = outs
    assert not res.success and res.total_restarts == 0 and "unwritable" in res.reason
    assert res.exit_codes == {0: CKPT_UNWRITABLE_EXIT_CODE} and res.reason == jres.reason
    assert _kinds(sink) == _kinds(jsink) == ["worker_exit", "run_failed"]


def test_plan_mesh_policy_table_is_the_jax_package_s():
    for mesh in ({"data": 2, "fsdp": 1, "tensor": 2}, {"data": 2, "fsdp": 2, "tensor": 2}, {"data": 4},
                 {"data": 1, "fsdp": 3, "tensor": 4}, {"tensor": 8}, {"data": 3, "fsdp": 2}):
        for survivors in range(0, 17):
            for floor in (1, 2, 3, 5):
                assert plan_mesh(mesh, survivors, floor) == jsup.plan_mesh(mesh, survivors, floor)
    assert plan_mesh({"data": 2, "fsdp": 1, "tensor": 2}, 3) == {"data": 3, "fsdp": 1, "tensor": 1}


def test_env_contract(monkeypatch):
    monkeypatch.delenv(ENV_MESH, raising=False)
    monkeypatch.delenv(ENV_DEVICE_RANKS, raising=False)
    assert mesh_from_env() is None and device_ranks_from_env() is None
    monkeypatch.setenv(ENV_MESH, json.dumps({"data": 2, "tensor": 2}))
    monkeypatch.setenv(ENV_DEVICE_RANKS, "[4, 5]")
    assert mesh_from_env() == jsup.mesh_from_env() == {"data": 2, "tensor": 2}
    assert device_ranks_from_env() == jsup.device_ranks_from_env() == [4, 5]
    monkeypatch.setenv(ENV_MESH, "not json")
    assert mesh_from_env() is None


def test_backoff_schedule_is_the_jax_package_s():
    cfg = dict(backoff_base_s=0.3, backoff_max_s=4.0, backoff_jitter=0.2, seed=21)
    port = Supervisor(lambda *a: [], 1, SupervisorConfig(**cfg))
    ref = jsup.Supervisor(lambda *a: [], 1, jsup.SupervisorConfig(**cfg))
    assert [port._backoff(k) for k in range(1, 9)] == [ref._backoff(k) for k in range(1, 9)]


def test_worker_argv_base_and_mesh_shape_are_the_jax_package_s():
    argv = [
        "exact_cifar10", "--supervise", "--max-restarts", "5", "--heartbeat-timeout=30", "--no-degraded",
        "--process-id", "3", "--num-processes", "8", "--chaos-plan", "plan.json", "--epochs", "2",
        "--mesh-shape", "2x2", "--worker-log-dir", "logs", "--term-grace", "1",
    ]
    assert launch.worker_argv_base(argv) == jlaunch.worker_argv_base(argv) == [
        "exact_cifar10", "--chaos-plan", "plan.json", "--epochs", "2"]
    # the rendezvous is the supervisor's, rewritten each generation
    assert launch.worker_argv_base(["a", "--coordinator", "tcp://h:1", "--coordinator=x"]) == ["a"]
    for spec in ("2x1x2", "2x2", "4×1×1", "8"):
        try:
            want = jlaunch.parse_mesh_shape(spec)
        except ValueError as e:
            with pytest.raises(ValueError, match="mesh-shape"):
                launch.parse_mesh_shape(spec)
            assert "--mesh-shape" in str(e)
            continue
        assert launch.parse_mesh_shape(spec) == want


def test_supervisor_refuses_the_live_plane(tmp_path):
    """The live plane and the run directory are ported: the configuration
    takes them, a supervisor with a run dir writes its manifest, and a
    world of one with ``metrics_port=0`` advertises its port and records
    each life's spawn. What stays refused is the launcher's misuse."""
    from network_distributed_pytorch_tpu_torch.observe import health, runlog

    cfg = SupervisorConfig(metrics_port=0, alert_restart_after=2, detector_config=health.DetectorConfig(),
                           backoff_base_s=0.01, poll_interval_s=0.02)
    assert (cfg.metrics_port, cfg.alert_restart_after) == (0, 2)
    run_dir = str(tmp_path / "run")
    plan = str(tmp_path / "plan.json")
    ChaosPlan([FaultSpec(kind="proc_exit", step=1)]).save(plan)
    argv = _toy_argv(tmp_path, steps=3, plan_path=plan)
    sup = Supervisor(argv, 1, cfg, run_dir=run_dir, run_id="r1")
    assert (sup.run_id, runlog.RunManifest.load(run_dir).spawns) == ("r1", [])
    res = sup.run()
    assert res.success and res.total_restarts == 1
    manifest = runlog.RunManifest.load(run_dir)
    assert [(s["rank"], s["incarnation"]) for s in manifest.spawns] == [(0, 0), (0, 1)]
    assert sup.metrics_port is not None and runlog.METRICS_PORT_NAME in os.listdir(run_dir)
    with pytest.raises(ValueError, match="--mesh-shape requires --supervise"):
        launch.main(["exact_cifar10", "--device", "cpu", "--mesh-shape", "2x2"])
    with pytest.raises(ValueError, match="--chaos-plan is not supported"):
        launch.main(["powersgd_cifar10", "--device", "cpu", "--chaos-plan", "p.json"])


def test_parent_runs_with_torch_blocked(tmp_path):
    """The supervising parent holds no card: the supervisor, the chaos plan
    and the toy worker import with torch blocked, and a toy world with a
    restart runs to its end."""
    plan = str(tmp_path / "plan.json")
    ChaosPlan([FaultSpec(kind="proc_exit", step=1)]).save(plan)
    script = textwrap.dedent(f"""
        import sys
        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("torch", "jax", "flax", "network_distributed_pytorch_tpu"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Blocker())
        sys.path.insert(0, {REPO!r})
        from network_distributed_pytorch_tpu_torch.resilience.supervisor import Supervisor, SupervisorConfig
        from network_distributed_pytorch_tpu_torch.resilience.chaos import ChaosPlan
        ChaosPlan.load({plan!r})
        argv = lambda r, w, i: [sys.executable, {TOY!r}, "--rank", str(r), "--world", str(w), "--steps", "3",
                                "--state-dir", {str(tmp_path / 's')!r}, "--result-dir", {str(tmp_path / 'r')!r},
                                "--chaos-plan", {plan!r}]
        res = Supervisor(argv, 1, SupervisorConfig(backoff_base_s=0.01, poll_interval_s=0.02)).run()
        assert res.success and res.total_restarts == 1, res
        assert "torch" not in sys.modules
        print("OK")
    """)
    # the toy worker itself runs under the same blocker through sitecustomize-free -c
    worker_check = textwrap.dedent(f"""
        import runpy, sys
        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("torch", "jax", "flax", "network_distributed_pytorch_tpu"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Blocker())
        sys.argv = [{TOY!r}, "--rank", "0", "--world", "1", "--steps", "2", "--state-dir", {str(tmp_path / 'w')!r},
                    "--result-dir", {str(tmp_path / 'w')!r}]
        try:
            runpy.run_path({TOY!r}, run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        assert "torch" not in sys.modules
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for code in (script, worker_check):
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=60)
        assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr[-2000:]


def test_launch_supervise_restarts_a_killed_exact_cifar10_worker(tmp_path, monkeypatch):
    """``launch exact_cifar10 --checkpoint-dir D --chaos-plan P --supervise
    --num-processes 1`` on the CPU: the worker SIGKILLs itself in the
    second epoch, the supervisor restarts it, and the restarted life
    resumes from the first epoch's checkpoint and finishes, beating the
    heartbeat directory."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ChaosPlan([FaultSpec(kind="proc_kill", step=3)]).save("plan.json")
    summary = launch.main([
        "exact_cifar10", "--device", "cpu", "--global-batch", "16", "--epochs", "2", "--max-steps-per-epoch", "2",
        "--checkpoint-dir", "ck", "--chaos-plan", "plan.json", "--supervise", "--num-processes", "1",
        "--restart-backoff", "0.01", "--worker-log-dir", "logs", "--log-every", "0", "--heartbeat-dir", "hb",
    ])
    assert summary["success"] and summary["total_restarts"] == 1 and summary["exit_codes"] == {"0": 0}
    assert sorted(os.listdir("logs")) == ["rank0.0.log", "rank0.1.log"]
    second = open("logs/rank0.1.log").read()
    assert '"kind": "resumed"' in second and "starting epoch 1" in second
    assert sorted(n for n in os.listdir("ck") if n.startswith("step_")) == ["step_0", "step_1"]
    # the worker beats the forwarded heartbeat directory after every step
    beat = json.load(open("hb/heartbeat_0.json"))
    assert beat["incarnation"] == 1 and beat["epoch"] == 1


def test_a_world_shuts_down_in_one_grace_period():
    """The survivors of a generation get SIGTERM together and share one
    ``term_grace_s``: three ranks that ignore SIGTERM are SIGKILLed after
    one grace, not three, and one that honours it leaves gracefully."""
    import time

    from network_distributed_pytorch_tpu_torch.resilience.supervisor import _Worker

    ignore = "import signal, time; signal.signal(signal.SIGTERM, signal.SIG_IGN); print('up', flush=True); time.sleep(60)"
    honour = "import time; print('up', flush=True); time.sleep(60)"
    workers = []
    for rank, code in enumerate((ignore, ignore, ignore, honour)):
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True)
        assert proc.stdout.readline().strip() == "up"  # its handler is installed
        workers.append(_Worker(rank=rank, proc=proc, incarnation=0, spawned_at=time.monotonic()))
    sup = Supervisor(lambda *a: [], 4, SupervisorConfig(term_grace_s=0.5))
    t0 = time.monotonic()
    how = sup._kill_all(workers)
    assert time.monotonic() - t0 < 1.4
    assert how == {0: "hard", 1: "hard", 2: "hard", 3: "graceful"}
    assert [w.proc.returncode for w in workers] == [-9, -9, -9, -15]
