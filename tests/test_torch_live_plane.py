"""The live plane of a supervised run: the port's ``Supervisor`` with a run
directory and ``metrics_port``, against the JAX package's on the same
scenario, and the launcher's ``--run-dir``, ``--metrics-port`` and
``--alert-restart-after``.

The game day is the JAX package's (its ``scripts/run_probe.py`` phase 4),
on the toy workers (the port's ``torch_toy_supervised_worker.py``, the JAX
package's ``toy_supervised_worker.py``): a world of 2 with the health
sampler on every step and a chaos ``grad_spike`` on rank 0 at step 8. The
supervisor's aggregator must page (critical ``grad_spike``), serve the
step counters on ``/metrics`` while the run is alive (scraped on the port
the run directory advertises), log the ``AlertEvent`` in its own log and
in ``alerts.jsonl``, and every worker's controller must descend with an
``alert:grad_spike:critical`` trigger; afterwards the live step p50 is
within 5 % of ``rank_step_stats`` over the merged run. Both supervisors
fire the same alert kinds and counts.

``alert_restart_after=1`` kills the paged rank: at a world above one the
port restarts the whole generation (a ``torch.distributed`` group takes no
new member; the survivor gets ``worker_term``), where the JAX supervisor
restarts the one rank.

The JAX package's ``scripts/report.py --run-dir`` reads a port run
directory: it exits 0, shows the sections of a supervised run, and its
per-rank step statistics are the port's ``merge_run`` and
``rank_step_stats``.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

import network_distributed_pytorch_tpu.resilience.supervisor as jsup
from network_distributed_pytorch_tpu.observe import live as jax_live
from network_distributed_pytorch_tpu.observe import health as jax_health
from network_distributed_pytorch_tpu.observe import telemetry_for_run as jax_telemetry_for_run
from network_distributed_pytorch_tpu.resilience.chaos import ChaosPlan as JaxChaosPlan
from network_distributed_pytorch_tpu.resilience.chaos import FaultSpec as JaxFaultSpec
from network_distributed_pytorch_tpu_torch import launch
from network_distributed_pytorch_tpu_torch.observe import analytics, health, live, runlog, telemetry_for_run
from network_distributed_pytorch_tpu_torch.resilience import ChaosPlan, FaultSpec, Supervisor, SupervisorConfig
from torch_report_parity import REPORT_KEYS, assert_key_equal, assert_text_equal, load_script

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)
TOYS = {
    "port": os.path.join(TESTS_DIR, "torch_toy_supervised_worker.py"),
    "jax": os.path.join(TESTS_DIR, "toy_supervised_worker.py"),
}
STEPS, STEP_S, SPIKE_STEP = 40, 0.03, 8


def _records(path, event=None):
    out = []
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if event is None or rec.get("event") == event:
                out.append(rec)
    return out


def _game_day(root, side, steps=STEPS, **config):
    """The scenario under one package's supervisor: ``(result, run_dir,
    mid-run scrape, supervisor)``."""
    run_dir = str(root / side)
    os.makedirs(run_dir)
    plan = os.path.join(run_dir, "plan.json")
    plan_cls, spec_cls = (ChaosPlan, FaultSpec) if side == "port" else (JaxChaosPlan, JaxFaultSpec)
    plan_cls([spec_cls(kind="grad_spike", step=SPIKE_STEP, rank=0)]).save(plan)

    def argv(rank, world, incarnation):
        return [
            sys.executable, TOYS[side], "--rank", str(rank), "--world", str(world), "--steps", str(steps),
            "--state-dir", os.path.join(run_dir, "state"), "--result-dir", os.path.join(run_dir, "results"),
            "--step-seconds", str(STEP_S), "--health-every", "1", "--chaos-plan", plan,
        ]

    tel_fn = telemetry_for_run if side == "port" else jax_telemetry_for_run
    tel = tel_fn(event_log=os.path.join(run_dir, runlog.SUPERVISOR_LOG), stdout=False)
    sup_cls, cfg_cls = (Supervisor, SupervisorConfig) if side == "port" else (jsup.Supervisor, jsup.SupervisorConfig)
    cfg = dict(max_restarts=1, backoff_base_s=0.05, poll_interval_s=0.05, metrics_port=0, deadline_s=120.0)
    cfg.update(config)
    sup = sup_cls(argv, 2, cfg_cls(**cfg), telemetry=tel, run_dir=run_dir)
    scrape = {}

    def scrape_mid_run():
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            port = live.read_port_file(run_dir)
            if port is not None:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2.0) as resp:
                        body = resp.read().decode()
                    if "live_steps_total" in body:
                        results = os.path.join(run_dir, "results")
                        finished = os.listdir(results) if os.path.isdir(results) else []
                        scrape.update(status=resp.status, body=body, finished=finished)
                        return
                except OSError:
                    pass
            time.sleep(0.05)

    scraper = threading.Thread(target=scrape_mid_run, daemon=True)
    scraper.start()
    try:
        result = sup.run()
    finally:
        tel.close()
    scraper.join(timeout=10.0)
    return result, run_dir, scrape, sup


@pytest.fixture(scope="module")
def game_days(tmp_path_factory):
    root = tmp_path_factory.mktemp("game_day")
    return {side: _game_day(root, side) for side in ("port", "jax")}


def _alerts(run_dir):
    return [(a["alert"], a["severity"], a["rank"], a["step"]) for a in _records(
        os.path.join(run_dir, runlog.ALERTS_LOG), "alert")]


def test_game_day_pages_scrapes_and_nudges(game_days):
    result, run_dir, scrape, sup = game_days["port"]
    assert result.success and result.total_restarts == 0, result
    # scraped while the run was alive: the step counters, on the advertised port
    assert scrape.get("status") == 200 and len(scrape["finished"]) < 2, scrape
    assert any(line.startswith("live_steps_total{rank=") and float(line.split()[-1]) > 0
               for line in scrape["body"].splitlines())
    assert sup.metrics_port == live.read_port_file(run_dir)
    # the alert, in alerts.jsonl and in the supervisor's own log
    assert ("grad_spike", "critical", 0, SPIKE_STEP) in _alerts(run_dir)
    sup_log = _records(os.path.join(run_dir, runlog.SUPERVISOR_LOG))
    assert any(r.get("event") == "alert" and r["alert"] == "grad_spike" for r in sup_log)
    assert [r["kind"] for r in sup_log if r.get("event") == "failure"][0] == "metrics_up"
    assert sup_log[0]["event"] != "marker"  # a Supervisor alone emits no marker; the launcher does
    # every worker's controller descended on the alert
    merged = runlog.merge_run(run_dir)
    nudges = [e for e in merged.events if e.get("event") == "policy"]
    assert sorted(e["rank"] for e in nudges) == [0, 1]
    assert {(e["trigger"], e["rung_before"], e["rung_after"]) for e in nudges} == {
        ("alert:grad_spike:critical", "baseline", "compress")}
    # every shard led by its marker, on the manifest's spawns
    for rank in (0, 1):
        assert merged.per_rank[rank]["markers"] == 1 and merged.per_rank[rank]["torn_lines"] == 0
        first = _records(runlog.shard_path(run_dir, rank))[0]
        assert (first["event"], first["kind"], first["run_id"], first["rank"]) == ("marker", "run_start",
                                                                                  sup.run_id, rank)
    # the live p50 against the report's statistic over the merged run
    agg = live.LiveAggregator(run_dir)
    agg.poll()
    stats = analytics.rank_step_stats(merged.events)
    want = analytics.percentile([s["p50_s"] for s in stats.values()], 50)
    assert abs(agg.registry.get_gauge("live_step_time_p50_seconds") - want) <= 0.05 * want
    assert all(s["n"] == STEPS - 1 for s in stats.values())


def test_game_day_fires_what_the_jax_supervisor_fires(game_days):
    (res, run_dir, _, _), (jres, jrun_dir, jscrape, _) = game_days["port"], game_days["jax"]
    assert res.success and jres.success and jscrape.get("status") == 200
    # the same alerts (each rank's in its order; the ranks' interleaving is the machine's)
    assert sorted(_alerts(run_dir)) == sorted(_alerts(jrun_dir))
    got = sorted(r["alert"] for r in _records(os.path.join(run_dir, runlog.SUPERVISOR_LOG), "alert"))
    want = sorted(r["alert"] for r in _records(os.path.join(jrun_dir, runlog.SUPERVISOR_LOG), "alert"))
    assert got == want and got.count("grad_spike") == 1 and "hbm_headroom" in got


def test_jax_report_reads_a_port_run_directory(game_days, tmp_path):
    _, run_dir, _, _ = game_days["port"]
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "report.py"), "--run-dir", run_dir, "--json-out", str(out)],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    for section in ("failures — timeline", "policy — fallback ladder timeline", "per-rank step time",
                    "live alerts — streaming detector verdicts", "wire ledger"):
        assert section in proc.stdout, section
    report = json.loads(out.read_text())
    merged = runlog.merge_run(run_dir)
    stats = analytics.rank_step_stats(merged.events)
    assert report["n_events"] == len(merged.events) and report["torn_lines"] == merged.torn_lines
    for rank, s in stats.items():
        row = report["ranks"][str(rank)]
        assert {k: row[k] for k in ("n", "p50_s", "p95_s", "mean_s")} == s
        assert {k: row[k] for k in merged.per_rank[rank]} == merged.per_rank[rank]
    fired = {}
    for a in _records(os.path.join(run_dir, runlog.SUPERVISOR_LOG), "alert"):
        fired[a["alert"]] = fired.get(a["alert"], 0) + 1
    assert report["alerts"]["by_kind"] == fired and fired["grad_spike"] == 1
    assert report["policy"]["descends"] == 2



def test_port_report_of_the_game_day_matches_the_jax_report(game_days):
    """``scripts/torch_report.py`` on the port's game day: every key and
    every text line of the JAX script's report of the same directory, and
    the dashboard's frame off each package's aggregator."""
    _, run_dir, _, _ = game_days["port"]
    port_mod, jax_mod = load_script("torch_report", "liveplane"), load_script("report", "jaxliveplane")
    (text, port), (jtext, ref) = port_mod.run_report(run_dir), jax_mod.run_report(run_dir)
    for key in REPORT_KEYS:
        assert_key_equal(port, ref, key)
    assert_text_equal(text, jtext)
    assert port["alerts"]["by_kind"]["grad_spike"] == 1 and port["policy"]["descends"] == 2
    frames = []
    for mod, agg in ((port_mod, live.LiveAggregator(run_dir)), (jax_mod, jax_live.LiveAggregator(run_dir))):
        agg.poll()
        frames.append(mod.render_watch_frame(agg, run_dir))
    assert_text_equal(*frames)

def test_alert_restart_after_restarts_the_whole_generation(tmp_path):
    """One critical alert on rank 0 kills it; the port then restarts the
    whole generation (``worker_term`` of rank 1, both ranks respawned with
    incarnation 1), where the JAX supervisor respawns rank 0 alone. The
    toy's memory ramp would page critically too: each side's
    ``detector_config`` lifts the headroom thresholds out of reach."""
    out = {}
    for side, config in (("port", health.DetectorConfig), ("jax", jax_health.DetectorConfig)):
        quiet = config(headroom_warn_frac=2.0, headroom_critical_frac=2.0)
        # long enough that rank 1 is still running when rank 0 is killed
        result, run_dir, _, _ = _game_day(tmp_path, side, steps=150, alert_restart_after=1, max_restarts=2,
                                          detector_config=quiet, correlation_window_s=0.5)
        kinds = [(r["kind"], r.get("rank")) for r in _records(os.path.join(run_dir, runlog.SUPERVISOR_LOG), "failure")]
        out[side] = (result, kinds, run_dir)
    (res, kinds, run_dir), (jres, jkinds, _) = out["port"], out["jax"]
    assert res.success and jres.success and res.total_restarts == jres.total_restarts == 1
    assert ("alert_restart", 0) in kinds and ("alert_restart", 0) in jkinds
    assert ("worker_term", 1) in kinds and ("worker_term", 1) not in jkinds
    manifest = runlog.RunManifest.load(run_dir)
    assert manifest.incarnations == {0: 2, 1: 2}
    assert runlog.RunManifest.load(out["jax"][2]).incarnations == {0: 2, 1: 1}
    alerts = _alerts(run_dir)
    assert alerts == _alerts(out["jax"][2]) == [("grad_spike", "critical", 0, SPIKE_STEP)]
    for rank in (0, 1):
        with open(os.path.join(run_dir, "results", f"rank{rank}.json")) as f:
            assert json.load(f)["incarnation"] == 1


# ---- the launcher -------------------------------------------------------------------


@pytest.mark.parametrize("argv,match", [
    (["--metrics-port", "0"], "--metrics-port requires --supervise and --run-dir"),
    (["--supervise", "--metrics-port", "0"], "--metrics-port requires --supervise and --run-dir"),
    (["--run-dir", "d", "--metrics-port", "0"], "--metrics-port requires --supervise and --run-dir"),
    (["--alert-restart-after", "2"], "--alert-restart-after requires --supervise"),
])
def test_launcher_checks_the_live_plane_flags(argv, match):
    with pytest.raises(ValueError, match=match):
        launch.main(["exact_cifar10", "--device", "cpu", *argv])


def test_launcher_refuses_a_run_dir_where_no_event_log_is_written():
    with pytest.raises(ValueError, match="--run-dir is not supported by 'gpt_lm'"):
        launch.main(["gpt_lm", "--device", "cpu", "--run-dir", "d"])


def test_launch_supervise_with_a_run_dir_and_the_live_plane(tmp_path, monkeypatch):
    """``launch exact_cifar10 --supervise --run-dir D --metrics-port 0`` on
    the CPU: the manifest, the rank's shard led by its marker, the
    supervisor's log led by the parent's marker, the advertised port, and
    the summary's ``run_dir`` and ``run_id``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    summary = launch.main([
        "exact_cifar10", "--device", "cpu", "--preset", "small", "--global-batch", "16", "--epochs", "1",
        "--max-steps-per-epoch", "3", "--supervise", "--num-processes", "1", "--run-dir", "run",
        "--metrics-port", "0", "--alert-restart-after", "3", "--log-every", "0", "--worker-log-dir", "logs",
    ])
    assert summary["success"] and summary["run_dir"] == "run" and summary["run_id"].startswith("run.")
    manifest = runlog.RunManifest.load("run")
    assert (manifest.run_id, manifest.world_size, manifest.shards) == (summary["run_id"], 1,
                                                                       {0: "events_rank0.jsonl"})
    sup_log = _records(os.path.join("run", runlog.SUPERVISOR_LOG))
    assert (sup_log[0]["event"], sup_log[0]["kind"], sup_log[0]["run_id"]) == ("marker", "run_start",
                                                                              summary["run_id"])
    kinds = [r["kind"] for r in sup_log if r.get("event") == "failure"]
    assert kinds[0] == "metrics_up" and kinds[-1] == "run_complete" and "alert_restart" not in kinds
    shard = _records(runlog.shard_path("run", 0))
    assert (shard[0]["event"], shard[0]["kind"], shard[0]["run_id"], shard[0]["rank"]) == (
        "marker", "run_start", summary["run_id"], 0)
    assert len([r for r in shard if r.get("event") == "step"]) == 3
    assert live.read_port_file("run") is not None
    merged = runlog.merge_run("run")
    assert merged.per_rank[0]["markers"] == 1 and merged.torn_lines == 0
    # the live-plane flags are the parent's: the worker's command line has none
    log = open(os.path.join("logs", "rank0.0.log")).read()
    assert "--metrics-port" not in log
    assert launch.worker_argv_base(["exact_cifar10", "--run-dir", "r", "--metrics-port", "0",
                                    "--alert-restart-after", "3"]) == ["exact_cifar10", "--run-dir", "r"]
