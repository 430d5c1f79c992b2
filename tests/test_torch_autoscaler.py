"""The port's serving autoscaler (``resilience.supervisor.ServingAutoscaler``)
against the JAX package's, and a small serving storm end to end.

The decisions are held to the JAX autoscaler's on the same inputs, with
``subprocess.Popen`` replaced by a recorder in both modules and a scripted
spool: scale-ups on a sustained backlog, a lease denied when the fleet's
inventory is dry, a crashed worker replaced under the same id at the next
incarnation on the same lease, a drained worker's lease released, the
wall-cap kill, the spawned command lines and worker environments, and
every ``AutoscaleEvent`` and lease ``ScheduleEvent`` record.

The storm (the JAX package's ``scripts/run_probe.py`` phase 12, smaller):
a burst of requests far above what one toy serving worker
(``torch_toy_serving_worker.py``, the port's ``serve_from_spool`` on a toy
engine) sustains, then a trickle, enqueued at their Poisson arrival times;
the pool must lease chips from a ``FleetScheduler``, grow to at least two
workers, drain, release every lease and lose no request. It runs once, in
a module-scoped fixture shared by its checks.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

import network_distributed_pytorch_tpu.resilience.scheduler as jsched
import network_distributed_pytorch_tpu.resilience.supervisor as jsup
from network_distributed_pytorch_tpu_torch.observe import runlog, telemetry_for_run
from network_distributed_pytorch_tpu_torch.observe.health import DetectorConfig
from network_distributed_pytorch_tpu_torch.resilience import (
    AutoscalerConfig,
    FleetConfig,
    FleetScheduler,
    JobSpool,
    ServingAutoscaler,
)
from network_distributed_pytorch_tpu_torch.resilience import scheduler as sched_mod
from network_distributed_pytorch_tpu_torch.resilience import supervisor as sup_mod
from network_distributed_pytorch_tpu_torch.serving import FileSpool, WorkloadConfig, poisson_workload
from network_distributed_pytorch_tpu_torch.serving.frontend import MANIFEST, _atomic_write

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
TOY_SERVE = os.path.join(TESTS_DIR, "torch_toy_serving_worker.py")
ENV_KEYS = ("RESILIENCE_INCARNATION", "RESILIENCE_RANK", "RESILIENCE_WORLD", "RESILIENCE_DEVICE_RANKS",
            "RUNLOG_RUN_ID")


class Capture:
    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)

    def close(self):
        pass


class FakeProc:
    """A spawned worker that never runs: its exit code is set by the test."""

    spawned = []

    def __init__(self, argv, env=None, stdout=None, stderr=None):
        self.argv, self.env, self.rc = argv, env, None
        FakeProc.spawned.append(self)

    def poll(self):
        return self.rc

    def terminate(self):
        self.rc = -15

    def kill(self):
        self.rc = -9

    def wait(self, timeout=None):
        return self.rc


class ScriptedSpool:
    def __init__(self):
        self.depth = 0

    def queue_depth(self):
        return self.depth

    def drained(self):
        return False


def _decisions(sup, sched, root, monkeypatch):
    FakeProc.spawned = []
    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    cap, spool = Capture(), ScriptedSpool()
    fleet = sched.FleetScheduler(sched.JobSpool(os.path.join(root, "jobs")), sched.FleetConfig(n_devices=2),
                                 telemetry=cap)
    scaler = sup.ServingAutoscaler(
        lambda wid, chips: ["worker", str(wid), json.dumps(chips)], spool, root, scheduler=fleet,
        config=sup.AutoscalerConfig(min_workers=1, max_workers=3, queue_high=2, queue_sustain=2, owner="pool"),
        telemetry=cap, env={}, run_id="storm",
    )
    scaler._scale_up("min_workers")
    for depth in (5, 5, 5, 1, 9, 9, 9, 9, 9):  # two scale-ups, then denials: the inventory is dry
        spool.depth = depth
        scaler._poll_signals()
    FakeProc.spawned[0].rc = 1  # worker 0 crashes: the same id and lease, the next incarnation
    scaler._reap()
    FakeProc.spawned[1].rc = 0  # worker 1 drains: its lease goes back
    scaler._reap()
    scaler._kill_all("wall_cap")
    spawns = [(p.argv, {k: p.env.get(k) for k in ENV_KEYS}) for p in FakeProc.spawned]
    counters = (scaler.scale_ups, scaler.scale_downs, scaler.denied, scaler.spawned_total, scaler.workers_peak)
    records = [e.record() for e in cap.events]
    return spawns, counters, records, fleet.leased("pool"), fleet._free


def test_autoscaler_decisions_match_the_jax_autoscaler(tmp_path, monkeypatch):
    got = _decisions(sup_mod, sched_mod, str(tmp_path / "port"), monkeypatch)
    want = _decisions(jsup, jsched, str(tmp_path / "jax"), monkeypatch)
    assert got == want
    spawns, counters, records, leased, free = got
    assert [s[0] for s in spawns] == [["worker", "0", "[0]"], ["worker", "1", "[1]"], ["worker", "0", "[0]"]]
    assert [s[1]["RESILIENCE_INCARNATION"] for s in spawns] == ["0", "0", "1"]
    assert {s[1]["RESILIENCE_WORLD"] for s in spawns} == {"3"}
    # a denial at every poll of the sustained backlog once the inventory is dry
    assert counters == (2, 2, 4, 3, 2) and leased == [] and free == [0, 1]
    kinds = [(r["event"], r.get("direction") or r.get("reason")) for r in records]
    assert kinds == [
        ("schedule", "min_workers"), ("autoscale", "up"), ("schedule", "queue_depth"), ("autoscale", "up"),
        *[("autoscale", "denied")] * 4, ("schedule", "release"), ("autoscale", "down"), ("schedule", "release"),
        ("autoscale", "down"),
    ]


def _wind_down_with_a_late_alert(sup, sched, events, root, monkeypatch):
    """One worker that drains at once, and an SLO-burn alert that reaches
    the live plane only in the last drain after the pool has wound down."""
    FakeProc.spawned = []
    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    cap, spool = Capture(), ScriptedSpool()
    spool.drained = lambda: True
    fleet = sched.FleetScheduler(sched.JobSpool(os.path.join(root, "jobs")), sched.FleetConfig(n_devices=2),
                                 telemetry=cap)
    scaler = sup.ServingAutoscaler(
        lambda wid, chips: ["worker", str(wid)], spool, root, scheduler=fleet,
        config=sup.AutoscalerConfig(poll_s=0.0, owner="pool"), telemetry=cap, env={}, run_id="storm",
    )
    late = [events.AlertEvent(alert="slo_burn", severity="warn", value=3.0, threshold=1.5)]
    polls = []

    def poll():
        polls.append(len(FakeProc.spawned))
        # every worker spawned so far exits 0 at its first poll
        for p in FakeProc.spawned:
            p.rc = 0
        return late if len(polls) > 1 and late and not scaler._workers else []

    monkeypatch.setattr(scaler._aggregator, "poll", poll)
    summary = scaler.run()
    return summary, len(FakeProc.spawned), fleet.leased("pool")


def test_last_drain_starts_no_worker(tmp_path, monkeypatch):
    """A pinned difference: the autoscaler's last drain of the live plane,
    after the pool has drained and wound down, records a late SLO-burn
    alert; the JAX package's also scales up on it, spawning a worker nobody
    reaps and leaving its chip leased (seen on the card's serving storm)."""
    import network_distributed_pytorch_tpu.observe.events as jevents

    from network_distributed_pytorch_tpu_torch.observe import events

    summary, spawned, leased = _wind_down_with_a_late_alert(sup_mod, sched_mod, events, str(tmp_path / "p"),
                                                            monkeypatch)
    assert (summary["scale_ups"], spawned, leased, summary["drained"]) == (1, 1, [], True)
    assert os.path.exists(os.path.join(tmp_path, "p", "alerts.jsonl"))  # the alert is still recorded
    jsummary, jspawned, jleased = _wind_down_with_a_late_alert(jsup, jsched, jevents, str(tmp_path / "j"),
                                                               monkeypatch)
    assert (jsummary["scale_ups"], jspawned, jleased) == (2, 2, [0])


def _drained_spool_under_a_stale_burn(sup, sched, events, root, monkeypatch):
    """The spool is drained, but the live plane's p99 still burns: an
    SLO-burn alert at every poll while the last worker takes three polls
    to exit."""
    FakeProc.spawned = []
    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    cap, spool = Capture(), ScriptedSpool()
    spool.drained = lambda: True
    fleet = sched.FleetScheduler(sched.JobSpool(os.path.join(root, "jobs")), sched.FleetConfig(n_devices=3),
                                 telemetry=cap)
    scaler = sup.ServingAutoscaler(
        lambda wid, chips: ["worker", str(wid)], spool, root, scheduler=fleet,
        config=sup.AutoscalerConfig(poll_s=0.0, cooldown_s=0.0, owner="pool", max_wall_s=5.0), telemetry=cap,
        env={}, run_id="storm",
    )
    polls = []

    def poll():
        polls.append(1)
        if len(polls) >= 3:  # from the third poll on, every worker drains
            for p in FakeProc.spawned:
                p.rc = 0
        return [events.AlertEvent(alert="slo_burn", severity="warn", value=3.0, threshold=1.5)]

    monkeypatch.setattr(scaler._aggregator, "poll", poll)
    summary = scaler.run()
    return summary["scale_ups"], len(FakeProc.spawned), fleet.leased("pool")


def test_a_drained_spool_starts_no_worker(tmp_path, monkeypatch):
    """A pinned difference: once the spool is drained, a burning p99 (the
    requests' latencies outlive the demand) starts no worker; the JAX
    package's autoscaler spawns on it. Seen in a loaded run of the storm
    below, whose pool respawned and drained 32 times until its wall cap."""
    import network_distributed_pytorch_tpu.observe.events as jevents

    from network_distributed_pytorch_tpu_torch.observe import events

    assert _drained_spool_under_a_stale_burn(sup_mod, sched_mod, events, str(tmp_path / "p"), monkeypatch) == (
        1, 1, [])
    ups, spawned, leased = _drained_spool_under_a_stale_burn(jsup, jsched, jevents, str(tmp_path / "j"),
                                                             monkeypatch)
    assert ups > 1 and spawned > 1


@pytest.mark.parametrize("bad", [dict(min_workers=0), dict(min_workers=3, max_workers=2)])
def test_autoscaler_refuses_bad_bounds_alike(tmp_path, bad):
    with pytest.raises(ValueError):
        ServingAutoscaler(lambda w, c: ["x"], ScriptedSpool(), str(tmp_path / "p"), config=AutoscalerConfig(**bad))
    with pytest.raises(ValueError):
        jsup.ServingAutoscaler(lambda w, c: ["x"], ScriptedSpool(), str(tmp_path / "j"),
                               config=jsup.AutoscalerConfig(**bad))


def test_autoscaler_config_defaults_match():
    assert AutoscalerConfig().__dict__ == jsup.AutoscalerConfig().__dict__


STORM_SLO_S = 0.9


@pytest.fixture(scope="module")
def storm(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("storm"))
    spool_dir = os.path.join(root, "spool")
    burst = poisson_workload(WorkloadConfig(n_requests=48, rate_rps=70.0, max_new_tokens=(6, 12), seed=112))
    trickle = poisson_workload(WorkloadConfig(n_requests=8, rate_rps=4.0, max_new_tokens=(6, 12), seed=113))
    for r in trickle:
        r.request_id = "tail-" + r.request_id
        r.arrival_s += 2.5
    workload = burst + trickle
    spool = FileSpool(spool_dir)
    # the whole storm manifested up front, each request enqueued at its
    # arrival time: an open-loop offered load
    _atomic_write(os.path.join(spool.root, MANIFEST), {"request_ids": sorted(r.request_id for r in workload)})

    def feed():
        t0 = time.monotonic()
        for r in sorted(workload, key=lambda q: q.arrival_s):
            dt = r.arrival_s - (time.monotonic() - t0)
            if dt > 0:
                time.sleep(dt)
            spool.ensure([r])

    def argv(worker_id, device_ranks):
        return [
            sys.executable, TOY_SERVE, "--rank", str(worker_id), "--world", "3", "--spool-dir", spool_dir,
            "--result-dir", os.path.join(root, "results"), "--slots", "2", "--step-seconds", "0.03", "--paged",
            "--block-len", "4", "--pool-blocks", "12", "--max-wall-s", "60",
        ]

    telemetry = telemetry_for_run(event_log=os.path.join(root, runlog.SUPERVISOR_LOG), stdout=False)
    sched = FleetScheduler(JobSpool(os.path.join(root, "jobs")), config=FleetConfig(n_devices=4), telemetry=telemetry)
    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    summary = ServingAutoscaler(
        argv, spool, root, scheduler=sched,
        config=AutoscalerConfig(
            min_workers=1, max_workers=3, chips_per_worker=1, poll_s=0.05, queue_high=24, queue_sustain=4,
            cooldown_s=0.8, burn_sustain=1, term_grace_s=2.0, max_wall_s=60.0,
            detector_config=DetectorConfig(slo_target_s=STORM_SLO_S, slo_sustain=1, cooldown=1),
            owner="storm-pool",
        ),
        telemetry=telemetry, log_dir=os.path.join(root, "logs"),
    ).run()
    feeder.join(timeout=30)
    telemetry.close()
    events = []
    for name in sorted(os.listdir(root)):
        if name.endswith(".jsonl"):
            events += runlog.load_shard(os.path.join(root, name))[0]
    return {"summary": summary, "spool": spool, "sched": sched, "events": events, "burst": burst,
            "trickle": trickle}


def test_storm_grows_drains_and_loses_nothing(storm):
    s = storm["summary"]
    assert s["drained"] and s["workers_peak"] >= 2 and s["scale_ups"] >= 2, s
    assert s["scale_downs"] == s["spawned_total"]
    spool = storm["spool"]
    assert set(spool.manifest_ids()) == set(spool.done_ids())
    assert storm["sched"].leased("storm-pool") == []


def test_storm_event_chain(storm):
    events = storm["events"]
    ups = [e for e in events if e.get("event") == "autoscale" and e.get("direction") == "up"]
    downs = [e for e in events if e.get("event") == "autoscale" and e.get("direction") == "down"]
    leases = [e for e in events if e.get("event") == "schedule" and e.get("planner") == "lease"]
    assert len(ups) >= 2 and any(d.get("reason") == "drained" for d in downs)
    assert len([e for e in leases if e["world"] >= 1]) >= 2
    assert len([e for e in leases if e["world"] == 0]) == len([e for e in leases if e["world"] >= 1])
    # every scale-up ran on a chip of its own
    held = [e["device_ranks"] for e in ups]
    assert all(len(r) == 1 for r in held)


def test_storm_serves_each_request_once(storm):
    finished = {}
    for e in storm["events"]:
        if e.get("event") == "request" and e.get("state") == "finished":
            finished[e["request_id"]] = finished.get(e["request_id"], 0) + 1
    assert sorted(finished) == storm["spool"].manifest_ids()
    assert set(finished.values()) == {1}
    # the burst breached the SLO (that is what a storm is)
    assert max(e["total_s"] for e in storm["events"] if e.get("event") == "request"
               and not e["request_id"].startswith("tail-")) > STORM_SLO_S
