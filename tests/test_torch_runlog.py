"""The port's run directory (``observe/runlog.py``) against the JAX
package's.

A run directory must read the same in both packages: each package's
manifest is written by one and read by the other, file for file; the
``run_start`` marker and the shard path come from the same environment;
``read_shard_from`` consumes the same lines and offsets (a torn tail left
unread, undecodable lines counted, a truncated file read from the start);
and ``merge_run`` gives the same timeline, record for record, on seeded
shards with a skewed clock, a restarted rank, a torn tail and a missing
shard. ``telemetry_for_run`` leads a managed rank's shard with the marker,
byte for byte the JAX package's, and leaves an unmanaged run's log as it
was. Events are JSON records, compared exactly.
"""

import json
import os

import numpy as np
import pytest

from network_distributed_pytorch_tpu.observe import runlog as jrunlog
from network_distributed_pytorch_tpu.observe import telemetry as jtelemetry
from network_distributed_pytorch_tpu_torch.observe import runlog
from network_distributed_pytorch_tpu_torch.observe import telemetry


def test_constants_are_the_jax_packages():
    for name in ("ENV_RUN_DIR", "ENV_RUN_ID", "MANIFEST_NAME", "SUPERVISOR_LOG", "ALERTS_LOG", "METRICS_PORT_NAME",
                 "SCHEMA", "_ENV_RANK", "_ENV_WORLD", "_ENV_INCARNATION"):
        assert getattr(runlog, name) == getattr(jrunlog, name), name
    for rank in (0, 3, 17):
        assert runlog.shard_name(rank) == jrunlog.shard_name(rank)
        assert runlog.shard_path("/r/d", rank) == jrunlog.shard_path("/r/d", rank)
    for d in ("runs/r7", "runs/r7/", "/", "x"):
        assert runlog.default_run_id(d) == jrunlog.default_run_id(d)


def _manifest(mod):
    m = mod.RunManifest(run_id="runA", world_size=2, created_unix=1234.5)
    m.record_spawn(rank=0, incarnation=0, world_size=2, spawned_unix=100.0)
    m.record_spawn(rank=1, incarnation=0, world_size=2, spawned_unix=100.5)
    m.record_spawn(rank=1, incarnation=1, world_size=2, spawned_unix=103.0)
    return m


@pytest.mark.parametrize("writer,reader", [(runlog, jrunlog), (jrunlog, runlog)])
def test_manifest_written_by_one_read_by_the_other(tmp_path, writer, reader):
    a, b = tmp_path / "a", tmp_path / "b"
    _manifest(writer).save(str(a))
    back = reader.RunManifest.load(str(a))
    assert (back.run_id, back.world_size, back.created_unix) == ("runA", 2, 1234.5)
    assert back.shards == {0: "events_rank0.jsonl", 1: "events_rank1.jsonl"}
    assert back.incarnations == {0: 1, 1: 2}
    assert back.spawn_time(1, 1) == 103.0 and back.spawn_time(1, 7) is None
    # saved again by the reader: the same file
    back.save(str(b))
    assert (a / "run.json").read_bytes() == (b / "run.json").read_bytes()
    _manifest(reader).save(str(b))
    assert (a / "run.json").read_bytes() == (b / "run.json").read_bytes()


def test_marker_and_shard_from_env(tmp_path):
    env = {
        runlog.ENV_RUN_DIR: str(tmp_path), runlog.ENV_RUN_ID: "runB", "RESILIENCE_RANK": "3",
        "RESILIENCE_WORLD": "4", "RESILIENCE_INCARNATION": "1",
    }
    got, want = runlog.run_marker_from_env(env), jrunlog.run_marker_from_env(env)
    assert got.record() == want.record()
    assert (got.run_id, got.rank, got.world_size, got.incarnation) == ("runB", 3, 4, 1)
    assert runlog.shard_event_log_from_env(env) == jrunlog.shard_event_log_from_env(env) == str(
        tmp_path / "events_rank3.jsonl"
    )
    for partial in ({}, {runlog.ENV_RUN_DIR: "d"}, {runlog.ENV_RUN_ID: "x", "RESILIENCE_RANK": "no"}):
        m, jm = runlog.run_marker_from_env(partial), jrunlog.run_marker_from_env(partial)
        assert (m is None) == (jm is None) and (m is None or m.record() == jm.record())
        assert runlog.shard_event_log_from_env(partial) == jrunlog.shard_event_log_from_env(partial)


def _freeze(monkeypatch, t=1000.25, mono=50.5):
    for mod in (telemetry, jtelemetry):
        monkeypatch.setattr(mod.time, "time", lambda: t)
        monkeypatch.setattr(mod.time, "monotonic", lambda: mono)


def test_telemetry_for_run_leads_a_managed_shard_with_the_marker(tmp_path, monkeypatch):
    _freeze(monkeypatch)
    monkeypatch.setenv(runlog.ENV_RUN_ID, "runC")
    monkeypatch.setenv("RESILIENCE_RANK", "1")
    monkeypatch.setenv("RESILIENCE_WORLD", "2")
    monkeypatch.setenv("RESILIENCE_INCARNATION", "0")
    for mod, name in ((telemetry, "port.jsonl"), (jtelemetry, "jax.jsonl")):
        mod.telemetry_for_run(event_log=str(tmp_path / name), stdout=False).close()
    port, jax = (tmp_path / "port.jsonl").read_bytes(), (tmp_path / "jax.jsonl").read_bytes()
    assert port == jax
    (rec,) = [json.loads(line) for line in port.splitlines()]
    assert (rec["event"], rec["kind"], rec["run_id"], rec["rank"]) == ("marker", "run_start", "runC", 1)
    # banners only: no marker (there is no shard to lead)
    assert telemetry.telemetry_for_run(stdout=False).sinks == []


def test_an_unmanaged_run_writes_no_marker(tmp_path, monkeypatch):
    monkeypatch.delenv(runlog.ENV_RUN_ID, raising=False)
    telemetry.telemetry_for_run(event_log=str(tmp_path / "e.jsonl"), stdout=False).close()
    assert (tmp_path / "e.jsonl").read_bytes() == b""


# ---- shards -------------------------------------------------------------------------


def test_read_shard_from_torn_tail_offsets_and_truncation(tmp_path):
    path = str(tmp_path / "s.jsonl")
    lines = [json.dumps({"event": "step", "step": i}) for i in range(3)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\nnot json\n[1, 2]\n" + '{"event": "step", "st')
    got, want = runlog.read_shard_from(path, 0), jrunlog.read_shard_from(path, 0)
    assert got == want
    events, offset, skipped = got
    assert [e["step"] for e in events] == [0, 1, 2] and skipped == 2
    assert offset == os.path.getsize(path) - len('{"event": "step", "st')
    # the tail completes: the next read takes it, and only it
    with open(path, "a") as f:
        f.write('ep": 3}\n')
    assert runlog.read_shard_from(path, offset) == jrunlog.read_shard_from(path, offset)
    assert [e["step"] for e in runlog.read_shard_from(path, offset)[0]] == [3]
    # a file shorter than the offset is read from its start
    with open(path, "w") as f:
        f.write(lines[0] + "\n")
    assert runlog.read_shard_from(path, offset) == jrunlog.read_shard_from(path, offset)
    assert runlog.read_shard_from(path, offset)[1] == len(lines[0]) + 1
    # no complete line yet
    with open(path, "w") as f:
        f.write('{"a"')
    assert runlog.read_shard_from(path, 0) == jrunlog.read_shard_from(path, 0) == ([], 0, 0)
    assert runlog.load_shard(path) == jrunlog.load_shard(path) == ([], 1)


# ---- the merge ----------------------------------------------------------------------


def _seeded_run(root, seed=3, world=3, skew=(0.0, 3.0, -1.5)):
    """A run directory of ``world`` ranks from a seed: each rank's clock off
    by ``skew[r]`` seconds, steps of random length, rank 1 restarted once
    (a second marker and incarnation), rank 0's last line torn, the last
    rank's shard never written, and the supervisor's own log."""
    rng = np.random.RandomState(seed)
    m = runlog.new_manifest("seeded", world_size=world)
    m.created_unix = 999.0
    spawns = {}
    for r in range(world):
        spawns[(r, 0)] = 1000.0 + 0.01 * r
        m.record_spawn(rank=r, incarnation=0, world_size=world, spawned_unix=spawns[(r, 0)])
    spawns[(1, 1)] = 1004.0
    m.record_spawn(rank=1, incarnation=1, world_size=world, spawned_unix=spawns[(1, 1)])
    m.save(str(root))
    for r in range(world - 1):
        recs = []
        for inc in (0, 1) if r == 1 else (0,):
            startup = 0.2 + 0.01 * rng.rand()
            wall = spawns[(r, inc)] + startup + skew[r]
            mono = 100.0 * (r + 1) + 10.0 * inc
            recs.append({"event": "marker", "kind": "run_start", "run_id": "seeded", "rank": r, "world_size": world,
                         "incarnation": inc, "ts": wall, "ts_mono": mono})
            for i in range(6):
                dt = float(0.05 + 0.02 * rng.rand())
                wall, mono = wall + dt, mono + dt
                rec = {"event": "step", "step": i, "epoch": 0, "loss": float(rng.rand()), "step_time_s": dt,
                       "bits_cumulative": 8 * (i + 1), "valid": True, "ts": wall, "ts_mono": mono}
                if i == 4:
                    del rec["ts_mono"]  # a record without the monotonic clock: the offset's fallback
                recs.append(rec)
        with open(runlog.shard_path(str(root), r), "w") as f:
            f.write("".join(json.dumps(e) + "\n" for e in recs))
            if r == 0:
                f.write('{"event": "step", "step": 6, "ts": 1')
    with open(os.path.join(str(root), runlog.SUPERVISOR_LOG), "w") as f:
        for t, kind in ((1000.0, "run_start"), (1003.9, "worker_restart"), (1006.0, "run_complete")):
            f.write(json.dumps({"event": "failure", "kind": kind, "label": "supervisor", "ts": t}) + "\n")


def test_merge_run_is_the_jax_merge(tmp_path):
    _seeded_run(tmp_path)
    got, want = runlog.merge_run(str(tmp_path)), jrunlog.merge_run(str(tmp_path))
    assert got.events == want.events
    assert got.per_rank == want.per_rank
    assert (got.torn_lines, got.startup_s, got.clock_skew_bound_s) == (
        want.torn_lines, want.startup_s, want.clock_skew_bound_s)
    assert got.torn_lines == 1 and got.per_rank[2]["missing"] is True
    assert got.per_rank[1]["markers"] == 2
    # the skew is found: rank 1's clock reads about 3 s ahead of rank 0's
    assert abs(got.per_rank[1]["clock_offset_s"] - got.per_rank[0]["clock_offset_s"] - 3.0) < 0.05
    steps = [e for e in got.events if e.get("event") == "step"]
    assert all(e["t_run"] is not None for e in steps)
    assert [e["t_run"] for e in got.events if e["t_run"] is not None] == sorted(
        e["t_run"] for e in got.events if e["t_run"] is not None)
    # a manifest handed in gives the same merge
    again = runlog.merge_run(str(tmp_path), manifest=runlog.RunManifest.load(str(tmp_path)))
    assert again.events == got.events
