"""The port's live telemetry plane (``observe/live.py``), its analytics
(``observe/analytics.py``) and the per-edge fabric model
(``utils/bandwidth.py``) against the JAX package's, on the same inputs.

- analytics: ``percentile``, ``rank_step_stats`` and ``detect_stragglers``
  (the ``StragglerEvent`` records) on one seeded event list;
  ``effective_bandwidth`` over a replicated ledger with an overlap
  extract, with and without a per-edge matrix. The fabric rows are each
  package's own (the port's ``NVLink4(H100)``, the JAX package's
  ``ICI(v5e)``): the two agree exactly on the rows both have (1, 10 and 100
  GbE), and each side's labels are pinned.
- ``MetricRegistry``: its snapshot and Prometheus text after the same
  ``ingest_record`` stream (every event kind the derivation knows), the
  text without its one wall-clock line; ``MetricSink`` through each
  package's ``Telemetry``.
- ``ShardFollower``: a torn tail, undecodable lines, a resume from a
  persisted offset and a truncated file.
- ``LiveAggregator``: its gauges and fired alerts on one seeded run
  directory (markers, a skewed clock, a restart, the ledger, the overlap
  extract, comm spans over a ring, a grad spike, fidelity, memory, a
  partition, serving requests) against the JAX aggregator's; an offsets
  round trip with no double count.
- ``MetricsHTTPServer`` scraped on port 0 over loopback, and
  ``read_port_file``; the ``alerts.jsonl`` feed written by one package
  and read by the other.
- ``serve_gpt``'s ``live_requests_total`` from its metric registry.

Records are compared exactly.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from network_distributed_pytorch_tpu.observe import Telemetry as JaxTelemetry
from network_distributed_pytorch_tpu.observe import analytics as janalytics
from network_distributed_pytorch_tpu.observe import events as jevents
from network_distributed_pytorch_tpu.observe import live as jlive
from network_distributed_pytorch_tpu.observe import runlog as jrunlog
from network_distributed_pytorch_tpu.utils import bandwidth as jbandwidth
from network_distributed_pytorch_tpu_torch.observe import Telemetry, analytics, events, live, runlog
from network_distributed_pytorch_tpu_torch.utils import bandwidth

SHARED_FABRICS = ("1GbE", "10GbE", "100GbE")


# ---- analytics ----------------------------------------------------------------------


def _step_events(seed=5, world=4, n=12, slow_rank=2):
    rng = np.random.RandomState(seed)
    evs = []
    for r in range(world):
        for i in range(n):
            dt = float(0.05 * (1 + 0.1 * rng.rand()) * (2.5 if r == slow_rank else 1.0))
            evs.append({"event": "step", "rank": r, "step": i, "step_time_s": dt, "valid": bool(i != 3)})
    evs.append({"event": "step", "rank": None, "step_time_s": 1.0})
    evs.append({"event": "step", "rank": 0, "step_time_s": "x"})
    return evs


def test_percentile_step_stats_and_stragglers():
    rng = np.random.RandomState(1)
    for n in (0, 1, 2, 7, 100):
        vals = list(rng.rand(n))
        for p in (0, 50, 95, 99, 100):
            a, b = analytics.percentile(vals, p), janalytics.percentile(vals, p)
            assert a == b or (a != a and b != b)
    evs = _step_events()
    for drop in (True, False):
        assert analytics.rank_step_stats(evs, drop) == janalytics.rank_step_stats(evs, drop)
    stats = analytics.rank_step_stats(evs)
    for factor, min_steps in ((1.5, 2), (1.1, 2), (5.0, 2), (1.5, 50)):
        got = [e.record() for e in analytics.detect_stragglers(stats, factor, min_steps)]
        want = [e.record() for e in janalytics.detect_stragglers(stats, factor, min_steps)]
        assert got == want
    (straggler,) = analytics.detect_stragglers(stats)
    assert straggler.rank == 2
    assert analytics.detect_stragglers({0: stats[0]}) == []


def _ledger():
    base = {"label": "exact_cifar10", "op": "all-reduce", "dtype": "float32"}
    recs = []
    for rank in range(3):  # each rank's shard repeats the same ledger
        recs += [
            {**base, "tag": "grads", "payload_bytes": 94_114_092, "count": 4, "rank": rank},
            {**base, "tag": "loss-sync", "payload_bytes": 4, "rank": rank},
            {**base, "tag": "powersgd.P", "payload_bytes": 758_000.0, "count": 2, "rank": rank},
        ]
    recs.append({**base, "tag": "bad", "payload_bytes": None})
    return recs


OVERLAP = {"n_async_collectives": 4, "n_overlapped": 3, "n_sync_collectives": 3, "n_sync_gaps_with_compute": 1}
MATRIX = {"edges": [
    {"src": 0, "dst": 1, "bytes_per_s": 5e9, "latency_s": 2e-6},
    {"src": 1, "dst": 2, "bytes_per_s": 2e9},
    {"src": 2, "dst": 0, "bytes_per_s": -1.0},
    {"src": "x", "dst": 0, "bytes_per_s": 1e9},
    "junk",
]}


@pytest.mark.parametrize("overlap", [None, OVERLAP])
@pytest.mark.parametrize("matrix", [None, MATRIX, {"edges": "junk"}, "junk"])
def test_effective_bandwidth_agrees_on_the_shared_fabric_rows(overlap, matrix):
    args = (0.125, _ledger(), 3)
    got = analytics.effective_bandwidth(*args, overlap=overlap, fabrics=SHARED_FABRICS, matrix=matrix)
    want = janalytics.effective_bandwidth(*args, overlap=overlap, fabrics=SHARED_FABRICS, matrix=matrix)
    assert got == want
    # every row by default: each package's own table, equal where they meet
    got = analytics.effective_bandwidth(*args, overlap=overlap, matrix=matrix)
    want = janalytics.effective_bandwidth(*args, overlap=overlap, matrix=matrix)
    assert sorted(got["total"]["utilization"]) == sorted(bandwidth.FABRICS_BYTES_PER_S)
    assert sorted(want["total"]["utilization"]) == sorted(jbandwidth.FABRICS_BYTES_PER_S)
    assert "NVLink4(H100)" in got["total"]["utilization"] and "ICI(v5e)" in want["total"]["utilization"]
    for view in ("utilization", "modeled_comm_s"):
        for f in SHARED_FABRICS:
            assert got["total"][view][f] == want["total"][view][f]
    assert got["total"]["achieved_bytes_per_s"] == want["total"]["achieved_bytes_per_s"]
    assert len(got["by_tag"]) == 3


def test_effective_bandwidth_degenerate_inputs():
    for args in ((0.1, [], 2), (0.0, _ledger(), 2), (None, _ledger(), 2), (0.1, [{"payload_bytes": "x"}], 2)):
        assert analytics.effective_bandwidth(*args) is None is janalytics.effective_bandwidth(*args)


def test_fabric_model_is_the_jax_model_on_the_shared_rows():
    for w in range(5):
        assert bandwidth.ring_neighbors(w) == jbandwidth.ring_neighbors(w)
    for matrix in (None, MATRIX, {"edges": []}, {"edges": "junk"}, [1, 2]):
        m, jm = bandwidth.fabric_model(matrix), jbandwidth.fabric_model(matrix)
        assert [vars(e) for e in m.edges] == [vars(e) for e in jm.edges]
        assert m.per_edge == jm.per_edge
        for f in SHARED_FABRICS:
            assert (m.ring_beta(f), m.ring_latency_s(f), m.bytes_per_s(f), m.latency_s(f)) == (
                jm.ring_beta(f), jm.ring_latency_s(f), jm.bytes_per_s(f), jm.latency_s(f))
            for n, k in ((1, 1), (4, 3), (8, 1)):
                assert m.allreduce_time_s(1e8, n, f, k) == jm.allreduce_time_s(1e8, n, f, k)
    # a malformed matrix degrades to the scalar tables
    assert bandwidth.fabric_model({"edges": [{"src": 0}]}).ring_beta("NVLink4(H100)") == 450e9
    m = bandwidth.fabric_model(MATRIX)
    assert (m.bottleneck().src, m.ring_beta("NVLink4(H100)"), m.ring_latency_s("10GbE")) == (1, 2e9, 30e-6)
    # without a matrix, the model's ring time is the scalar function's
    assert bandwidth.fabric_model().allreduce_time_s(1e8, 4, "10GbE", 3) == bandwidth.allreduce_time_s(1e8, 4, "10GbE", 3)


# ---- the registry -------------------------------------------------------------------


def _records(seed=3):
    """One of each record kind the derivation knows, and some it does not,
    with seeded values."""
    rng = np.random.RandomState(seed)
    u = lambda: float(rng.rand())  # noqa: E731
    out = []
    for i in range(6):
        r = i % 2
        out += [
            {"event": "step", "step": i, "step_time_s": u(), "loss": u(), "rank": r, "valid": i != 2},
            {"event": "collective", "tag": f"t{i % 3}", "payload_bytes": int(1000 * u())},
            {"event": "train_health", "grad_norm": u(), "ef_memory_norm": u(), "powersgd_rel_error": u(), "rank": r},
            {"event": "fidelity", "group": f"g{i % 2}", "rel_error": u(), "ef_norm": u(), "ef_growth": u(),
             "cosine_sim": u(), "replica_drift": u(), "anchor_drift": u(), "rank": r},
            {"event": "memory", "bytes_in_use": 1e9 * u(), "peak_bytes_in_use": 2e9, "bytes_limit": 8e10},
            {"event": "request", "state": "finished" if i % 3 else "evicted", "total_s": u(), "queue_s": u(),
             "decode_s": u(), "tokens_generated": 1 + i},
            {"event": "kv_pool", "blocks_free": 10 - i, "blocks_used": i, "blocks_shared": 1, "pool_bytes": 4096,
             "prefix_hits_total": i, "cow_copies_total": 0, "admissions_deferred_total": 2},
            {"event": "autoscale", "direction": "up", "reason": "slo", "workers": 1 + i},
            {"event": "alert", "alert": "grad_spike", "severity": "critical" if i % 2 else "warn"},
            {"event": "failure", "kind": "worker_exit"},
            {"event": "job", "state": ["started", "resumed", "parked", "completed"][i % 4], "kind": "train",
             "job_id": f"j{i % 2}", "world": 2},
            {"event": "partition", "phase": ["partitioned", "local", "rejoin"][i % 3], "local_steps": i,
             "max_local_steps": 8, "rank": r},
            {"event": "preempt", "reason": "slo"},
            {"event": "job_failed", "kind": "serve"},
            {"event": "marker", "kind": "run_start"},
        ]
    return out


def _without_scrape_time(text):
    return [line for line in text.splitlines() if "live_scrape_unix_time" not in line]


def test_registry_snapshot_and_prometheus_text_are_the_jax_registrys():
    reg, jreg = live.MetricRegistry(), jlive.MetricRegistry()
    for rec in _records():
        live.ingest_record(reg, rec, rank=7)
        jlive.ingest_record(jreg, rec, rank=7)
    assert reg.snapshot() == jreg.snapshot()
    assert _without_scrape_time(reg.render_prometheus()) == _without_scrape_time(jreg.render_prometheus())
    text = reg.render_prometheus()
    assert text.endswith("\n") and "# TYPE live_scrape_unix_time gauge" in text
    assert reg.get_counter("live_serving_requests_total", state="finished") == 4.0
    assert reg.get_histogram("live_step_time_seconds", rank="1").count == 3
    # a rolling window keeps the newest values; the count stays cumulative
    h, jh = live.RollingHistogram(4), jlive.RollingHistogram(4)
    for v in np.random.RandomState(0).rand(11):
        h.observe(v)
        jh.observe(v)
    assert (len(h), h.count, h.total, h.percentile(50), h.percentile(99)) == (
        len(jh), jh.count, jh.total, jh.percentile(50), jh.percentile(99))


def test_metric_sink_rides_each_packages_telemetry():
    sink, jsink = live.MetricSink(), jlive.MetricSink()
    tel, jtel = Telemetry([sink]), JaxTelemetry([jsink])
    for mod, t in ((events, tel), (jevents, jtel)):
        t.emit(mod.StepEvent(step=0, epoch=0, loss=1.0, step_time_s=0.01, bits_cumulative=0))
        t.emit(mod.CollectiveEvent(label="l", tag="t", layer="r", op="all-reduce", axis="data", dtype="float32",
                                   payload_bytes=64))
        t.emit(mod.RequestEvent(request_id="r0", state="finished", total_s=0.5, queue_s=0.1, decode_s=0.3,
                                tokens_generated=6))
        t.close()
    assert sink.registry.snapshot() == jsink.registry.snapshot()
    assert sink.registry.get_counter("live_steps_total", rank="?") == 1.0


# ---- shard following ----------------------------------------------------------------


def _writeln(path, obj, newline=True):
    with open(path, "a") as f:
        f.write((obj if isinstance(obj, str) else json.dumps(obj)) + ("\n" if newline else ""))


def test_shard_follower_is_the_jax_follower(tmp_path):
    path = str(tmp_path / "s.jsonl")
    f, jf = live.ShardFollower(path), jlive.ShardFollower(path)
    assert f.poll() == jf.poll() == []  # no file yet
    _writeln(path, {"event": "step", "step": 0})
    _writeln(path, "not json")
    _writeln(path, {"event": "step", "step": 1})
    _writeln(path, '{"event": "step", "st', newline=False)
    for _ in range(2):
        assert f.poll() == jf.poll()
        assert (f.offset, f.torn) == (jf.offset, jf.torn)
    assert f.torn == 1
    _writeln(path, 'ep": 2}')
    got = f.poll()
    assert got == jf.poll() and [e["step"] for e in got] == [2]
    # a follower resumed from the persisted offset sees only what is new
    _writeln(path, {"event": "step", "step": 3})
    g, jg = live.ShardFollower(path, offset=f.offset), jlive.ShardFollower(path, offset=jf.offset)
    assert g.poll() == jg.poll() == [{"event": "step", "step": 3}]
    # truncated: read from the start
    with open(path, "w") as fh:
        fh.write(json.dumps({"event": "step", "step": 9}) + "\n")
    assert g.poll() == jg.poll() == [{"event": "step", "step": 9}]


# ---- the aggregator -----------------------------------------------------------------


def _seeded_run_dir(root, seed=7, world=3):
    """A live run directory from a seed: ``world`` ranks, rank 2's clock
    3 s ahead, rank 1 restarted once; each rank's shard has the marker, the
    ledger, a compile event with an overlap extract, steps with comm spans,
    grad norms (a spike on rank 0), fidelity, memory and a partition; the
    supervisor's log has a failure and serving requests."""
    rng = np.random.RandomState(seed)
    m = runlog.new_manifest("live", world_size=world)
    m.created_unix = 99.0
    spawns = {(r, 0): 100.0 for r in range(world)}
    spawns[(1, 1)] = 104.0
    for (r, inc), t in sorted(spawns.items(), key=lambda kv: kv[1]):
        m.record_spawn(rank=r, incarnation=inc, world_size=world, spawned_unix=t)
    m.save(str(root))
    for r in range(world):
        path = os.path.join(str(root), runlog.shard_name(r))
        for inc in (0, 1) if r == 1 else (0,):
            skew = 3.0 if r == 2 else 0.0
            wall, mono = spawns[(r, inc)] + 0.3 + 0.01 * rng.rand() + skew, 10.0 * (r + 1) + 100.0 * inc
            _writeln(path, {"event": "marker", "kind": "run_start", "run_id": "live", "rank": r,
                            "world_size": world, "incarnation": inc, "ts": wall, "ts_mono": mono})
            _writeln(path, {"event": "collective", "label": "x", "tag": "grads", "layer": "reducer",
                            "op": "all-reduce", "axis": "data", "dtype": "float32", "payload_bytes": 1 << 22,
                            "ts": wall, "ts_mono": mono})
            _writeln(path, {"event": "compile", "label": "x", "overlap": OVERLAP, "ts": wall, "ts_mono": mono})
            for i in range(20):
                dt = float(0.1 * (1 + 0.05 * rng.randn()))
                wall, mono = wall + dt, mono + dt
                _writeln(path, {"event": "span", "name": "step/comm", "dur_s": 0.3 * dt, "rank": r,
                                "ts": wall, "ts_mono": mono})
                _writeln(path, {"event": "step", "step": i, "epoch": i // 5, "loss": 2.0 / (i + 1),
                                "step_time_s": dt, "bits_cumulative": 8 * (1 << 22) * (i + 1), "valid": True,
                                "ts": wall, "ts_mono": mono})
                gn = 500.0 if (r == 0 and i == 12) else float(1.0 + 0.01 * rng.randn())
                _writeln(path, {"event": "train_health", "step": i, "grad_norm": gn, "rank": r,
                                "ts": wall, "ts_mono": mono})
                _writeln(path, {"event": "fidelity", "group": "g0", "rel_error": 0.9 if i > 15 else 0.02,
                                "ef_norm": 0.1, "rank": r, "step": i, "ts": wall, "ts_mono": mono})
                _writeln(path, {"event": "memory", "bytes_in_use": 6e10 + 1e9 * i, "bytes_limit": 8e10,
                                "rank": r, "step": i, "ts": wall, "ts_mono": mono})
                if i in (8, 9):
                    _writeln(path, {"event": "partition", "phase": "local", "local_steps": 4 * (i - 7),
                                    "max_local_steps": 8, "rank": r, "ts": wall, "ts_mono": mono})
    sup = os.path.join(str(root), runlog.SUPERVISOR_LOG)
    _writeln(sup, {"event": "failure", "kind": "worker_restart", "rank": 1, "ts": 103.9})
    for k in range(8):
        _writeln(sup, {"event": "request", "state": "finished", "total_s": 2.5 + 0.1 * k, "queue_s": 0.1,
                       "decode_s": 1.0, "tokens_generated": 8, "ts": 105.0 + k})
    return str(root)


def _agree(agg, jagg):
    snap, jsnap = agg.registry.snapshot(), jagg.registry.snapshot()
    util, jutil = snap.pop("live_fabric_utilization", {}), jsnap.pop("live_fabric_utilization", {})
    assert snap == jsnap
    for f in SHARED_FABRICS:
        assert util[f'{{fabric="{f}"}}'] == jutil[f'{{fabric="{f}"}}']
    if util:
        assert '{fabric="NVLink4(H100)"}' in util and '{fabric="ICI(v5e)"}' in jutil
    assert [a.record() for a in agg.alerts] == [a.record() for a in jagg.alerts]
    assert agg.step_p50_s() == jagg.step_p50_s()
    assert agg.edge_rates() == jagg.edge_rates()


def test_aggregator_is_the_jax_aggregator(tmp_path):
    run_dir = _seeded_run_dir(tmp_path)
    agg, jagg = live.LiveAggregator(run_dir), jlive.LiveAggregator(run_dir)
    fired, jfired = agg.poll(), jagg.poll()
    assert [a.record() for a in fired] == [a.record() for a in jfired]
    _agree(agg, jagg)
    kinds = {a.alert for a in agg.alerts}
    assert {"grad_spike", "fidelity_collapse", "hbm_headroom", "outer_staleness"} <= kinds, kinds
    (spike,) = [a for a in agg.alerts if a.alert == "grad_spike"]
    assert (spike.severity, spike.rank, spike.step) == ("critical", 0, 12)
    # the live p50 is the report's statistic over the merged run
    merged = runlog.merge_run(run_dir)
    stats = analytics.rank_step_stats(merged.events)
    p50s = [s["p50_s"] for s in stats.values()]
    assert agg.registry.get_gauge("live_step_time_p50_seconds") == pytest.approx(analytics.percentile(p50s, 50))
    assert set(agg.edge_rates()) == {(0, 1), (1, 2), (2, 0)}
    # more events, polled again by both
    for r in range(3):
        _writeln(os.path.join(run_dir, runlog.shard_name(r)), {"event": "step", "step": 20, "step_time_s": 0.2,
                                                               "rank": r, "ts": 200.0, "ts_mono": 300.0})
    assert [a.record() for a in agg.poll()] == [a.record() for a in jagg.poll()]
    _agree(agg, jagg)
    assert agg.poll() == [] and jagg.poll() == []  # idle polls fire nothing


def test_aggregator_offsets_round_trip_without_double_count(tmp_path):
    run_dir = _seeded_run_dir(tmp_path)
    agg = live.LiveAggregator(run_dir)
    agg.poll()
    offsets = os.path.join(run_dir, "offsets.json")
    agg.save_offsets(offsets)
    with open(offsets) as f:
        saved = json.load(f)
    assert set(saved) == {runlog.shard_name(r) for r in range(3)} | {runlog.SUPERVISOR_LOG}
    _writeln(os.path.join(run_dir, runlog.shard_name(0)), {"event": "step", "step": 20, "step_time_s": 0.2,
                                                           "ts": 200.0, "ts_mono": 300.0})
    for mod in (live, jlive):
        follower = mod.LiveAggregator(run_dir)
        follower.load_offsets(offsets)
        follower.poll()
        assert follower.registry.get_counter("live_steps_total", rank="0") == 1.0
        assert follower.registry.get_counter("live_steps_total", rank="1") == 0.0
    live.LiveAggregator(run_dir).load_offsets(os.path.join(run_dir, "absent.json"))


def test_aggregator_takes_the_detector_config(tmp_path):
    from network_distributed_pytorch_tpu_torch.observe.health import DetectorConfig

    agg = live.LiveAggregator(_seeded_run_dir(tmp_path), detector_config=DetectorConfig(nan_factor=1e9))
    agg.poll()
    assert agg.monitor.config.nan_factor == 1e9
    assert [a.severity for a in agg.alerts if a.alert == "grad_spike"] == ["warn"]


# ---- /metrics and the alert feed --------------------------------------------------


def test_metrics_http_server_scrape_and_port_file(tmp_path):
    reg = live.MetricRegistry()
    reg.counter("live_steps_total", 7.0, rank="0")
    assert live.read_port_file(str(tmp_path)) is None
    server = live.MetricsHTTPServer(reg, port=0).start()
    try:
        assert server.host == "127.0.0.1" and server.port > 0
        server.write_port_file(str(tmp_path))
        assert live.read_port_file(str(tmp_path)) == jlive.read_port_file(str(tmp_path)) == server.port
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(f"{base}/metrics?x=1", timeout=5.0) as resp:
            assert resp.status == 200 and resp.headers["Content-Type"].startswith("text/plain; version=0.0.4")
            body = resp.read().decode()
        assert 'live_steps_total{rank="0"} 7.0' in body and "live_scrape_unix_time" in body
        with urllib.request.urlopen(f"{base}/healthz", timeout=5.0) as resp:
            assert resp.status == 200 and resp.read() == b"ok\n"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope", timeout=5.0)
    finally:
        server.close()
    # a render function serves as well as a registry
    server = live.MetricsHTTPServer(lambda: "x 1\n", port=0).start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics", timeout=5.0) as resp:
            assert resp.read() == b"x 1\n"
    finally:
        server.close()


@pytest.mark.parametrize("writer,reader", [(live, jlive), (jlive, live)])
def test_alert_feed_round_trip_across_the_packages(tmp_path, writer, reader):
    run_dir = str(tmp_path)
    feed = reader.AlertFeed(run_dir)
    assert feed.poll() == []  # no channel yet
    writer.append_alert(run_dir, {"event": "alert", "alert": "grad_spike", "severity": "critical", "rank": 0})
    writer.append_alert(run_dir, {"event": "marker", "kind": "noise"})
    assert [(r["alert"], r["severity"]) for r in feed.poll()] == [("grad_spike", "critical")]
    assert feed.poll() == []
    writer.append_alert(run_dir, {"event": "alert", "alert": "slo_burn", "severity": "warn"})
    assert [r["alert"] for r in feed.poll()] == ["slo_burn"]
    with open(os.path.join(run_dir, runlog.ALERTS_LOG)) as f:
        assert len(f.read().splitlines()) == 3
    assert runlog.ALERTS_LOG == jrunlog.ALERTS_LOG


# ---- serve_gpt's registry -----------------------------------------------------------


def test_serve_gpt_counts_finished_requests_in_its_metric_registry(monkeypatch):
    from network_distributed_pytorch_tpu_torch.experiments import serve_gpt

    made = []

    class Kept(live.MetricRegistry):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(serve_gpt, "MetricRegistry", Kept)
    out = serve_gpt.run(preset="small", slots=2, requests=4, request_rate=0.0, max_new_tokens=4, device="cpu")
    (reg,) = made
    assert out["live_requests_total"] == reg.get_counter("live_serving_requests_total", state="finished")
    assert out["live_requests_total"] == out["slo"]["n_finished"] == 4
    assert reg.get_histogram("live_serving_total_seconds").count == 4
