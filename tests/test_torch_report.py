"""``scripts/torch_report.py`` against the JAX package's ``scripts/report.py``.

The report is host arithmetic over the same JSON, so the tolerance is
exact equality. The pinned differences (``tests/torch_report_parity.py``):
``generated_unix``, and the fabric rows (``NVLink4(H100)`` in the port,
``ICI(v5e)`` in the JAX package), which the bandwidth section, its text
lines, the critical path's per-edge lines and the dashboard's ``comm`` line
carry.

The inputs are the port's own: event records made by the port's event
classes (``observe/events.py``), and run directories written through the
port's writers (the manifest through ``observe.runlog``, each shard
through ``observe.sinks.JsonlSink``). The run directories, one a scenario,
together exercise every section of the report:

- ``restart_reshape``: a supervised world of 3; a ``proc_kill`` restarts
  rank 2, then a zone outage kills ranks 1 and 2 and the supervisor
  replans to a world of 1 (failures, restarts, a reshape, MTTR);
- ``adaptive_stall``: a ``comm_stall`` on rank 0, its deadline expiry and
  retry, the fallback ladder's descent and ascent, a straggler, a data
  drop (policy, ``recovery_latency_s``, stragglers, epochs);
- ``live_alert``: the live plane's alerts, a nudge to compress, backward
  buckets (alerts, ``comm_buckets``);
- ``served``: per-request events, two engines' KV pools and a fleet
  scheduler's jobs (``slo``, ``kv_pool``, ``fleet``);
- ``hierarchical``: a world of 4 on two levels, a partition and its
  rejoin (``hierarchy``, ``partitions``);
- ``probed``: the health and fidelity probe and the memory sampler, and
  a descent that splits the frontier (``fidelity``, ``fidelity_frontier``,
  ``memory``);
- ``ragged``: a shard never written, a torn last line, lines that are not
  objects, an unknown kind, records without clocks and ``None`` fields.

Real spawned run directories are held to the JAX report too, in the
files whose module fixtures spawn them (``test_torch_critpath.py``,
``test_torch_live_plane.py``, ``test_torch_scheduler.py``).
"""

import contextlib
import io
import json
import os

import pytest

from network_distributed_pytorch_tpu.observe import analytics as jax_analytics
from network_distributed_pytorch_tpu.observe import fidelity as jax_fidelity
from network_distributed_pytorch_tpu.observe import live as jax_live
from network_distributed_pytorch_tpu.observe import runlog as jax_runlog
from network_distributed_pytorch_tpu_torch.observe import analytics, costmodel, fidelity, live, runlog
from network_distributed_pytorch_tpu_torch.observe.events import (
    AlertEvent,
    CollectiveEvent,
    CompileEvent,
    DataDropEvent,
    EpochEvent,
    FailureEvent,
    FidelityEvent,
    JobEvent,
    KVPoolEvent,
    MarkerEvent,
    MemoryEvent,
    NoteEvent,
    PartitionEvent,
    PolicyEvent,
    PreemptEvent,
    RequestEvent,
    ReshapeEvent,
    ScheduleEvent,
    SpanEvent,
    StepEvent,
    TrainHealthEvent,
)
from network_distributed_pytorch_tpu_torch.observe.sinks import JsonlSink
from torch_report_parity import REPORT_KEYS, assert_key_equal, assert_text_equal, load_script, strip_fabric_row

PORT = load_script("torch_report", "torchreport")
REF = load_script("report", "jaxreport")
MIB = 1 << 20
DROP = object()  # a field the record leaves out


def rec(ev, **fields):
    """``ev``'s record with ``fields`` set (``DROP`` removes one)."""
    out = ev.record()
    out.update(fields)
    return {k: v for k, v in out.items() if v is not DROP}


# ---- run directories through the port's writers ----------------------------------


class RunWriter:
    """A run directory: the manifest through ``observe.runlog``, every
    record an event class's through ``JsonlSink``. Times are on the
    supervisor's clock; a rank's records carry its own wall clock (off by
    ``skew``) and a monotonic clock anchored at its ``run_start`` marker."""

    def __init__(self, run_dir, run_id, world, t0=1000.0):
        self.run_dir, self.run_id, self.world = run_dir, run_id, world
        self.manifest = runlog.new_manifest(run_id, world)
        self.manifest.created_unix = t0 - 1.0
        self.sinks = {}
        self.anchor = {}
        self.sup_sink = JsonlSink(os.path.join(run_dir, runlog.SUPERVISOR_LOG), append=False)
        self.ids = 0

    def _write(self, sink, ev, **fields):
        sink.emit(ev, rec(ev, **fields))

    def spawn(self, rank, incarnation, t, world=None, skew=0.0, write=True):
        world = world or self.world
        self.manifest.record_spawn(rank, incarnation, world, t)
        if not write:
            return
        startup = 0.25 + 0.01 * rank + 0.002 * incarnation
        mono = 100.0 * (rank + 1) + 10.0 * incarnation
        self.anchor[rank] = (t + startup, mono, skew)
        if rank not in self.sinks:
            self.sinks[rank] = JsonlSink(runlog.shard_path(self.run_dir, rank), append=False)
        marker = MarkerEvent(kind="run_start", run_id=self.run_id, rank=rank, world_size=world, incarnation=incarnation)
        self._write(self.sinks[rank], marker, ts=t + startup + skew, ts_mono=mono)

    def at(self, rank, t, ev, **fields):
        base, mono, skew = self.anchor[rank]
        fields = {"ts": t + skew, "ts_mono": mono + (t - base), **fields}
        self._write(self.sinks[rank], ev, **fields)

    def sup(self, t, ev, **fields):
        self._write(self.sup_sink, ev, **{"ts": t, **fields})

    def raw(self, rank, line):
        self.sinks[rank].stream.write(line)

    def span_id(self):
        self.ids += 1
        return self.ids

    def close(self):
        self.manifest.save(self.run_dir)
        for sink in (*self.sinks.values(), self.sup_sink):
            sink.close()


def compile_record(label="toy", flops=2.0e9, tags=(("grads", 4 * MIB, 1), ("loss-sync", 4, 1)), **extra):
    analytic = sum(b for _, b, _ in tags)
    return CompileEvent(
        label=label, analytic_bytes=analytic, hlo_bytes=analytic, delta_bytes=0, exact=True,
        hlo_collective_count=len(tags), hlo_by_kind={"all-reduce": len(tags)}, dense_grad_bytes=4 * MIB,
        compression_ratio=None, overlap={}, flops_per_step=flops, flops_source="flop_counter", device_kind="cpu",
        peak_flops_per_s=1.0e12, comm_config={"reducer": "exact", "comm_chunks": 1}, **extra,
    )


def train(w, rank, t, steps, step_s=0.02, comm_s=0.0, data_s=0.002, epoch_len=4, loss0=2.0,
          tags=(("grads", 4 * MIB, 1), ("loss-sync", 4, 1)), label="toy", audit_step=0):
    """``steps`` on ``rank`` from ``t``: a ``data_load`` span, the step's
    container with ``step/compute`` (and ``step/comm``) under it, the
    ``StepEvent``; the audit's compile record and collectives after step
    ``audit_step``. Returns the time after the last step."""
    bits_per_step = 8 * sum(b for _, b, _ in tags)
    for s in steps:
        dur = step_s(rank, s) if callable(step_s) else step_s
        t += data_s
        w.at(rank, t, SpanEvent(name="data_load", span_id=w.span_id(), parent_id=None, depth=0, dur_s=data_s,
                                step=s, rank=rank))
        cid = w.span_id()
        w.at(rank, t + dur - comm_s, SpanEvent(name="step/compute", span_id=w.span_id(), parent_id=cid, depth=1,
                                               dur_s=dur - comm_s, step=s, rank=rank))
        if comm_s:
            w.at(rank, t + dur, SpanEvent(name="step/comm", span_id=w.span_id(), parent_id=cid, depth=1,
                                          dur_s=comm_s, step=s, rank=rank))
        t += dur
        w.at(rank, t, SpanEvent(name="step", span_id=cid, parent_id=None, depth=0, dur_s=dur, step=s, rank=rank))
        w.at(rank, t, StepEvent(step=s, epoch=s // epoch_len, loss=loss0 * 0.9 ** s, step_time_s=dur,
                                bits_cumulative=bits_per_step * (s + 1)))
        if s == audit_step:
            w.at(rank, t, compile_record(label=label, tags=tags))
            for tag, nbytes, count in tags:
                w.at(rank, t, CollectiveEvent(label=label, tag=tag, layer="reducer", op="all-reduce", axis="data",
                                              dtype="float32", payload_bytes=nbytes, count=count))
    return t


def restart_reshape(w):
    mesh = {"data": 3, "fsdp": 1, "tensor": 1}
    for r in range(3):
        w.spawn(r, 0, 1000.0 + 0.01 * r)
    t = {r: train(w, r, 1000.3, range(3)) for r in range(3)}
    w.at(2, t[2], FailureEvent(kind="chaos_injected", label="proc_kill", rank=2, step=3, incarnation=0))
    w.sup(t[2] + 0.05, FailureEvent(kind="worker_exit", label="supervisor", message="exit code -9 (hard death)",
                                    rank=2, incarnation=0))
    w.sup(t[2] + 0.10, FailureEvent(kind="worker_restart", label="supervisor", message="restart 1/2 in 0.05s",
                                    rank=2, incarnation=1))
    w.spawn(2, 1, t[2] + 0.15)
    w.at(2, t[2] + 0.45, FailureEvent(kind="resumed", label="checkpoint", message="from step 3", rank=2, step=3,
                                      incarnation=1))
    t[2] = train(w, 2, t[2] + 0.45, range(3, 6))
    t[0] = train(w, 0, t[0], range(3, 6))
    t[1] = train(w, 1, t[1], range(3, 6))
    out = max(t.values())
    w.sup(out + 0.01, FailureEvent(kind="chaos_injected", label="zone_outage", message="ranks [1, 2]"))
    for r in (1, 2):
        w.sup(out + 0.02 + 0.01 * r, FailureEvent(kind="worker_exit", label="supervisor",
                                                  message="exit code -9 (hard death)", rank=r))
    t_r = out + 0.3
    w.sup(t_r, ReshapeEvent(old_world=3, new_world=1, old_mesh=mesh, new_mesh={"data": 1, "fsdp": 1, "tensor": 1},
                            dead_ranks=[1, 2], correlated=True, reason="zone outage: 2 deaths in 2.0s"))
    w.sup(t_r + 0.1, FailureEvent(kind="worker_term", label="supervisor",
                                  message="SIGTERM for reshape honored (graceful death)", rank=0))
    w.spawn(0, 1, t_r + 0.2, world=1)
    w.at(0, t_r + 0.5, FailureEvent(kind="resharded", label="checkpoint", message="world 3 -> 1", rank=0, step=6,
                                    incarnation=1))
    end = train(w, 0, t_r + 0.5, range(6, 10), audit_step=6)
    w.sup(end + 0.05, FailureEvent(kind="worker_complete", label="supervisor", rank=0))
    w.sup(end + 0.06, FailureEvent(kind="run_complete", label="supervisor", message="world 1"))


def adaptive_stall(w):
    for r in range(2):
        w.spawn(r, 0, 1000.0 + 0.02 * r, skew=0.5 * r)
    slow = lambda rank, s: 0.035 if rank == 1 else 0.02  # noqa: E731
    t = {r: train(w, r, 1000.4, range(2), step_s=slow, comm_s=0.004) for r in range(2)}
    w.at(0, t[0], FailureEvent(kind="chaos_injected", label="comm_stall", message="1.0 s", rank=0, step=2))
    w.at(0, t[0] + 0.05, FailureEvent(kind="comm_deadline", label="grads", message="deadline 0.05 s expired",
                                      rank=0, step=2))
    w.at(0, t[0] + 0.06, FailureEvent(kind="comm_step_retry", label="grads", message="retry 1", rank=0, step=2))
    t[0] += 0.06
    pred = {"predicted_bytes_per_step": 1.5e5, "realized_bytes_per_step": 4.0 * MIB}
    for r in range(2):
        t[r] = train(w, r, t[r], range(2, 12), step_s=slow, comm_s=0.004)
        for e in range(3):
            w.at(r, t[r], EpochEvent(epoch=e, rank=r, mean_loss=1.5 - 0.1 * e, bits_cumulative=8 * 4 * MIB * 4 * (e + 1)))
    for r in range(2):
        w.at(r, t[r] - 0.3, PolicyEvent(action="descend", trigger="verdict:deadline_expired", epoch=1,
                                        rung_before="baseline", rung_after="compress", rung_index_before=0,
                                        rung_index_after=1, overrides={"reducer": "powersgd"}, rank=r, **pred))
        w.at(r, t[r] - 0.1, PolicyEvent(action="ascend", trigger="verdict:healthy", epoch=2, rung_before="compress",
                                        rung_after="baseline", rung_index_before=1, rung_index_after=0, rank=r))
    w.at(0, t[0], DataDropEvent(label="cifar10", epoch=0, dropped_batches=1, dropped_samples=16, reason="short",
                                rank=0))
    w.at(1, t[1], DataDropEvent(label="cifar10", epoch=0, dropped_batches=1, dropped_samples=16, rank=1))


def live_alert(w):
    for r in range(2):
        w.spawn(r, 0, 1000.0)
    tags = (("grads.b0", 2 * MIB, 1), ("grads.b1", MIB, 2), ("grads.b2", MIB // 2, 1), ("loss-sync", 4, 1))
    t = {r: train(w, r, 1000.3, range(16), step_s=lambda rank, s: 0.02 if s < 10 else 0.045, tags=tags)
         for r in range(2)}
    w.sup(t[0] - 0.1, AlertEvent(alert="step_time_drift", severity="warn", value=2.2, threshold=1.5,
                                 message="step p50 2.2x its baseline", rank=0, step=14))
    w.sup(t[0] - 0.05, AlertEvent(alert="grad_spike", severity="critical", value=31.0, threshold=10.0,
                                  message="grad norm 31x its median", rank=1, step=15))
    w.sup(t[0], AlertEvent(alert="hbm_headroom", severity="warn", value=0.04, threshold=0.05), ts=DROP)
    for r in range(2):
        w.at(r, t[r], PolicyEvent(action="descend", trigger="alert:step_time_drift:warn", epoch=3,
                                  rung_before="baseline", rung_after="compress", rung_index_before=0,
                                  rung_index_after=1, rank=r))
    w.sup(t[0] + 0.01, NoteEvent(message="nudged to compress"))


def served(w):
    w.spawn(0, 0, 1000.0)
    t = 1000.4
    for i in range(8):
        t += 0.1
        state = "evicted" if i == 5 else "failed" if i == 6 else "finished"
        fields = dict(queue_s=0.01 * i, prefill_s=0.02 + 0.001 * i, decode_s=0.05 * (i + 1), total_s=0.1 + 0.06 * i)
        if state == "failed":
            fields = dict(queue_s=None, prefill_s=None, decode_s=None, total_s=None)
        w.at(0, t, RequestEvent(request_id=f"r{i}", state=state, prompt_tokens=32, tokens_generated=1 if i == 7 else
                                8 + i, requeues=1 if i == 3 else 0, reason="slot lost" if i == 5 else "", **fields))
        w.at(0, t, KVPoolEvent(n_blocks=64, block_len=16, blocks_free=60 - 3 * i, blocks_used=3 + 3 * i,
                               blocks_shared=i, pool_bytes=64 * MIB, prefix_hits_total=i, prefill_tokens_saved_total=16 * i,
                               cow_copies_total=i // 2, admissions_deferred_total=i // 3, rank=0, label="serving"))
    w.at(0, t, KVPoolEvent(n_blocks=8, block_len=16, blocks_free=7, rank=0, label="draft"))
    w.sup(t, KVPoolEvent(n_blocks=4, block_len=8, blocks_free=2, blocks_used=1, pool_bytes=MIB))
    w.sup(1000.1, JobEvent(job_id="train", state="submitted", kind="train", priority=1))
    w.sup(1000.2, ScheduleEvent(job_id="train", world=1, device_ranks=[0], planner="costmodel", predicted_step_s=0.02))
    w.sup(1000.3, JobEvent(job_id="serve", state="submitted", kind="serve", priority=5))
    w.sup(1000.4, PreemptEvent(victim="train", beneficiary="serve", reason="slo_burn"))
    w.sup(1000.5, ScheduleEvent(job_id="serve", world=1, device_ranks=[0], planner="fallback"))
    w.sup(t, JobEvent(job_id="serve", state="completed", kind="serve", priority=5, chip_seconds=1.2, work_done=40.0,
                      met_deadline=True))
    w.sup(t, JobEvent(job_id="train", state="completed", kind="train", priority=1, chip_seconds=2.5, work_done=12.0,
                      met_deadline=False, preemptions=1))
    w.sup(t, JobEvent(job_id="looper", state="failed", kind="train", chip_seconds=0.4))


def hierarchical(w):
    for r in range(4):
        w.spawn(r, 0, 1000.0 + 0.005 * r)
    tags = (("inner.grads", 6 * MIB, 2), ("outer.powersgd.P", 96 * 1024, 1), ("outer.powersgd.Q", 64 * 1024, 1),
            ("loss-sync", 4, 1))
    t = {r: train(w, r, 1000.3, range(6), comm_s=0.006 if r == 2 else 0.002, tags=tags) for r in range(4)}
    w.at(0, t[0] - 0.08, PartitionEvent(phase="partitioned", edge=[0, 2], local_steps=0, max_local_steps=4,
                                        reason="outer sync deadline", rank=0, step=3))
    w.at(0, t[0] - 0.05, PartitionEvent(phase="local", edge=[0, 2], local_steps=2, max_local_steps=4, rank=0, step=4))
    w.at(0, t[0], PartitionEvent(phase="rejoin", local_steps=3, max_local_steps=4, outer_staleness=3, rank=0, step=5))
    w.sup(t[0], PartitionEvent(phase="local", local_steps=1), ts=DROP)


def probed(w):
    for r in range(2):
        w.spawn(r, 0, 1000.0)
    t = {r: 1000.3 for r in range(2)}
    for s0 in range(0, 8, 2):
        for r in range(2):
            t[r] = train(w, r, t[r], range(s0, s0 + 2), epoch_len=2)
            w.at(r, t[r], MemoryEvent(step=s0 + 1, bytes_in_use=1.0e9 + 1e8 * s0 + r, peak_bytes_in_use=(
                None if s0 == 2 else 1.5e9 + 1e8 * s0), bytes_limit=8.0e9, device_kind="cpu", rank=r, label="probe"))
            w.at(r, t[r], TrainHealthEvent(step=s0 + 1, epoch=s0 // 2, grad_norm=1.0 + s0, ef_memory_norm=0.1 * s0,
                                           powersgd_rel_error=0.2, loss=1.0, rank=r))
            for group, tag, err in (("conv.(64, 64, 3, 3)", "powersgd.P", 0.12 + 0.01 * s0), ("fc", "grads", 0.0)):
                w.at(r, t[r], FidelityEvent(step=s0 + 1, group=group, tag=tag, epoch=s0 // 2, rel_error=err,
                                            cosine_sim=1.0 - err, ef_norm=0.5 * err, ef_growth=0.01 * s0,
                                            quantized_share=0.25 if tag != "grads" else 0.0,
                                            replica_drift=1e-4 * s0, anchor_drift=2e-4 * s0, rank=r))
    for r in range(2):
        w.at(r, t[r], PolicyEvent(action="descend", trigger="verdict:slow", epoch=2, rung_before="baseline",
                                  rung_after="compress", rung_index_before=0, rung_index_after=1, rank=r))


def ragged(w):
    for r in range(3):
        w.spawn(r, 0, 1000.0, write=r != 2)  # rank 2's shard is never written
    t = {r: train(w, r, 1000.3, range(4)) for r in range(2)}
    w.at(1, t[1] + 0.01, StepEvent(step=4, epoch=1, loss=0.5, step_time_s=0.02, bits_cumulative=0, valid=False))
    w.at(1, t[1] + 0.02, StepEvent(step=5, epoch=1, loss=0.4, step_time_s=0.021, bits_cumulative=0), ts_mono=DROP)
    w.at(0, t[0], FailureEvent(kind="audit_error", label=None, message=None, rank=0, step=None, incarnation=None))
    w.at(0, t[0], FailureEvent(kind="chaos_injected", label="bad_batch", rank=0), ts=DROP, ts_mono=DROP)
    w.at(0, t[0], PolicyEvent(action="descend", trigger="", epoch=1, rung_before="baseline", rung_after="compress",
                              rung_index_before=0, rung_index_after=1, predicted_bytes_per_step=None), ts=DROP,
         ts_mono=DROP)
    w.at(0, t[0], AlertEvent(alert="stale_peer", rank=None, step=None))
    w.at(0, t[0], SpanEvent(name="checkpoint/save", span_id=w.span_id(), parent_id=None, depth=0, dur_s=-1.0))
    w.raw(1, "\n[1, 2]\n")
    w.raw(1, json.dumps({"event": "mystery", "ts": t[1], "payload": None}) + "\n")
    w.raw(1, json.dumps({"ts": t[1], "note": "a record of no kind"}) + "\n")
    w.raw(1, '{"event": "step", "step": 6, "ts": 1')


SCENARIOS = {
    "restart_reshape": (restart_reshape, 3),
    "adaptive_stall": (adaptive_stall, 2),
    "live_alert": (live_alert, 2),
    "served": (served, 1),
    "hierarchical": (hierarchical, 4),
    "probed": (probed, 2),
    "ragged": (ragged, 3),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each scenario's run directory and both reports of it (the port's
    with its Chrome trace, the JAX package's with its own)."""
    out = {}
    for name, (write, world) in SCENARIOS.items():
        run_dir = str(tmp_path_factory.mktemp(name) / "run")
        os.makedirs(run_dir)
        w = RunWriter(run_dir, name, world)
        write(w)
        w.close()
        traces = {side: os.path.join(os.path.dirname(run_dir), f"{side}_trace.json") for side in ("port", "ref")}
        out[name] = {
            "run_dir": run_dir, "traces": traces,
            "port": PORT.run_report(run_dir, trace_out=traces["port"]),
            "ref": REF.run_report(run_dir, trace_out=traces["ref"]),
        }
    return out


@pytest.mark.parametrize("key", REPORT_KEYS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_run_report_key_matches(runs, scenario, key):
    (_, port), (_, ref) = runs[scenario]["port"], runs[scenario]["ref"]
    assert list(port) == list(ref) == list(REPORT_KEYS)
    assert_key_equal(port, ref, key)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_run_report_text_matches(runs, scenario):
    (port_text, port), (ref_text, _) = runs[scenario]["port"], runs[scenario]["ref"]
    # the trace line names each side's own file
    traces = runs[scenario]["traces"]
    pinned = assert_text_equal(port_text.replace(traces["port"], "TRACE"), ref_text.replace(traces["ref"], "TRACE"))
    rows = port["bandwidth"]["by_tag"] if port["bandwidth"] else []
    edges = port["fabric_matrix"]["edges"] if port["fabric_matrix"] else []
    # each bandwidth row, the total and each edge of the matrix name the row
    assert pinned == (len(rows) + 1 if rows else 0) + len(edges)


def test_scenarios_exercise_every_section(runs):
    rep = {name: r["port"][1] for name, r in runs.items()}
    text = {name: r["port"][0] for name, r in runs.items()}
    f = rep["restart_reshape"]["failures"]
    assert (f["restarts"], f["reshapes"], f["graceful"], f["hard"]) == (1, 1, 1, 3)
    (inc,) = rep["restart_reshape"]["recovery"]["incidents"]
    assert inc["correlated"] and inc["dead_ranks"] == [1, 2] and inc["recovery_s"] > inc["detect_s"] > 0
    assert rep["restart_reshape"]["recovery_time_s"] == inc["recovery_s"]
    assert "disaster recovery — replan timeline" in text["restart_reshape"]
    pol = rep["adaptive_stall"]["policy"]
    assert (pol["descends"], pol["ascends"], pol["final_rung"]) == (1 * 2, 1 * 2, "baseline")
    assert rep["adaptive_stall"]["recovery_latency_s"] > 0
    assert [s["rank"] for s in rep["adaptive_stall"]["stragglers"]] == [1]
    assert rep["adaptive_stall"]["data_drops"] == {"cifar10": {"events": 2, "dropped_batches": 2, "dropped_samples": 32}}
    alerts = rep["live_alert"]["alerts"]
    assert alerts["by_kind"] == {"step_time_drift": 1, "grad_spike": 1, "hbm_headroom": 1} and alerts["criticals"] == 1
    assert [b["bucket"] for b in rep["live_alert"]["comm_buckets"]] == [0, 1, 2]
    assert rep["served"]["slo"]["n_requests"] == 8 and rep["served"]["kv_pool"]["n_engines"] == 3
    assert rep["served"]["fleet"]["completed"] == ["serve", "train"] and rep["served"]["step_p50_s"] is None
    assert rep["hierarchical"]["hierarchy"]["outer_bytes_per_step"] == 160 * 1024
    assert rep["hierarchical"]["partitions"]["healed"] is True
    assert rep["probed"]["fidelity"]["worst_group"] == "conv.(64, 64, 3, 3)"
    assert [r["rung"] for r in rep["probed"]["fidelity_frontier"]["rungs"]] == ["baseline", "compress"]
    assert rep["ragged"]["torn_lines"] == 2 and rep["ragged"]["ranks"]["2"]["missing"] is True
    for name, r in rep.items():
        # the port's compile events carry no predicted footprint: the peak is the sampler's or none
        mem = r["memory"]
        assert mem["predicted"] is None
        assert mem["hbm_peak_source"] == ("measured" if name == "probed" else None), name
        # and no scheduled-collective extract: the buckets join globally
        assert all(b["join"] == "global" for b in r["comm_buckets"])
        assert r["alerts"]["fired"] == len(r["alerts"]["records"])


def test_memory_peak_is_the_samplers(runs):
    mem = runs["probed"]["port"][1]["memory"]
    assert mem["hbm_peak_bytes"] == mem["measured"]["peak_bytes_in_use"] == 1.5e9 + 6e8
    assert mem["measured"]["bytes_limit"] == 8.0e9 and mem["measured_available"] is True
    assert "  hbm_peak_bytes (gate scalar): 2100.00 MB [measured]" in runs["probed"]["port"][0]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_chrome_trace_matches(runs, scenario):
    traces = runs[scenario]["traces"]
    with open(traces["port"]) as f, open(traces["ref"]) as g:
        assert json.load(f) == json.load(g)
    merged = runlog.merge_run(runs[scenario]["run_dir"])
    assert PORT.chrome_trace(merged.events) == REF.chrome_trace(merged.events)


def test_chrome_trace_nests_the_spans(runs):
    merged = runlog.merge_run(runs["hierarchical"]["run_dir"])
    trace = PORT.chrome_trace(merged.events)["traceEvents"]
    names = {e["pid"]: e["args"]["name"] for e in trace if e.get("name") == "process_name"}
    assert names == {0: "rank 0", 1: "rank 1", 2: "rank 2", 3: "rank 3"}
    spans = [e for e in trace if e.get("cat") == "span"]
    assert len(spans) == sum(1 for e in merged.events if e.get("event") == "span")
    by_id = {(e["pid"], e["args"]["span_id"]): e for e in spans}
    for e in spans:
        assert e["tid"] == 0 and e["dur"] >= 0
        parent = by_id.get((e["pid"], e["args"].get("parent_id")))
        if parent is not None:
            assert parent["ts"] - 1e-3 <= e["ts"] and e["ts"] + e["dur"] <= parent["ts"] + parent["dur"] + 1e-3
    assert {e["tid"] for e in trace if e.get("cat") == "step"} == {1}
    # the ring's flow arrows at each step's comm spans, 4 a step
    assert sum(1 for e in trace if e.get("ph") == "s") == 6 * 4
    # the supervisor's failures get a row of their own
    merged = runlog.merge_run(runs["restart_reshape"]["run_dir"])
    trace = PORT.chrome_trace(merged.events)["traceEvents"]
    names = {e["pid"]: e["args"]["name"] for e in trace if e.get("name") == "process_name"}
    assert names == {-1: "supervisor", 0: "rank 0", 1: "rank 1", 2: "rank 2"}
    assert {e["tid"] for e in trace if e.get("cat") == "failure"} == {3}


def test_chrome_trace_of_nothing():
    assert PORT.chrome_trace([]) == REF.chrome_trace([]) == {"traceEvents": [], "displayTimeUnit": "ms"}
    untimed = [rec(StepEvent(step=0, epoch=0, loss=1.0, step_time_s=0.1, bits_cumulative=0))]
    assert PORT.chrome_trace(untimed) == REF.chrome_trace(untimed)


@pytest.mark.parametrize("pair", [("adaptive_stall", "live_alert"), ("live_alert", "adaptive_stall"),
                                  ("probed", "hierarchical"), ("served", "ragged"), ("restart_reshape", "probed")])
@pytest.mark.parametrize("factor", [1.5, 1.2])
def test_compare_runs_matches(runs, pair, factor):
    a, b = (runs[name]["run_dir"] for name in pair)
    (port_text, port_doc), (ref_text, ref_doc) = (
        mod.compare_runs(a, b, straggler_factor=factor) for mod in (PORT, REF))
    assert port_text == ref_text and port_doc == ref_doc
    ra, rb = (runs[name]["port"][1] for name in pair)
    if ra["step_p50_s"] and rb["step_p50_s"]:
        assert port_doc["metrics"]["step_p50_s"]["ratio"] == rb["step_p50_s"] / ra["step_p50_s"]


def _frames(mod, aggregator, run_dir, polls=2):
    agg = aggregator(run_dir)
    out = []
    for _ in range(polls):
        agg.poll()
        out.append(mod.render_watch_frame(agg, run_dir))
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_watch_frame_matches(runs, scenario):
    run_dir = runs[scenario]["run_dir"]
    got = _frames(PORT, live.LiveAggregator, run_dir)
    want = _frames(REF, jax_live.LiveAggregator, run_dir)
    for g, w in zip(got, want):
        assert_text_equal(g, w)
    assert "alerts fired:" in got[0]


def test_watch_frame_tiles(runs):
    run_dir = runs["served"]["run_dir"]
    (frame,) = _frames(PORT, live.LiveAggregator, run_dir, polls=1)
    assert "  serving " in frame and "finished=" in frame
    (frame,) = _frames(PORT, live.LiveAggregator, runs["hierarchical"]["run_dir"], polls=1)
    comm = [line for line in frame.split("\n") if line.startswith("  comm ")]
    assert comm and "NVLink4(H100)" in comm[0] and strip_fabric_row(comm[0]) != comm[0]
    assert PORT._label_value('{edge="0->1",rank="2"}', "rank") == REF._label_value('{edge="0->1",rank="2"}', "rank")
    assert PORT._label_value("plain", "rank") == "plain"


def test_watch_run_ends_after_its_iterations(runs, tmp_path):
    """On a finished run, whose metrics port is gone, ``--watch`` ends
    after its frame count."""
    run_dir = runs["live_alert"]["run_dir"]
    assert live.read_port_file(run_dir) is None
    outs = []
    for mod in (PORT, REF):
        buf = io.StringIO()
        assert mod.watch_run(run_dir, interval=0.0, iterations=3, out=buf) == 0
        outs.append(buf.getvalue())
    assert outs[0].count("live: ") == outs[1].count("live: ") == 3
    assert_text_equal(outs[0], outs[1])


# ---- the section functions, family by family, on the same records ----------------


def _failures():
    return [
        rec(FailureEvent(kind="chaos_injected", label="proc_kill", rank=1, step=3, incarnation=0), ts=10.0),
        rec(FailureEvent(kind="worker_exit", label="supervisor", message="exit code -9 (hard death)", rank=1),
            ts=10.2),
        rec(FailureEvent(kind="worker_restart", message="restart 1/2", rank=1, incarnation=1), ts=10.3),
        rec(FailureEvent(kind="worker_exit", message="exit code 75 (graceful death)", rank=0), ts=11.0),
        rec(FailureEvent(kind="chaos_injected", label="comm_stall", rank=0), ts=11.5),
        rec(FailureEvent(kind="comm_deadline", label="grads", rank=None), ts=11.6),
        rec(FailureEvent(kind="worker_term", label=None, message=None, rank=None, step=None), ts=DROP),
        rec(ReshapeEvent(old_world=2, new_world=1, dead_ranks=[1], correlated=False), ts=12.0),
        {"event": "failure", "kind": "chaos_injected", "ts": 13.0},
    ]


FAMILY_EVENTS = {
    "empty": [],
    "failures": _failures(),
    "policies": [
        rec(PolicyEvent(action="descend", trigger="verdict:slow", epoch=1, rung_before="baseline",
                        rung_after="compress", rung_index_before=0, rung_index_after=1,
                        predicted_bytes_per_step=2e5, realized_bytes_per_step=4e6), t_run=5.0),
        rec(PolicyEvent(action="ascend", trigger="", epoch=3, rung_before="compress", rung_after="baseline",
                        rung_index_before=1, rung_index_after=0, realized_bytes_per_step=3e5), ts=4.0),
        rec(PolicyEvent(action="descend", trigger="alert:grad_spike:critical", epoch=2, rung_before="baseline",
                        rung_after="quantize", rung_index_before=0, rung_index_after=2)),
    ],
    "alerts": [
        rec(AlertEvent(alert="step_time_drift", value=2.1, threshold=1.5, message="2.1x", rank=0), t_run=3.0),
        rec(AlertEvent(alert="grad_spike", severity="critical", value=40.0, threshold=10.0, rank=None), ts=2.0),
        rec(AlertEvent(alert="slo_burn", severity="page", value=0.5, threshold=0.1)),
    ],
    "requests": [
        rec(RequestEvent(request_id=f"q{i}", state=s, tokens_generated=n, queue_s=q, prefill_s=0.01, decode_s=d,
                         total_s=0.2 + i, requeues=i % 2), ts=100.0 + i)
        for i, (s, n, q, d) in enumerate([
            ("finished", 9, 0.0, 0.08), ("finished", 2, None, 0.01), ("finished", 1, 0.1, 0.0),
            ("evicted", 4, 0.2, None), ("failed", 0, None, None), ("finished", 17, 0.05, 0.32)])
    ] + [rec(RequestEvent(request_id="late", state="finished", tokens_generated=5, decode_s=0.04), ts=DROP)],
    "kv_pools": [
        rec(KVPoolEvent(n_blocks=16, block_len=16, blocks_free=f, blocks_used=15 - f, blocks_shared=2,
                        pool_bytes=MIB, prefix_hits_total=k, rank=r, label=label), ts=1.0 + k)
        for k, (r, label, f) in enumerate([(0, "serving", 12), (0, "serving", 4), (1, "serving", 9), (None, "x", 15)])
    ] + [{"event": "kv_pool", "n_blocks": None, "blocks_free": None, "rank": 2}],
    "drops": [
        rec(DataDropEvent(label="imdb", epoch=0, dropped_batches=1, dropped_samples=7)),
        rec(DataDropEvent(label="imdb", epoch=1, dropped_batches=2, dropped_samples=9)),
        {"event": "data_drop", "dropped_batches": None},
    ],
    "unknown": [{"event": "mystery"}, {"kind": "worker_exit"}, {"event": "failure"}],
}


def _recovery_run():
    """Comm faults and two replans on one timeline (the merged run's ``t_run``)."""
    ev = []

    def at(t, e):
        ev.append(rec(e, t_run=t, ts=t))

    for s in range(12):
        at(1.0 + 0.1 * s, StepEvent(step=s, epoch=0, loss=1.0, step_time_s=0.1, bits_cumulative=0))
    at(1.25, FailureEvent(kind="chaos_injected", label="comm_throttle", rank=0))
    at(1.32, FailureEvent(kind="comm_degraded", rank=0))
    at(1.35, FailureEvent(kind="chaos_injected", label="comm_flap", rank=0))
    at(1.45, FailureEvent(kind="worker_exit", message="exit code -9 (hard death)", rank=1))
    at(1.55, ReshapeEvent(old_world=4, new_world=2, old_mesh={"data": 2, "tensor": 2}, new_mesh={"data": 2},
                          dead_ranks=[1, 3], correlated=True, reason="zone"))
    at(1.58, FailureEvent(kind="worker_term", message="reshape SIGTERM (graceful death)", rank=0))
    at(1.62, FailureEvent(kind="worker_term", message="reshape SIGTERM (graceful death)", rank=2))
    at(1.9, ReshapeEvent(old_world=2, new_world=1, new_mesh=None, dead_ranks=None))
    at(2.5, ReshapeEvent(old_world=1, new_world=1))
    return ev


FAMILIES = {
    "log": [
        ("percentile", lambda m: [m.percentile([], 50), m.percentile([3.0, 1.0, 2.0], 50), m.percentile([1.0], 99),
                                  m.percentile([float(i) for i in range(10)], 95)]),
        ("death_counts", lambda m: [m._death_counts(evs) for evs in FAMILY_EVENTS.values()]),
        ("same_rank", lambda m: [m._same_rank(a, b) for a in ({}, {"rank": 0}, {"rank": 1}, {"rank": None})
                                 for b in ({}, {"rank": 0}, {"rank": 1})]),
        ("event_time", lambda m: [m._event_time(e) for e in (
            {}, {"ts": 1.0}, {"t_run": 2.0, "ts": 1.0}, {"t_run": None, "ts": 1.0}, {"t_run": "x"})]),
    ],
    "sections": [
        (f"{fn}/{name}", (lambda fn, name: lambda m: getattr(m, fn)(FAMILY_EVENTS[name]))(fn, name))
        for fn in ("render_failure_timeline", "render_policy_timeline", "render_alert_section", "data_drop_summary",
                   "slo_summary_from_events", "kv_pool_summary_from_events")
        for name in FAMILY_EVENTS
    ] + [
        ("render_request_section", lambda m: m.render_request_section(m.slo_summary_from_events(
            FAMILY_EVENTS["requests"]))),
        ("render_kv_pool_section", lambda m: m.render_kv_pool_section(m.kv_pool_summary_from_events(
            FAMILY_EVENTS["kv_pools"][:-1]))),
    ] + [
        (f"render_report/{name}", (lambda name: lambda m: m.render_report(FAMILY_EVENTS[name], name=name,
                                                                          skipped_lines=len(name) % 3))(name))
        for name in FAMILY_EVENTS
    ],
    "recovery": [
        ("recovery_latency_s", lambda m: [m.recovery_latency_s(_recovery_run()), m.recovery_latency_s([]),
                                          m.recovery_latency_s(FAMILY_EVENTS["failures"])]),
        ("mesh_str", lambda m: [m._mesh_str(x) for x in (None, {}, {"data": 2}, {"data": 2, "fsdp": 2, "tensor": 2})]),
        ("recovery_incidents", lambda m: [m.recovery_incidents(_recovery_run()), m.recovery_incidents([])]),
        ("mttr_s", lambda m: [m.mttr_s(m.recovery_incidents(_recovery_run())), m.mttr_s([]),
                              m.mttr_s([{"recovery_s": None}])]),
        ("render_recovery_section", lambda m: m.render_recovery_section(m.recovery_incidents(_recovery_run()))),
        ("render_report", lambda m: m.render_report(_recovery_run(), name="recovery")),
    ],
}


@pytest.mark.parametrize("case", [c for c, _ in FAMILIES["log"]])
def test_log_helpers_match(case):
    fn = dict(FAMILIES["log"])[case]
    got, want = fn(PORT), fn(REF)
    assert json.dumps(got) == json.dumps(want)


@pytest.mark.parametrize("case", [c for c, _ in FAMILIES["sections"]])
def test_event_log_sections_match(case):
    fn = dict(FAMILIES["sections"])[case]
    assert fn(PORT) == fn(REF)


@pytest.mark.parametrize("case", [c for c, _ in FAMILIES["recovery"]])
def test_recovery_matches(case):
    fn = dict(FAMILIES["recovery"])[case]
    assert fn(PORT) == fn(REF)


def test_recovery_clocks():
    latency = PORT.recovery_latency_s(_recovery_run())
    # the first step after the last comm fault's window: 1.5 - 1.25
    assert latency == pytest.approx(0.25)
    first, second, third = PORT.recovery_incidents(_recovery_run())
    assert first["detect_s"] == pytest.approx(0.1) and first["recovery_s"] == pytest.approx(0.25)
    assert second["recovery_s"] == pytest.approx(0.1) and third["recovery_s"] is None


@pytest.mark.parametrize("lines", [
    ["", "not json", "[1]", "{\"event\": \"step\"}", "{\"event\": \"x\", \"a\": 1}", "{\"torn"],
    [],
    ["{}", "\"str\"", "3", "null"],
])
def test_load_events_matches(tmp_path, lines):
    path = tmp_path / "log.jsonl"
    path.write_text("\n".join(lines) + ("\n" if lines else ""))
    assert PORT.load_events_counted(str(path)) == REF.load_events_counted(str(path))
    assert PORT.load_events(str(path)) == REF.load_events(str(path))


def _merged_sections(run_dir, factor, port_objects):
    """``render_run_sections`` inputs from one package's analytics."""
    rl, an = (runlog, analytics) if port_objects else (jax_runlog, jax_analytics)
    merged = rl.merge_run(run_dir)
    stats = an.rank_step_stats(merged.events)
    stragglers = an.detect_stragglers(stats, factor=factor)
    p50s = [s["p50_s"] for s in stats.values() if s["n"]]
    p50 = an.percentile(p50s, 50) if p50s else None
    collectives = [e for e in merged.events if e.get("event") == "collective"]
    bw = an.effective_bandwidth(p50, collectives, merged.manifest.world_size) if collectives and p50 else None
    return merged, stats, stragglers, bw, factor


@pytest.mark.parametrize("factor", [1.5, 1.1])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_run_sections_match(runs, scenario, factor):
    """The same inputs through both functions; then each package's own
    analytics through its own function (the fabric row pinned)."""
    args = _merged_sections(runs[scenario]["run_dir"], factor, True)
    assert PORT.render_run_sections(*args) == REF.render_run_sections(*args)
    got = "\n".join(PORT.render_run_sections(*args))
    want = "\n".join(REF.render_run_sections(*_merged_sections(runs[scenario]["run_dir"], factor, False)))
    assert_text_equal(got, want)


def _bandwidth(tags, exposed=1.0):
    return {
        "attribution": {"exposed_fraction": exposed, "n_collectives": 3},
        "by_tag": [{"tag": t, "payload_bytes": float(b), "count": c, "comm_time_s": 0.001 * c} for t, b, c in tags],
    }


BUCKETS = _bandwidth([("grads.b1", MIB, 2), ("grads.b0", 2 * MIB, 1), ("loss-sync", 4, 1), ("grads.b10", 512, 1)],
                     exposed=0.4)
SYNC = {"sync_collectives": [{"compute_ops_after": k % 2} for k in range(6)]}
HIER = _bandwidth([("outer.powersgd.P", 4096, 1), ("inner.grads", 8 * MIB, 2), ("outer.q", 1024, 1),
                   ("outer", 7, 1), ("loss-sync", 4, 1)])
PARTS = FAMILY_EVENTS["unknown"] + [
    rec(PartitionEvent(phase=p, edge=e, local_steps=k, max_local_steps=m, reason=r, step=s), t_run=t)
    for p, e, k, m, r, s, t in (("partitioned", [0, 1], 0, 3, "deadline", 4, 9.0), ("local", None, 2, 3, "", 5, 9.5),
                                ("rejoin", [0, 1], 3, None, "healed", 6, 10.0))
] + [{"event": "partition", "phase": "partitioned", "local_steps": None}]
SPAN_EVENTS = [
    rec(SpanEvent(name=n, span_id=i, parent_id=None, depth=d, dur_s=x, step=0, rank=r), t_run=t)
    for i, (n, d, x, r, t) in enumerate([("step", 0, 0.05, 0, 1.05), ("step/compute", 1, 0.04, 0, 1.04),
                                         ("data_load", 0, 0.01, 1, 1.0), ("checkpoint/save", 0, 0.3, 1, 1.5),
                                         ("step", 0, 0.05, None, 1.2)] + [(f"s{k}", 0, 0.001 * k, 0, 2.0)
                                                                          for k in range(9)])
]
COMPILE = rec(compile_record(argument_bytes=1e6, output_bytes=2e5, temp_bytes=3e6, peak_hbm_bytes=4.2e6))
MEMORY = [
    rec(MemoryEvent(step=s, bytes_in_use=1e6 * s, peak_bytes_in_use=p, bytes_limit=lim, device_kind=k, rank=r))
    for s, p, lim, k, r in ((1, 2e6, 8e9, "cpu", 0), (2, None, 8e9, "", 0), (3, 5e6, None, "cpu", 1),
                            (4, None, None, "", None))
] + [{"event": "memory", "rank": 2.0, "bytes_in_use": None}]
FIDELITY = [
    rec(FidelityEvent(step=s, group=g, tag=tag, rel_error=e, cosine_sim=1 - e, ef_norm=e, quantized_share=q,
                      replica_drift=d, anchor_drift=2 * d))
    for s, g, tag, e, q, d in ((1, "a", "powersgd.P", 0.1, 0.5, 0.0), (2, "a", "powersgd.P", 0.3, 0.5, 1e-3),
                               (2, "b", "grads", 0.0, 0.0, 0.0), (1, "c", "grads.b0", 0.2, 0.0, 2e-3))
]
STEPS = [rec(StepEvent(step=s, epoch=s // 3, loss=2.0 - 0.1 * s, step_time_s=0.1, bits_cumulative=8 * MIB * (s + 1)))
         for s in range(9)] + [
    rec(PolicyEvent(action="descend", trigger="t", epoch=1, rung_before="baseline", rung_after="compress",
                    rung_index_before=0, rung_index_after=1)),
    rec(PolicyEvent(action="descend", trigger="t", epoch=1, rung_before="compress", rung_after="quantize",
                    rung_index_before=1, rung_index_after=2)),
]

RUN_FAMILIES = {
    "hierarchy": [
        ("hierarchy_summary", lambda m: [m.hierarchy_summary(x) for x in (None, {}, BUCKETS, HIER)]),
        ("render_hierarchy_section", lambda m: [m.render_hierarchy_section(m.hierarchy_summary(x))
                                                for x in (None, BUCKETS, HIER)]),
        ("partition_summary", lambda m: [m.partition_summary(x) for x in ([], FAMILY_EVENTS["unknown"], PARTS)]),
        ("render_partition_section", lambda m: [m.render_partition_section(m.partition_summary(x))
                                                for x in ([], PARTS)]),
    ],
    "spans": [
        ("span_summary", lambda m: [m.span_summary(x) for x in ([], SPAN_EVENTS, FAMILY_EVENTS["unknown"])]),
        ("render_span_section", lambda m: [m.render_span_section(m.span_summary(SPAN_EVENTS), top_n=n)
                                           for n in (8, 2, 20)]),
        ("union_len", lambda m: [m._union_len(x) for x in ([], [(0, 1), (0.5, 2), (3, 3), (4, 3.5), (5, 6)])]),
    ],
    "buckets": [
        ("bucket_attribution", lambda m: [m.bucket_attribution(b, o) for b in (None, HIER, BUCKETS)
                                          for o in (None, {}, SYNC)]),
        ("render_bucket_section", lambda m: [m.render_bucket_section(m.bucket_attribution(BUCKETS, o))
                                             for o in (None, SYNC)] + [m.render_bucket_section([])]),
    ],
    "memory": [
        ("memory_summary", lambda m: [m.memory_summary(c, x) for c in ([], [COMPILE], [rec(compile_record())])
                                      for x in ([], MEMORY)]),
        ("render_memory_section", lambda m: [m.render_memory_section(m.memory_summary(c, x))
                                             for c in ([], [COMPILE]) for x in ([], MEMORY)]),
        ("footprint_keys", lambda m: m._FOOTPRINT_KEYS),
    ],
    "fidelity": [
        ("render_fidelity_section", lambda m: [m.render_fidelity_section(x) for x in (
            None, {}, fidelity.fidelity_summary([]), fidelity.fidelity_summary(FIDELITY))]),
        ("render_frontier_section", lambda m: [m.render_frontier_section(x) for x in (
            None, {"rungs": []}, fidelity.frontier_from_events(STEPS), fidelity.frontier_from_events(STEPS[:1]))]),
    ],
    "mfu_critpath_fleet": [
        ("render_mfu_section", lambda m: [m.render_mfu_section(x) for x in ([], [
            {"label": "toy", "mfu": 0.2, "peak_flops_per_s": 1e12, "flops_per_step": 2e9, "flops_source": "x",
             "step_time_s": 0.01, "bound": "compute", "exposed_comm_fraction": None},
            {"label": "cpu", "mfu": None}])]),
        ("render_fleet_section", lambda m: m.render_fleet_section(m.fleet_summary_from_events(
            [rec(JobEvent(job_id="j", state="completed", chip_seconds=2.0, work_done=3.0, met_deadline=None)),
             rec(JobEvent(job_id="k", state="started", kind="serve"))]))),
        ("fmt", lambda m: [f(x) for f in (m._fmt_bytes, m._fmt_rate) for x in (0.0, 999.0, 1e3, 5e6, 2e9, 3e12)]),
    ],
}


@pytest.mark.parametrize("case", [(fam, c) for fam, cases in RUN_FAMILIES.items() for c, _ in cases],
                         ids=lambda fc: "/".join(fc))
def test_run_dir_sections_match(case):
    fam, name = case
    fn = dict(RUN_FAMILIES[fam])[name]
    assert fn(PORT) == fn(REF)


def test_fidelity_inputs_are_the_jax_packages():
    """The fidelity sections read ``observe.fidelity``: the port's and the
    JAX package's agree on the records."""
    assert fidelity.fidelity_summary(FIDELITY) == jax_fidelity.fidelity_summary(FIDELITY)
    assert fidelity.frontier_from_events(STEPS) == jax_fidelity.frontier_from_events(STEPS)


# ---- main, flag by flag ------------------------------------------------------------


def _main(mod, argv, cwd):
    out = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            rc = mod.main(argv)
    finally:
        os.chdir(old)
    return rc, out.getvalue()


def _both_main(tmp_path, argv):
    """``argv`` through both scripts, each in a directory of its own (their
    relative outputs land there): ``(port, ref)`` of ``(rc, stdout, dir)``."""
    out = []
    for side, mod in (("port", PORT), ("ref", REF)):
        cwd = tmp_path / side
        cwd.mkdir(exist_ok=True)
        out.append((*_main(mod, argv, str(cwd)), cwd))
    return out


def test_main_event_log_mode(runs, tmp_path):
    shards = [runlog.shard_path(runs[s]["run_dir"], 0) for s in ("adaptive_stall", "ragged")]
    sup = os.path.join(runs["served"]["run_dir"], runlog.SUPERVISOR_LOG)
    for argv in ([shards[0]], shards + [sup], [shards[1], "--json"], shards + ["--json"]):
        (rc, got, _), (jrc, want, _) = _both_main(tmp_path, argv)
        assert rc == jrc == 0 and got == want, argv
    (_, text, _), _ = _both_main(tmp_path, [shards[1]])
    assert "unparseable/torn line(s) skipped" not in text  # rank 0's shard is whole
    (_, text, _), _ = _both_main(tmp_path, [runlog.shard_path(runs["ragged"]["run_dir"], 1)])
    assert "warning: 2 unparseable/torn line(s) skipped" in text
    (_, line, _), _ = _both_main(tmp_path, [shards[0], "--json"])
    events, _ = runlog.load_shard(shards[0])
    counts = {}
    for e in events:
        counts[e.get("event", "raw")] = counts.get(e.get("event", "raw"), 0) + 1
    assert json.loads(line) == {"log": shards[0], "events": counts}


@pytest.mark.parametrize("extra", [[], ["--json"], ["--straggler-factor", "1.1"], ["--trace-out", "t/trace.json"],
                                   ["--json-out", "o/r.json", "--straggler-factor", "1.2", "--json"]])
def test_main_run_dir_mode(runs, tmp_path, extra):
    run_dir = runs["adaptive_stall"]["run_dir"]
    (rc, got, pdir), (jrc, want, jdir) = _both_main(tmp_path, ["--run-dir", run_dir, *extra])
    assert rc == jrc == 0
    if "--json" in extra:
        g, w = json.loads(got), json.loads(want)
        for key in REPORT_KEYS:
            assert_key_equal(g, w, key)
    else:
        assert_text_equal(got, want)
    out = extra[extra.index("--json-out") + 1] if "--json-out" in extra else os.path.join("artifacts",
                                                                                          "run_report.json")
    with open(pdir / out) as f, open(jdir / out) as g:
        g_doc, w_doc = json.load(f), json.load(g)
    for key in REPORT_KEYS:
        assert_key_equal(g_doc, w_doc, key)
    if "--trace-out" in extra:
        with open(pdir / "t" / "trace.json") as f, open(jdir / "t" / "trace.json") as g:
            assert json.load(f) == json.load(g)
    if "--straggler-factor" in extra:
        assert g_doc["straggler_factor"] == float(extra[extra.index("--straggler-factor") + 1])


def test_main_writes_the_frontier_and_matrix_beside_the_report(runs, tmp_path):
    for scenario in ("probed", "hierarchical"):
        (rc, _, pdir), (jrc, _, jdir) = _both_main(
            tmp_path, ["--run-dir", runs[scenario]["run_dir"], "--json-out", f"{scenario}/r.json"])
        assert rc == jrc == 0
        got, want = sorted(os.listdir(pdir / scenario)), sorted(os.listdir(jdir / scenario))
        assert got == want
        for name in got:
            if name != "r.json":
                with open(pdir / scenario / name) as f, open(jdir / scenario / name) as g:
                    assert json.load(f) == json.load(g), name
    assert "fidelity_frontier.json" in os.listdir(tmp_path / "port" / "probed")
    assert "fabric_matrix.json" in os.listdir(tmp_path / "port" / "hierarchical")


@pytest.mark.parametrize("json_flag", [[], ["--json"]])
def test_main_compare(runs, tmp_path, json_flag):
    a, b = runs["adaptive_stall"]["run_dir"], runs["live_alert"]["run_dir"]
    (rc, got, _), (jrc, want, _) = _both_main(tmp_path, ["--compare", a, b, "--straggler-factor", "1.3", *json_flag])
    assert rc == jrc == 0 and got == want
    if json_flag:
        doc = json.loads(got)
        assert doc["metrics"]["alerts.fired"] == {"a": 0.0, "b": 3.0, "ratio": None}


def test_main_watch(runs, tmp_path):
    argv = ["--run-dir", runs["served"]["run_dir"], "--watch", "--interval", "0", "--watch-iterations", "2"]
    (rc, got, _), (jrc, want, _) = _both_main(tmp_path, argv)
    assert rc == jrc == 0 and got.count("live: ") == 2
    assert_text_equal(got, want)


def test_main_plan(runs, tmp_path):
    run_dir = runs["adaptive_stall"]["run_dir"]
    report = runs["adaptive_stall"]["port"][1]
    plan = costmodel.build_plan(costmodel.calibrate(report, source_fabric="10GbE"), fabrics=["10GbE", "100GbE"])
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan))
    (rc, got, pdir), (jrc, want, jdir) = _both_main(
        tmp_path, ["--run-dir", run_dir, "--plan", str(path), "--plan-fabric", "10GbE", "--json-out", "r.json"])
    assert rc == jrc == 0 and "costmodel [10GbE]" in got
    assert_text_equal(got, want)
    with open(pdir / "r.json") as f, open(jdir / "r.json") as g:
        assert json.load(f)["costmodel"] == json.load(g)["costmodel"]


@pytest.mark.parametrize("argv", [[], ["--watch", "log.jsonl"], ["--run-dir", "r", "--plan", "absent.json"]])
def test_main_refuses_what_the_jax_script_refuses(tmp_path, argv):
    for mod in (PORT, REF):
        with pytest.raises(SystemExit) as e, contextlib.redirect_stderr(io.StringIO()):
            if argv[:2] == ["--run-dir", "r"]:
                os.makedirs(tmp_path / "r", exist_ok=True)
                runlog.new_manifest("r", 1).save(str(tmp_path / "r"))
                argv = ["--run-dir", str(tmp_path / "r"), "--plan", str(tmp_path / "absent.json")]
            mod.main(argv)
        assert e.value.code == 2


def test_run_report_keeps_its_one_argument_form(runs):
    text, report = PORT.run_report(runs["live_alert"]["run_dir"])
    assert report["straggler_factor"] == 1.5 and "trace:" not in text
