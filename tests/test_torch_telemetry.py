"""The telemetry core (``observe/{events,sinks,telemetry,spans,memory}.py``,
``utils/{metrics,profiling,timing,overlap,benchmarks}.py``) against the JAX
package's, and the entries that emit through it.

- every event class's ``record()`` and ``banner()`` against the JAX class
  on the same fields (30 classes);
- the JSONL a fixed event sequence writes through ``JsonlSink``, byte for
  byte, with the clocks fixed; the registry, the sinks, ``audit_from_config``;
- span nesting, parent ids and depths, the ambient recorder, and the
  profiler range a span becomes inside a trace;
- the metrics logger's ``StepEvent`` and ``EpochEvent`` against the JAX
  logger's;
- the memory sampler's one-read no-op on the CPU and the OOM report;
- ``profiling.trace`` writing a trace with the step ranges; timing,
  overlap and the benchmark scaffold;
- ``powersgd_cifar10.run`` with ``event_log``, ``audit_wire`` and
  ``health_every`` against the JAX run from the same weights and Q: the
  records' kinds and counts, the audit's ``analytic_bytes``, the losses
  (1e-5, as the run tests) and the probes (1e-4, the run tests' class for
  a state after steps); the JAX run's loader
  plane (its ``LoaderEvent`` and ``data_load/stage`` spans from the native
  loader and the device prefetch, ROADMAP.md §A item 6) has no port yet,
  and its audit span is ``audit/compile`` where the port's is
  ``audit/record``;
- the four config fields and launcher flags; ``diloco_cifar10``'s
  ``DataDropEvent``; the FSDP entry's audit; ``bare_init`` and
  ``serve_gpt`` writing their run logs.
"""

import collections
import dataclasses
import functools
import io
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.experiments import powersgd_cifar10 as jax_powersgd_cifar10
from network_distributed_pytorch_tpu.observe import events as jax_events
from network_distributed_pytorch_tpu.observe import memory as jax_memory
from network_distributed_pytorch_tpu.observe import sinks as jax_sinks
from network_distributed_pytorch_tpu.observe import spans as jax_spans
from network_distributed_pytorch_tpu.observe import telemetry as jax_telemetry
from network_distributed_pytorch_tpu.parallel import make_mesh
from network_distributed_pytorch_tpu.utils import benchmarks as jax_benchmarks
from network_distributed_pytorch_tpu.utils import metrics as jax_metrics
from network_distributed_pytorch_tpu.utils import overlap as jax_overlap
from network_distributed_pytorch_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
from network_distributed_pytorch_tpu_torch import launch
from network_distributed_pytorch_tpu_torch.experiments import (
    bare_init,
    diloco_cifar10,
    exact_cifar10,
    powersgd_cifar10,
    serve_gpt,
)
from network_distributed_pytorch_tpu_torch.models.import_weights import powersgd_state_from_jax, resnet_state_dict_from_flax
from network_distributed_pytorch_tpu_torch.observe import events, memory, sinks, spans, telemetry
from network_distributed_pytorch_tpu_torch.utils import benchmarks, metrics, overlap, profiling, timing
from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig
from torch_worker import few_torch_threads  # noqa: F401 (autouse)

LOSS_TOL = 1e-5
# the probes of a run sample states that steps have moved: the run tests'
# class for a state after steps (tests/test_torch_training.py: per-parameter
# gradients differ by up to ~5e-5 between XLA's and PyTorch's convolution
# backward), where test_torch_health.py holds the probe on one state to 1e-5;
# measured at the second probe: grad_norm 4.8e-5 and the compression error
# 1.1e-4 relative apart (8e-5 absolute, under the 1.7e-4 this bound allows)
RUN_PROBE_TOL = 1e-4

# ---- events -------------------------------------------------------------------

EVENT_CLASSES = sorted(
    name for name, c in vars(jax_events).items() if isinstance(c, type) and issubclass(c, jax_events.Event)
)


def _sample(type_str: str):
    """A value of the annotated type (the annotations are strings)."""
    if type_str.startswith("Optional["):
        type_str = type_str[len("Optional["):-1]
    if type_str.startswith(("Dict", "dict")):
        return {"a": 1}
    if type_str.startswith(("List", "list")):
        return [1, 2]
    return {"int": 7, "float": 0.25, "str": "x", "bool": True}[type_str]


def _kwargs(cls):
    return {f.name: _sample(f.type) for f in dataclasses.fields(cls)}


def test_the_port_has_every_event_class():
    assert len(EVENT_CLASSES) == 30
    for name in EVENT_CLASSES:
        assert getattr(events, name).KIND == getattr(jax_events, name).KIND
        assert [f.name for f in dataclasses.fields(getattr(events, name))] == [
            f.name for f in dataclasses.fields(getattr(jax_events, name))
        ]
    assert events.SCHEMA_VERSION == jax_events.SCHEMA_VERSION


@pytest.mark.parametrize("name", EVENT_CLASSES)
def test_event_record_matches_jax(name):
    kw = _kwargs(getattr(jax_events, name))
    assert getattr(events, name)(**kw).record() == getattr(jax_events, name)(**kw).record()


@pytest.mark.parametrize("name", EVENT_CLASSES)
def test_event_banner_matches_jax(name):
    kw = _kwargs(getattr(jax_events, name))
    assert getattr(events, name)(**kw).banner() == getattr(jax_events, name)(**kw).banner()
    if "verbose" in kw:  # the step banner only on a log_every step
        kw["verbose"] = False
        assert getattr(events, name)(**kw).banner() is None


# ---- sinks and the registry ---------------------------------------------------


def _fixed_sequence(ev):
    return [
        ev.StepEvent(step=0, epoch=0, loss=2.5, step_time_s=0.125, bits_cumulative=1024, verbose=True),
        ev.CollectiveEvent(label="r", tag="grads", layer="reducer", op="all-reduce", axis="data", dtype="float32",
                           payload_bytes=128),
        ev.CompileEvent(label="r", analytic_bytes=128, hlo_bytes=128, delta_bytes=0, exact=True,
                        hlo_collective_count=1, hlo_by_kind={"all-reduce": 1}),
        ev.TrainHealthEvent(step=1, grad_norm=1.5, powersgd_rel_error=0.5, loss=2.0),
        ev.RawEvent(payload={"metric": 3}),
        ev.EpochEvent(epoch=0, rank=0, mean_loss=2.25, bits_cumulative=2048),
    ]


def test_jsonl_sink_writes_the_jax_bytes(tmp_path, monkeypatch):
    for mod in (telemetry, jax_telemetry):
        monkeypatch.setattr(mod.time, "time", lambda: 1700000000.5)
        monkeypatch.setattr(mod.time, "monotonic", lambda: 42.25)
    logs = []
    for tel_mod, sink_mod, ev, name in ((telemetry, sinks, events, "port"), (jax_telemetry, jax_sinks, jax_events, "jax")):
        path = str(tmp_path / name / "run.jsonl")
        with tel_mod.Telemetry([sink_mod.JsonlSink(path)]) as tel:
            for e in _fixed_sequence(ev):
                tel.emit(e)
        logs.append(open(path, "rb").read())
    assert logs[0] == logs[1]
    lines = [json.loads(x) for x in logs[0].splitlines()]
    # a RawEvent's record is its payload, verbatim and unstamped
    assert [r.get("event") for r in lines] == ["step", "collective", "compile", "train_health", None, "epoch"]
    assert lines[4] == {"metric": 3} and lines[0]["ts"] == 1700000000.5 and "verbose" not in lines[0]


def test_jsonl_sink_appends_and_stream_sink_prefixes(tmp_path):
    path = str(tmp_path / "a" / "b.jsonl")
    for _ in range(2):
        with telemetry.Telemetry([sinks.JsonlSink(path)]) as tel:
            tel.emit(events.NoteEvent("hi"))
    assert len(open(path).read().splitlines()) == 2
    buf = io.StringIO()
    sinks.StreamJsonSink(buf, prefix="@X@").emit(events.NoteEvent("m"))
    assert buf.getvalue().startswith('@X@{"event": "note"')


def test_banners_go_to_standard_error(capsys):
    tel = telemetry.telemetry_for_run()
    tel.emit(events.EpochEvent(epoch=1, rank=0, mean_loss=1.0, bits_cumulative=8e6))
    tel.emit(events.StepEvent(step=0, epoch=0, loss=1.0, step_time_s=0.1, bits_cumulative=0))  # not verbose
    out = capsys.readouterr()
    assert out.out == "" and out.err == ">>>>> Rank 0, epoch 1: mean loss 1.0000, 1.00 MB communicated\n"
    assert sinks.BannerSink is sinks.StdoutSink
    assert telemetry.default_telemetry() is telemetry.default_telemetry()


def test_memory_sink_and_the_registry():
    sink = sinks.MemorySink()
    tel = telemetry.Telemetry()
    assert tel.add_sink(sink) is sink
    tel.emit(events.NoteEvent("a"))
    tel.emit(events.FailureEvent(kind="audit_error"))
    assert [r["event"] for r in sink.records] == ["note", "failure"] and len(sink.of_kind("note")) == 1
    assert sink.events[1].kind == "audit_error" and "ts_mono" in sink.records[0]


@pytest.mark.parametrize(
    "fields", [{}, {"event_log": "x.jsonl"}, {"audit_wire": True}, {"event_log": "x.jsonl", "audit_wire": False}]
)
def test_audit_from_config_matches_jax(fields):
    assert telemetry.audit_from_config(ExperimentConfig(**fields)) == jax_telemetry.audit_from_config(
        JaxExperimentConfig(**fields))


def test_telemetry_from_config_writes_the_event_log(tmp_path):
    path = str(tmp_path / "log.jsonl")
    tel = telemetry.telemetry_from_config(ExperimentConfig(event_log=path))
    assert [type(s) for s in tel.sinks] == [sinks.StdoutSink, sinks.JsonlSink]
    tel.emit(events.NoteEvent("x"))
    tel.close()
    assert json.loads(open(path).read())["message"] == "x"
    assert [type(s) for s in telemetry.telemetry_from_config(object()).sinks] == [sinks.StdoutSink]


# ---- spans --------------------------------------------------------------------


def _nested(span_mod, tel):
    with span_mod.recording(tel):
        with span_mod.span("step", step=3):
            with span_mod.span("step/compute", step=3):
                pass
            with span_mod.span("step/loss_sync", step=3):
                assert span_mod.current_span_id() is not None
        with span_mod.span("epoch_hook"):
            pass
    with span_mod.span("unrecorded"):
        pass


def _shape(records):
    """(name, depth, parent's name, step) of each span record."""
    names = {r["span_id"]: r["name"] for r in records}
    return [(r["name"], r["depth"], names.get(r["parent_id"]), r["step"]) for r in records]


def test_spans_nest_as_the_jax_spans_do():
    got, want = sinks.MemorySink(), jax_sinks.MemorySink()
    _nested(spans, telemetry.Telemetry([got]))
    _nested(jax_spans, jax_telemetry.Telemetry([want]))
    assert _shape(got.records) == _shape(want.records) == [
        ("step/compute", 1, "step", 3), ("step/loss_sync", 1, "step", 3), ("step", 0, None, 3),
        ("epoch_hook", 0, None, None),
    ]
    assert len({r["span_id"] for r in got.records}) == 4 and all(r["dur_s"] >= 0 for r in got.records)
    assert spans.ambient() is None and spans.current_span_id() is None


def test_span_stacks_are_per_thread():
    sink = sinks.MemorySink()
    tel = telemetry.Telemetry([sink])
    with spans.span("main", telemetry=tel):

        def worker():
            with spans.span("other", telemetry=tel):
                pass

        t = threading.Thread(target=worker)
        t.start()
        t.join(10)
        assert not t.is_alive()
    other = sink.of_kind("span")[0]
    assert other["name"] == "other" and other["parent_id"] is None and other["depth"] == 0


def test_a_span_is_a_profiler_range_only_inside_a_trace(tmp_path):
    assert not spans.profiler_active()
    with profiling.trace(str(tmp_path)):
        assert spans.profiler_active()
        with spans.span("probe/region"):
            torch.ones(4).sum()
        with profiling.step_annotation("run", 5), profiling.annotate("outer/range"):
            torch.ones(4).sum()
    text = open(tmp_path / profiling.TRACE_NAME).read()
    assert '"probe/region"' in text and '"run#5"' in text and '"outer/range"' in text
    assert isinstance(profiling.step_annotation("run", 1), type(profiling.contextlib.nullcontext()))


# ---- the metrics logger -------------------------------------------------------


def _log_run(logger):
    for epoch in range(2):
        for loss in (2.5, 2.0, 1.5):
            logger.start_step()
            logger.end_step(epoch, loss)
        logger.end_epoch(epoch, rank=1)
    logger.end_step(2, 1.0)  # no start_step: untimed


def test_metrics_logger_emits_the_jax_events(tmp_path):
    got, want = sinks.MemorySink(), jax_sinks.MemorySink()
    ours = metrics.MetricsLogger(bits_per_step=96, log_every=2, telemetry=telemetry.Telemetry([got]))
    theirs = jax_metrics.MetricsLogger(bits_per_step=96, log_every=2, telemetry=jax_telemetry.Telemetry([want]))
    _log_run(ours)
    _log_run(theirs)
    strip = lambda recs: [{k: v for k, v in r.items() if k not in ("ts", "ts_mono", "step_time_s")} for r in recs]  # noqa: E731
    assert strip(got.records) == strip(want.records)
    assert [e.banner() is None for e in got.events] == [e.banner() is None for e in want.events]
    assert ours.bits_communicated == theirs.bits_communicated == 7 * 96
    assert {k: v for k, v in ours.summary().items() if k != "mean_step_time_s"} == {
        k: v for k, v in theirs.summary().items() if k != "mean_step_time_s"}
    assert not ours.records[-1].valid and ours.records[-1].step_time_s == 0.0
    ours.end_step(3, 0.5, device_time_ms=1.25)
    assert ours.records[-1].device_time_ms == 1.25 and ours.bits_communicated == 8 * 96
    path = str(tmp_path / "steps.jsonl")
    ours.dump_jsonl(path)
    assert json.loads(open(path).read().splitlines()[-1])["device_time_ms"] == 1.25


# ---- memory, timing, overlap, benchmarks --------------------------------------


def test_memory_sampler_reads_once_on_the_cpu():
    sink = sinks.MemorySink()
    sampler = memory.MemorySampler(telemetry.Telemetry([sink]), label="x", device=torch.device("cpu"))
    assert memory.device_memory_stats(torch.device("cpu")) is None
    assert sampler.sample(1) is None and not sampler.enabled
    assert sampler.sample(2) is None and sink.records == []


def test_oom_report_matches_jax(tmp_path):
    kw = dict(error="out of memory", label="x", rank=1, step=9, last_memory={"bytes_in_use": 3.0},
              buffers={"params": 10, "ef_memory": 30.0, "bad": -1, "slots": 20})
    report = memory.build_oom_report(**kw)
    assert report == jax_memory.build_oom_report(**kw) and report["top_buffer"] == "ef_memory"
    path = memory.write_oom_report(report, str(tmp_path / "r" / memory.OOM_REPORT_NAME))
    assert json.load(open(path)) == json.loads(json.dumps(report)) and not os.path.exists(path + ".tmp")


def test_tree_bytes_counts_nested_tensors():
    tree = {"a": torch.zeros(3, 4), "b": [torch.zeros(2, dtype=torch.bfloat16), (torch.zeros(1, dtype=torch.int64),)],
            "c": "not a tensor", "d": None}
    assert memory.tree_bytes(tree) == 48 + 4 + 8 and memory.tree_bytes(None) == 0


def test_wait_result_and_time_amortized():
    calls = []
    assert timing.wait_result({"a": torch.tensor(2.0), "b": [torch.ones(2)]})["a"] == 2.0
    assert timing.time_amortized(lambda: calls.append(1) or torch.tensor(1.0), repeats=3) >= 0
    assert len(calls) == 4  # one settling call and three timed


def test_overlap_report_of_a_kernel_timeline():
    kernels = [
        {"name": "ncclDevKernel_AllReduce_Sum_f32_RING_LL", "ts": 100.0, "dur": 50.0, "stream": 20},
        {"name": "gram_schmidt_kernel", "ts": 90.0, "dur": 20.0, "stream": 7},  # 10 us inside
        {"name": "sm90_gemm", "ts": 130.0, "dur": 40.0, "stream": 7},  # 20 us inside
        {"name": "ncclDevKernel_AllGather", "ts": 300.0, "dur": 10.0, "stream": 20},  # alone
        {"name": "elementwise", "ts": 302.0, "dur": 5.0, "stream": 20},  # its own stream: serialised
    ]
    rep = overlap.overlap_report(kernels)
    assert (rep["n_async_collectives"], rep["n_overlapped"], rep["all_overlap"]) == (2, 1, False)
    assert rep["collectives"][0]["overlap_us"] == 30.0 and rep["overlap_us"] == 30.0 and rep["comm_us"] == 60.0
    assert overlap.comm_attribution(rep) == jax_overlap.comm_attribution(rep)
    empty = overlap.overlap_report([{"name": "k", "ts": 0.0, "dur": 1.0, "stream": 7}])
    assert (empty["n_async_collectives"], empty["comm_us"], empty["collective_emitters"]) == (0, 0, [])
    assert overlap.comm_attribution(empty) == jax_overlap.comm_attribution(empty)


def test_kernels_come_from_a_chrome_trace(tmp_path):
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 5, "dur": 2, "args": {"stream": 3}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1, "dur": 1},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 1, "dur": 1, "args": {"stream": 7}},
    ]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    assert overlap.kernels_from_chrome_trace(str(path)) == [
        {"name": "a", "ts": 1.0, "dur": 1.0, "stream": 7}, {"name": "b", "ts": 5.0, "dur": 2.0, "stream": 3}]


def test_benchmark_scaffold():
    args = (124e6, 12, 768, 1024, 8)
    assert benchmarks.gpt_analytic_train_flops(*args) == jax_benchmarks.gpt_analytic_train_flops(*args)
    out = benchmarks.time_gpt_train_step(small=True, seq_len=16, batch=2, vocab=64, reps=1, device="cpu")
    assert out["model"] == "gpt_tiny" and out["device"] == "cpu" and out["step_time_ms"] > 0
    assert out["flops_per_step"] == benchmarks.gpt_analytic_train_flops(out["n_params"], 2, 32, 16, 2)


# ---- the config, the launcher and the entries ---------------------------------


def test_the_four_fields_and_their_flags_reach_the_config(monkeypatch):
    seen = []
    monkeypatch.setattr(powersgd_cifar10, "run", lambda cfg, **kw: seen.append(cfg) or {"experiment": "x"})
    launch.main(["powersgd_cifar10", "--device", "cpu", "--event-log", "e.jsonl", "--trace-dir", "t",
                 "--audit-wire", "--health-every", "3"])
    cfg = seen[0]
    assert (cfg.event_log, cfg.trace_dir, cfg.audit_wire, cfg.health_every) == ("e.jsonl", "t", True, 3)
    launch.main(["powersgd_cifar10", "--device", "cpu"])
    assert (seen[1].event_log, seen[1].trace_dir, seen[1].audit_wire, seen[1].health_every) == (None, None, None, 0)
    for flags in (["--health-every", "2"], ["--trace-dir", "t"], ["--audit-wire"], ["--event-log", "e"]):
        with pytest.raises(ValueError, match="is not supported by 'gpt_lm'"):
            launch.main(["gpt_lm", "--device", "cpu", *flags])


@functools.lru_cache(maxsize=None)
def _jax_run(tmp_dir):
    """The JAX ``powersgd_cifar10.run`` at preset small on one CPU device
    with its event log, audit and probe; its initial weights and Q."""
    from network_distributed_pytorch_tpu.experiments.powersgd_cifar10 import build_model

    cfg = JaxExperimentConfig(
        training_epochs=1, global_batch_size=16, learning_rate=0.01, reducer_rank=2,
        event_log=os.path.join(tmp_dir, "jax.jsonl"), health_every=1,
    )
    variables = jax.device_get(build_model("small").init(jax.random.PRNGKey(cfg.seed), jnp.zeros((1, 32, 32, 3)),
                                                          train=True))
    kept = {}
    loop = jax_powersgd_cifar10.train_loop

    def keep(step, state, *args, **kwargs):
        kept["q0"] = np.asarray(state.reducer_state.q_memory)
        return loop(step, state, *args, **kwargs)

    jax_powersgd_cifar10.train_loop = keep
    try:
        out = jax_powersgd_cifar10.run(cfg, preset="small", mesh=make_mesh(devices=jax.devices()[:1]),
                                       max_steps_per_epoch=2)
    finally:
        jax_powersgd_cifar10.train_loop = loop
    return variables, kept["q0"], out, [json.loads(x) for x in open(cfg.event_log)]


def _counts(records, port):
    """Kinds and counts of the records, and of the spans by name; the JAX
    run's loader plane left out, its audit span under the port's name."""
    kinds = collections.Counter(r["event"] for r in records if r["event"] not in ("span", "loader"))
    names = collections.Counter(
        {"audit/compile": "audit/record"}.get(r["name"], r["name"]) for r in records
        if r["event"] == "span" and r["name"] != "data_load/stage"
    )
    return kinds, names


def test_powersgd_run_log_matches_the_jax_run(tmp_path, tmp_path_factory, monkeypatch):
    variables, q0, jax_out, jax_records = _jax_run(str(tmp_path_factory.mktemp("jax_run")))
    build = powersgd_cifar10.build

    def from_jax(*args, **kwargs):
        model, step, state = build(*args, **kwargs)
        model.load_state_dict(resnet_state_dict_from_flax(to_plain(variables)))
        state.reducer_state = powersgd_state_from_jax(q0, variables["params"], step.reducer, model)
        return model, step, state

    def to_plain(v):
        return jax.tree_util.tree_map(np.asarray, v)

    monkeypatch.setattr(powersgd_cifar10, "build", from_jax)
    cfg = ExperimentConfig(training_epochs=1, global_batch_size=16, learning_rate=0.01, reducer_rank=2,
                           event_log=str(tmp_path / "port.jsonl"), health_every=1)
    out = powersgd_cifar10.run(cfg, preset="small", device="cpu", max_steps_per_epoch=2)
    records = [json.loads(x) for x in open(cfg.event_log)]
    assert _counts(records, True) == _counts(jax_records, False)
    (audit,), (jaudit,) = ([r for r in recs if r["event"] == "compile"] for recs in (records, jax_records))
    assert audit["exact"] and audit["analytic_bytes"] == jaudit["analytic_bytes"] == out["bits_per_step"] // 8
    assert audit["comm_config"] == jaudit["comm_config"]
    np.testing.assert_allclose(out["losses"], [r["loss"] for r in jax_records if r["event"] == "step"],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    health, jhealth = ([r for r in recs if r["event"] == "train_health"] for recs in (records, jax_records))
    for got, want in zip(health, jhealth):
        for key in ("grad_norm", "ef_memory_norm", "powersgd_rel_error", "loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=RUN_PROBE_TOL, atol=RUN_PROBE_TOL, err_msg=key)
    ledger_tags = {r["tag"] for r in records if r["event"] == "collective"}
    assert {r["tag"] for r in records if r["event"] == "fidelity"} <= ledger_tags


def test_fsdp_entry_audits_its_ledger(tmp_path):
    cfg = ExperimentConfig(training_epochs=1, global_batch_size=16, event_log=str(tmp_path / "f.jsonl"))
    out = exact_cifar10.run(cfg, preset="small", device="cpu", strategy="fsdp", max_steps_per_epoch=1)
    records = [json.loads(x) for x in open(cfg.event_log)]
    (audit,) = [r for r in records if r["event"] == "compile"]
    assert audit["exact"] and audit["analytic_bytes"] * 8 == out["bits_per_step"]
    assert [r["tag"] for r in records if r["event"] == "collective"] == [
        "fsdp.param-gather", "fsdp.grad-scatter", "loss-sync"]
    assert not [r for r in records if r["event"] == "train_health"]  # the FSDP step has no probe


def test_diloco_emits_a_data_drop_for_a_malformed_batch(tmp_path, monkeypatch):
    real = diloco_cifar10.iterate_batches

    def with_a_bad_batch(*args, **kwargs):
        for i, (x, y) in enumerate(real(*args, **kwargs)):
            if i == 1:
                yield x, y[:-3]
            else:
                yield x, y

    monkeypatch.setattr(diloco_cifar10, "iterate_batches", with_a_bad_batch)
    cfg = ExperimentConfig(training_epochs=1, global_batch_size=16, event_log=str(tmp_path / "d.jsonl"))
    out = diloco_cifar10.run(cfg, preset="small", device="cpu", sync_every=2, max_steps_per_epoch=4)
    drops = [json.loads(x) for x in open(cfg.event_log) if '"data_drop"' in x]
    assert out["skipped_batches"] == 1 and len(drops) == 1
    assert (drops[0]["dropped_batches"], drops[0]["dropped_samples"], drops[0]["label"]) == (1, 16, "diloco_cifar10")
    steps = [json.loads(x) for x in open(cfg.event_log) if '"event": "step"' in x]
    assert len(steps) == out["rounds"]


def test_bare_init_and_serve_gpt_write_their_run_logs(tmp_path, capsys):
    path = str(tmp_path / "b.jsonl")
    bare_init.run(ExperimentConfig(training_epochs=0, event_log=path), device="cpu")
    notes = [json.loads(x)["message"] for x in open(path)]
    assert "Distributed Initialization (PyTorch, Gloo)" in notes[1] and "backend gloo" in notes[3]
    assert capsys.readouterr().out == ""  # the banners are on standard error
    path = str(tmp_path / "s.jsonl")
    out = serve_gpt.run(ExperimentConfig(event_log=path), preset="small", device="cpu", requests=4, request_rate=0.0,
                        max_new_tokens=4)
    requests = [json.loads(x) for x in open(path) if '"event": "request"' in x]
    assert len(requests) == 4 == out["live_requests_total"] and all(r["state"] == "finished" for r in requests)
