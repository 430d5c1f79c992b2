"""The health and fidelity probe (``parallel/trainer.make_health_fn``, the
reducers' diagnostic round) and the fidelity plane (``observe/fidelity.py``)
against the JAX package's.

The probe is held to the JAX ``make_health_fn`` (one process, ``mesh=None``)
on the state two JAX steps left, carried into the port by the importers,
and the same probe batch: the port's PowerSGD on its xla pipeline and on
the plain versions of the fused kernels, both against the JAX XLA path
(the JAX fused Pallas path is not an oracle inside ``shard_map`` on this
jax, ROADMAP.md §C), and the exact reducer. Tolerance: ``torch_parity``'s
fp32 class, rtol = atol = 1e-5, on every value, the compression errors and
cosines included (measured for PowerSGD on either pipeline: at most
2.4e-7 apart on the norms and the loss, 0 on the whole send's error, 7.5e-7
on a shape group's error and cosine after Gram-Schmidt at r = 4, and 2.7e-7
on a group's EF norm).

Then the probe's contract: it leaves the training state bit for bit as it
found it (parameters, momenta, EF memories, BatchNorm buffers, Q, the
reducer's generator under ``reuse_query=False``, the global generator, no
``.grad``), so a run with the probe is bitwise a run without it; it samples
microbatch 0 under accumulation; an exact reducer reads 0 and 1 by
construction; the hierarchical reducer reports its outer stage; an error in
the probe is a ``health_probe_error`` and the run goes on.

And the streaming detectors (``observe/health.py``) against the JAX
package's, record for record on numpy-seeded streams: each of the nine
(grad-norm spike and NaN, loss plateau, step-time drift, bandwidth collapse
on the aggregate and on an edge, SLO burn, HBM headroom, fidelity
collapse, EF blow-up, outer staleness), ``Ewma``, ``DetectorConfig``'s
defaults, ``HealthMonitor``'s per-rank isolation and ``fired_by_kind``,
and the flagship's stuck-at-1.0 fidelity groups, which page critically at
the second probe in both packages (the reference's semantics, kept).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.experiments.common import image_classifier_loss as jax_loss_fn
from network_distributed_pytorch_tpu.models import resnet18 as jax_resnet18
from network_distributed_pytorch_tpu.observe import fidelity as jax_fidelity
from network_distributed_pytorch_tpu.observe import health as jax_health
from network_distributed_pytorch_tpu.parallel.reducers import ExactReducer as JaxExact
from network_distributed_pytorch_tpu.parallel.reducers import PowerSGDReducer as JaxPowerSGD
from network_distributed_pytorch_tpu.parallel.trainer import make_train_step as jax_make_train_step
from network_distributed_pytorch_tpu_torch.experiments.common import image_classifier_loss, train_loop
from network_distributed_pytorch_tpu_torch.models.import_weights import powersgd_state_from_jax, resnet_state_dict_from_flax
from network_distributed_pytorch_tpu_torch.models.resnet import resnet18
from network_distributed_pytorch_tpu_torch.observe import MemorySink, Telemetry, fidelity, health
from network_distributed_pytorch_tpu_torch.observe.ledger import WireLedger
from network_distributed_pytorch_tpu_torch.parallel.hierarchical import HierarchicalReducer
from network_distributed_pytorch_tpu_torch.parallel.reducers import ExactReducer, PowerSGDReducer
from network_distributed_pytorch_tpu_torch.parallel.trainer import make_health_fn, make_train_step
from torch_parity import random_flax_variables, to_numpy
from torch_worker import few_torch_threads, numpy_batches  # noqa: F401 (few_torch_threads: autouse)

TOL = 1e-5
LR = 0.01
PROBE_BATCH = numpy_batches(seed=13, n_steps=1, batch=8)[0]


@functools.lru_cache(maxsize=None)
def _jax_probe(reducer_name):
    """The JAX state after two steps of the small ResNet-18 and its probe
    on ``PROBE_BATCH``."""
    model = jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16)
    variables = random_flax_variables(model, (1, 32, 32, 3), seed=11)
    if reducer_name == "exact":
        reducer, algorithm = JaxExact(), "sgd"
    else:
        reducer, algorithm = JaxPowerSGD(random_seed=1, compression_rank=4, matricize="last"), "ef_momentum"
    step = jax_make_train_step(
        jax_loss_fn(model, has_batch_stats=True), reducer, variables["params"], LR, momentum=0.9,
        algorithm=algorithm, mesh=None, donate_state=False,
    )
    state = step.init_state(variables["params"], model_state={"batch_stats": variables["batch_stats"]})
    for b in numpy_batches(seed=12, n_steps=2, batch=8):
        state, _ = step(state, tuple(jnp.asarray(a) for a in b))
    stats = jax.device_get(step.health_fn(state, tuple(jnp.asarray(a) for a in PROBE_BATCH)))
    return to_numpy(variables), state, stats


def _port_probe(reducer_name):
    """The port's probe on the JAX state, carried by the importers."""
    variables, jstate, _ = _jax_probe(reducer_name)
    model = resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device="cpu")
    model.load_state_dict(resnet_state_dict_from_flax(
        {"params": to_numpy(jstate.params), "batch_stats": to_numpy(jstate.model_state["batch_stats"])}
    ))
    if reducer_name == "exact":
        reducer, algorithm = ExactReducer(), "sgd"
    else:
        impl = "pallas" if reducer_name == "powersgd_fused" else "xla"
        reducer = PowerSGDReducer(random_seed=1, compression_rank=4, matricize="last", compress_impl=impl)
        algorithm = "ef_momentum"
    step = make_train_step(image_classifier_loss(), reducer, model, LR, 0.9, algorithm)
    state = step.init_state()
    memories = resnet_state_dict_from_flax({"params": to_numpy(jstate.memories)})
    state.memories = {k: memories[k].clone() for k in state.params}
    if reducer_name != "exact":
        state.reducer_state = powersgd_state_from_jax(
            np.asarray(jstate.reducer_state.q_memory), variables["params"], reducer, model
        )
    return step, state, step.health_fn(state, tuple(torch.from_numpy(a) for a in PROBE_BATCH))


def _by_shape(fid):
    """Fidelity groups keyed by their shape (each package numbers the shape
    groups in its own leaf order)."""
    return {k.split(":")[-1]: v for k, v in fid.items()}


@pytest.mark.parametrize("reducer_name", ["powersgd_xla", "powersgd_fused", "exact"])
def test_probe_matches_jax_make_health_fn(reducer_name):
    _, _, want = _jax_probe("exact" if reducer_name == "exact" else "powersgd")
    _, _, got = _port_probe(reducer_name)
    for key in ("grad_norm", "ef_memory_norm", "powersgd_rel_error", "loss"):
        np.testing.assert_allclose(got[key], float(want[key]), rtol=TOL, atol=TOL, err_msg=key)
    got_f, want_f = _by_shape(got["fidelity"]), _by_shape(want["fidelity"])
    assert sorted(got_f) == sorted(want_f)
    for group, vals in want_f.items():
        for k, v in vals.items():
            np.testing.assert_allclose(got_f[group][k], float(v), rtol=TOL, atol=TOL, err_msg=f"{group} {k}")


def test_probe_compression_error_is_the_reducers_own():
    """The probe's error is ``compression_error`` of the send, and its
    groups are ``fidelity_stats`` (one round gives both)."""
    step, state, got = _port_probe("powersgd_xla")
    names = list(state.params)
    grads = torch.autograd.grad(
        image_classifier_loss()(step.model, tuple(torch.from_numpy(a) for a in PROBE_BATCH)),
        [state.params[k] for k in names],
    )
    send = [g + state.memories[k] for g, k in zip(grads, names)]
    assert step.reducer.compression_error(state.reducer_state, send).item() == pytest.approx(
        got["powersgd_rel_error"], rel=1e-6)
    stats = step.reducer.fidelity_stats(state.reducer_state, send, [state.memories[k] for k in names])
    assert sorted(stats) == sorted(got["fidelity"])


def _snapshot(step, state):
    out = {f"params.{k}": v.detach().clone() for k, v in state.params.items()}
    out.update({f"momenta.{k}": v.clone() for k, v in state.momenta.items()})
    out.update({f"memories.{k}": v.clone() for k, v in state.memories.items()})
    out.update({f"buffers.{k}": v.clone() for k, v in step.model.named_buffers()})
    rs = state.reducer_state
    if hasattr(rs, "q_memory"):
        out["q_memory"] = rs.q_memory.clone()
        out["generator"] = rs.generator.get_state()
    out["global_generator"] = torch.get_rng_state()
    return out


def _equal(a, b):
    return sorted(a) == sorted(b) and [k for k in a if not torch.equal(a[k], b[k])] == []


@pytest.mark.parametrize("compress_impl", ["xla", "pallas"])
@pytest.mark.parametrize("reuse_query", [True, False], ids=["reuse_query", "fresh_query"])
def test_probe_leaves_the_state_bit_for_bit(compress_impl, reuse_query):
    """Two runs of three steps from the same seed, one with the probe after
    every step: the probe changes nothing it reads, sets no ``.grad``, and
    the two runs end bit for bit equal (the generator that redraws Q under
    ``reuse_query=False`` included)."""
    batches = [tuple(torch.from_numpy(a) for a in b) for b in numpy_batches(seed=21, n_steps=3, batch=8, hw=16)]
    finals = []
    for probe in (False, True):
        model = resnet18(num_classes=10, norm="batch", stem="cifar", width=8, device="cpu", seed=3)
        reducer = PowerSGDReducer(
            random_seed=7, compression_rank=2, matricize="last", reuse_query=reuse_query, compress_impl=compress_impl
        )
        step = make_train_step(image_classifier_loss(), reducer, model, 0.05, 0.9, "ef_momentum")
        state = step.init_state()
        torch.manual_seed(5)
        for b in batches:
            state, _ = step(state, b)
            if probe:
                before = _snapshot(step, state)
                stats = step.health_fn(state, b)
                assert _equal(before, _snapshot(step, state))
                assert all(p.grad is None for p in model.parameters()) and model.training
                assert np.isfinite(stats["powersgd_rel_error"]) and stats["grad_norm"] > 0
        finals.append(_snapshot(step, state))
    assert _equal(finals[0], finals[1])


def test_probe_samples_microbatch_zero_under_accumulation():
    model = resnet18(num_classes=10, norm="batch", stem="cifar", width=8, device="cpu", seed=3)
    reducer = PowerSGDReducer(random_seed=7, compression_rank=2, matricize="last")
    step = make_train_step(image_classifier_loss(), reducer, model, 0.05, 0.9, "ef_momentum", accum_steps=2)
    state = step.init_state()
    x, y = numpy_batches(seed=22, n_steps=1, batch=8, hw=16)[0]
    batch = (torch.from_numpy(x.reshape(2, 4, 16, 16, 3)), torch.from_numpy(y.reshape(2, 4)))
    state, _ = step(state, batch)
    single = make_health_fn(image_classifier_loss(), reducer, model, None, accum_steps=1)
    assert step.health_fn(state, batch) == single(state, (batch[0][0], batch[1][0]))


@pytest.mark.parametrize("bucket_bytes", [None, 2_000])
def test_exact_reducer_reads_zero_error_a_bucket(bucket_bytes):
    model = resnet18(num_classes=10, norm="batch", stem="cifar", width=8, device="cpu", seed=3)
    reducer = ExactReducer(bucket_bytes=bucket_bytes)
    step = make_train_step(image_classifier_loss(), reducer, model, 0.05, 0.9, "sgd")
    state = step.init_state()
    b = tuple(torch.from_numpy(a) for a in numpy_batches(seed=23, n_steps=1, batch=8, hw=16)[0])
    state, _ = step(state, b)
    stats = step.health_fn(state, b)
    assert stats["powersgd_rel_error"] == 0.0 and stats["ef_memory_norm"] == 0.0
    tags = reducer.fidelity_group_tags(list(state.params.values()))
    assert sorted(stats["fidelity"]) == sorted(tags) and len(tags) == (1 if bucket_bytes is None else len(tags))
    assert set(tags.values()) == set(WireLedger(step.ledger.entries).by_tag()) - {"loss-sync"}
    assert all(v == {"rel_error": 0.0, "cosine_sim": 1.0, "ef_norm": 0.0, "quantized_share": 0.0}
               for v in stats["fidelity"].values())


def test_hierarchical_reducer_reports_its_outer_stage():
    rng = np.random.RandomState(31)
    leaves = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((12, 8), (8,), (6, 4, 3, 3))]
    outer = PowerSGDReducer(compression_rank=2, matricize="last")
    hier = HierarchicalReducer(outer, None, None, 2, 2)
    state = hier.init(leaves)
    mems = [torch.from_numpy(rng.randn(*t.shape).astype(np.float32)) for t in leaves]
    rel, stats = hier.diagnose(state, leaves, mems)
    want_rel, want_stats = outer.diagnose(state, leaves, mems)
    assert rel.item() == want_rel.item() == hier.compression_error(state, leaves).item()
    assert sorted(stats) == sorted(["inner.grads"] + [f"outer.{g}" for g in want_stats])
    assert all(torch.equal(stats[f"outer.{g}"][k], v[k]) for g, v in want_stats.items() for k in v)
    tags = hier.fidelity_group_tags(leaves)
    assert sorted(tags) == sorted(stats)
    assert set(tags.values()) <= set(WireLedger(hier.ledger_entries(leaves)).by_tag())


def test_a_failing_probe_is_reported_and_the_run_goes_on():
    model = resnet18(num_classes=10, norm="batch", stem="cifar", width=8, device="cpu", seed=3)
    step = make_train_step(image_classifier_loss(), ExactReducer(), model, 0.05, 0.9, "sgd")
    wrapped = copy.copy(step)

    def broken(state, batch):
        raise RuntimeError("probe down")

    wrapped.health_fn = broken
    sink = MemorySink()
    batches = numpy_batches(seed=24, n_steps=2, batch=8, hw=16)
    _, logger = train_loop(
        wrapped, wrapped.init_state(), lambda e: iter(batches), 1, torch.device("cpu"),
        telemetry=Telemetry([sink]), health_every=1, run_name="broken",
    )
    assert len(logger.records) == 2
    failures = sink.of_kind("failure")
    assert [f["kind"] for f in failures] == ["health_probe_error"] * 2 and "probe down" in failures[0]["message"]


# ---- the fidelity plane against the JAX package's ----------------------------


def _fidelity_samples(seed=41, steps=(2, 4, 6), groups=("powersgd.g0:8x4r2", "powersgd.g1:6x6r2", "powersgd.rank1")):
    rng = np.random.RandomState(seed)
    return [
        (s, {g: {"rel_error": float(rng.rand()), "cosine_sim": float(rng.rand()), "ef_norm": float(rng.rand() * 3),
                 "quantized_share": 0.0} for g in groups})
        for s in steps
    ]


def test_fidelity_tracker_matches_jax():
    tags = {"powersgd.g0:8x4r2": "powersgd.P", "powersgd.g1:6x6r2": "powersgd.P", "powersgd.rank1": "powersgd.rank1"}
    ours, theirs = fidelity.FidelityTracker(tags, rank=1, label="x"), jax_fidelity.FidelityTracker(tags, rank=1, label="x")
    for step, stats in _fidelity_samples():
        drift = {"replica_drift": step * 0.1}
        got = [e.record() for e in ours.events(step, stats, epoch=0, drift=drift)]
        want = [e.record() for e in theirs.events(step, stats, epoch=0, drift=drift)]
        assert got == want and len(got) == 3


def _run_records():
    recs = []
    for step, stats in _fidelity_samples():
        recs += [e.record() for e in jax_fidelity.FidelityTracker().events(step, stats)]
    rng = np.random.RandomState(42)
    bits = 0
    for s in range(8):
        bits += 1000 * (s + 1)
        recs.append({"event": "step", "step": s, "epoch": s // 3, "loss": float(3 - 0.2 * s + rng.rand() * 0.1),
                     "bits_cumulative": bits})
    recs.append({"event": "policy", "epoch": 1, "action": "degrade", "rung_before": "exact", "rung_after": "powersgd_r4",
                 "rung_index_after": 1})
    return recs


def test_fidelity_summary_matches_jax():
    recs = _run_records()
    assert fidelity.fidelity_summary(recs) == jax_fidelity.fidelity_summary(recs)
    assert fidelity.fidelity_summary([])["samples"] == 0


def test_frontier_matches_jax():
    recs = _run_records()
    got = fidelity.frontier_from_events(recs)
    assert got == jax_fidelity.frontier_from_events(recs) and [r["rung"] for r in got["rungs"]] == ["exact", "powersgd_r4"]


# ---- the streaming detectors ---------------------------------------------------------


def _stream(seed, n, base, noise, spikes=()):
    """``n`` readings around ``base`` (relative noise ``noise``) from a seed,
    with ``{index: value}`` overrides."""
    rng = np.random.RandomState(seed)
    out = [float(base * (1.0 + noise * rng.randn())) for _ in range(n)]
    for i, v in dict(spikes).items():
        out[i] = float(v)
    return out


def _records(alerts):
    return [a.record() for a in alerts]


def test_ewma_and_config_are_the_jax_packages():
    assert health.DetectorConfig() == health.DetectorConfig(**vars(jax_health.DetectorConfig()))
    a, b = health.Ewma(0.1), jax_health.Ewma(0.1)
    for x in _stream(1, 50, 2.0, 0.3):
        a.update(x)
        b.update(x)
        assert (a.mean, a.std, a.n) == (b.mean, b.std, b.n)


DETECTOR_STREAMS = {
    # name: (stream, detector class name, extra kwargs of DetectorConfig)
    "spike_warn": (_stream(2, 40, 1.0, 0.01, {20: 10.0}), "GradNormSpikeDetector", {}),
    "spike_critical": (_stream(3, 40, 1.0, 0.01, {12: 1000.0, 30: 2000.0}), "GradNormSpikeDetector", {"cooldown": 5}),
    "nan": (_stream(4, 20, 1.0, 0.01, {5: float("nan"), 15: float("inf")}), "GradNormSpikeDetector", {"cooldown": 0}),
    "plateau": ([2.0 - 0.1 * i for i in range(10)] + _stream(5, 150, 1.0, 1e-6), "LossPlateauDetector", {}),
    "drift": (_stream(6, 30, 0.1, 0.02) + _stream(7, 30, 0.25, 0.02), "StepTimeDriftDetector", {}),
    "collapse": (_stream(8, 30, 1e9, 0.05) + _stream(9, 20, 1e8, 0.05), "BandwidthCollapseDetector", {}),
    "slo": (_stream(10, 20, 1.5, 0.1) + _stream(11, 20, 3.0, 0.1), "SloBurnRateDetector", {}),
    "hbm": ([0.5 + 0.05 * i for i in range(12)], "HbmHeadroomDetector", {"cooldown": 2}),
    "fidelity": (_stream(12, 10, 0.02, 0.1) + [0.2, 0.2, 0.8, 0.9, -1.0], "FidelityCollapseDetector", {"cooldown": 1}),
    "ef": (_stream(13, 10, 0.1, 0.05) + [0.6, 0.7, 3.0, 3.5], "EfBlowupDetector", {"cooldown": 1}),
    "staleness": ([i / 10 for i in range(12)], "OuterStalenessDetector", {"cooldown": 3}),
}


@pytest.mark.parametrize("name", sorted(DETECTOR_STREAMS))
def test_detector_fires_as_the_jax_detector(name):
    stream, cls, kw = DETECTOR_STREAMS[name]
    det = getattr(health, cls)(health.DetectorConfig(**kw))
    jdet = getattr(jax_health, cls)(jax_health.DetectorConfig(**kw))
    got = [det.observe(v, rank=1, step=i) for i, v in enumerate(stream)]
    want = [jdet.observe(v, rank=1, step=i) for i, v in enumerate(stream)]
    assert [a is None for a in got] == [a is None for a in want]
    assert _records(a for a in got if a) == _records(a for a in want if a)
    assert det.fired == jdet.fired >= 1, name


def _feed(monitor, seed):
    """The same mixed stream into a monitor: two ranks' grad norms (a spike
    on rank 0), step times (rank 1 drifts), losses, the aggregate rate and
    an edge's (it collapses), serving p99, HBM, staleness, and two fidelity
    groups (one degrades) with their EF norms."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(60):
        for r in (0, 1):
            gn = 1.0 + 0.01 * rng.randn()
            out += monitor.observe_grad_norm(500.0 if (r == 0 and i == 30) else gn, rank=r, step=i)
            st = 0.1 * (2.5 if (r == 1 and i >= 40) else 1.0) * (1 + 0.01 * rng.randn())
            out += monitor.observe_step_time(st, rank=r, step=i)
            out += monitor.observe_hbm(0.5e9 + 0.01e9 * i, 1e9, rank=r, step=i)
        out += monitor.observe_loss(1.0 + 1e-7 * rng.randn(), step=i)
        out += monitor.observe_bytes_per_s(1e9 * (1 + 0.01 * rng.randn()))
        out += monitor.observe_bytes_per_s(1e9 if i < 35 else 1e8, edge=(0, 1))
        out += monitor.observe_serving_p99(1.0 if i < 50 else 2.5)
        out += monitor.observe_outer_staleness(i % 20, 20, rank=0, step=i)
        out += monitor.observe_hbm(1.0, 0.0, rank=0)  # no limit: dropped
        for g, bad in (("g0", False), ("g1", i >= 45)):
            out += monitor.observe_fidelity(g, 0.9 if bad else 0.02 * (1 + 0.1 * rng.rand()), rank=0, step=i)
            out += monitor.observe_ef_norm(g, 2.0 if bad else 0.1, rank=0, step=i)
    return out


def test_health_monitor_is_the_jax_monitor():
    mon, jmon = health.HealthMonitor(), jax_health.HealthMonitor()
    got, want = _feed(mon, 21), _feed(jmon, 21)
    assert _records(got) == _records(want) == _records(jmon.alerts)
    assert mon.fired_by_kind() == jmon.fired_by_kind()
    kinds = mon.fired_by_kind()
    for k in ("grad_spike", "step_time_drift", "bandwidth_collapse", "slo_burn", "hbm_headroom", "fidelity_collapse",
              "ef_blowup", "outer_staleness", "loss_plateau"):
        assert kinds.get(k, 0) >= 1, (k, kinds)
    # per-rank isolation: the spike is rank 0's alone, the drift rank 1's
    assert {a.rank for a in got if a.alert == "grad_spike"} == {0}
    assert {a.rank for a in got if a.alert == "step_time_drift"} == {1}
    # the edge's collapse names the edge and blames its source rank
    edge = [a for a in got if a.alert == "bandwidth_collapse" and a.rank == 0]
    assert edge and edge[0].message.startswith("edge 0->1: ")
    # a fidelity page blames its group
    assert all(a.message.startswith("group g1: ") for a in got if a.alert in ("fidelity_collapse", "ef_blowup"))


def test_stuck_fidelity_groups_page_critically_at_the_second_probe():
    """Under PowerSGD 14 of ResNet-152's 21 groups read rel_error 1.0 at
    every probe: the fidelity detector calls any reading >= 0.5 critical
    after 2 samples, in both packages. So a run with the health probe and
    ``alert_restart_after`` would be recycled at its second probe: the
    reference's semantics, pinned here, not changed."""
    groups = [f"g{i}" for i in range(21)]
    mon, jmon = health.HealthMonitor(), jax_health.HealthMonitor()
    for probe in range(3):
        for i, g in enumerate(groups):
            rel = 1.0 if i < 14 else 0.01
            mon.observe_fidelity(g, rel, rank=0, step=probe)
            jmon.observe_fidelity(g, rel, rank=0, step=probe)
    assert _records(mon.alerts) == _records(jmon.alerts)
    assert len(mon.alerts) == 14
    assert {(a.severity, a.step) for a in mon.alerts} == {("critical", 1)}
