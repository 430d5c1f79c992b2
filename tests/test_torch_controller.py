"""The port's fallback controller, its ladder, the cost model's canonical
config and the deadline derivations, against the JAX package's.

Each scenario of the JAX package's ``tests/test_controller.py`` runs on
both controllers, fed the same ``EpochHealth`` sequence (or nudges): the
decisions, the rung after each call, the streak-driven holds and the
``PolicyEvent`` records must be the same, field for field. The deadlines
are compared on the fabrics both tables hold (the GbE rows) with
``pytest.approx`` at its default 1e-6 (the same float expression in
both), the canonical config and the reordered ladders exactly.
"""

import pytest

from network_distributed_pytorch_tpu.observe import MemorySink as JaxMemorySink
from network_distributed_pytorch_tpu.observe import Telemetry as JaxTelemetry
from network_distributed_pytorch_tpu.observe import costmodel as jax_costmodel
from network_distributed_pytorch_tpu.resilience import controller as jax_controller
from network_distributed_pytorch_tpu.resilience import guards as jax_guards
from network_distributed_pytorch_tpu_torch.observe import MemorySink, Telemetry, costmodel
from network_distributed_pytorch_tpu_torch.resilience import controller, guards

SIDES = {
    "port": (controller, Telemetry, MemorySink),
    "jax": (jax_controller, JaxTelemetry, JaxMemorySink),
}


def _h(mod, epoch=0, achieved=0.0, expiries=0, degraded=0, stragglers=0):
    return mod.EpochHealth(
        epoch=epoch, step_p50_s=0.01, achieved_bytes_per_s=achieved, deadline_expiries=expiries,
        degraded_steps=degraded, stragglers=stragglers,
    )


def _decision(d):
    if d is None:
        return None
    return (d.action, d.trigger, d.epoch, d.rung_before, d.rung_after, d.rung_index_before, d.rung_index_after,
            d.overrides)


# each scenario: (controller kwargs, calls), a call ("observe", health kwargs)
# or ("nudge", alert, epoch, severity)
SCENARIOS = {
    "descend_to_bottom": ({"descend_after": 1}, [("observe", {"epoch": e, "expiries": 1}) for e in range(10)]),
    "consecutive_degraded": ({"descend_after": 2}, [
        ("observe", {"epoch": 0, "degraded": 1}), ("observe", {"epoch": 1}),
        ("observe", {"epoch": 2, "degraded": 1}), ("observe", {"epoch": 3, "degraded": 1}),
    ]),
    "consecutive_healthy": ({"start_index": 1, "recover_after": 2}, [
        ("observe", {"epoch": 0, "achieved": 100.0}), ("observe", {"epoch": 1, "achieved": 60.0}),
        ("observe", {"epoch": 2, "achieved": 100.0}), ("observe", {"epoch": 3, "achieved": 95.0}),
    ]),
    "top_rung_holds": ({"recover_after": 1}, [
        ("observe", {"epoch": 0, "achieved": 10.0}), ("observe", {"epoch": 1, "achieved": 10.0}),
    ]),
    "bandwidth_collapse": ({"descend_after": 1, "degrade_factor": 0.5}, [
        ("observe", {"epoch": 0, "achieved": 100.0}), ("observe", {"epoch": 1, "achieved": 40.0}),
        ("observe", {"epoch": 2, "achieved": 40.0}),
    ]),
    "expiries": ({"descend_after": 1}, [("observe", {"expiries": 1})]),
    "degraded_steps": ({"descend_after": 1}, [("observe", {"degraded": 2})]),
    "stragglers": ({"descend_after": 1}, [("observe", {"stragglers": 3})]),
    "nudge_critical": ({"descend_after": 3}, [("nudge", "grad_spike", 2, "critical")]),
    "nudge_comm_warn": ({"descend_after": 3}, [
        ("nudge", "bandwidth_collapse", 0, "warn"), ("nudge", "step_time_drift", 1, "warn"),
    ]),
    "nudge_precharge": ({"descend_after": 2}, [
        ("nudge", "grad_spike", 0, "warn"), ("observe", {"epoch": 0, "degraded": 1}),
    ]),
    "nudge_once_an_epoch": ({}, [
        ("nudge", "grad_spike", 1, "critical"), ("nudge", "bandwidth_collapse", 1, "warn"),
        ("nudge", "grad_spike", 2, "critical"),
    ]),
    "nudged_epoch_observe_noop": ({"descend_after": 1}, [
        ("nudge", "grad_spike", 3, "critical"), ("observe", {"epoch": 3, "expiries": 5, "degraded": 9}),
        ("observe", {"epoch": 4, "degraded": 1}),
    ]),
    "nudge_fidelity_ascends": ({"start_index": 3}, [
        ("nudge", "fidelity_collapse", 0, "warn"), ("nudge", "ef_blowup", 1, "critical"),
    ]),
    "nudge_bottom_holds": ({"start_index": 7}, [("nudge", "grad_spike", 0, "critical")]),
    "walk_down_and_back": ({"descend_after": 1, "recover_after": 2}, [
        ("observe", {"epoch": 0, "achieved": 100.0}), ("observe", {"epoch": 1, "expiries": 2, "achieved": 90.0}),
        ("observe", {"epoch": 2, "achieved": 50.0}), ("observe", {"epoch": 3, "achieved": 50.0}),
        ("observe", {"epoch": 4, "achieved": 49.0}), ("observe", {"epoch": 5, "achieved": 48.0}),
    ]),
}


def _play(side, kwargs, calls):
    mod, Telemetry_, MemorySink_ = SIDES[side]
    sink = MemorySink_()
    c = mod.FallbackController(telemetry=Telemetry_([sink]), rank=3, **kwargs)
    trace = []
    for call in calls:
        if call[0] == "observe":
            d = c.observe(_h(mod, **call[1]))
        else:
            d = c.nudge(call[1], call[2], severity=call[3])
        if d is not None:
            c.record(d, predicted_bytes_per_step=1348.0, realized_bytes_per_step=4428.0)
        trace.append((_decision(d), c.index, c.rung.name, c.overrides, c.nudged_epoch))
    policies = [{k: v for k, v in r.items() if k not in ("ts", "ts_mono")} for r in sink.records
                if r.get("event") == "policy"]
    return trace, policies, [_decision(d) for d in c.decisions]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_controller_walks_as_the_jax_controller(name):
    kwargs, calls = SCENARIOS[name]
    port, ref = _play("port", kwargs, calls), _play("jax", kwargs, calls)
    assert port == ref


def test_default_ladder_and_validation():
    assert [(r.name, r.overrides) for r in controller.DEFAULT_LADDER] == [
        (r.name, r.overrides) for r in jax_controller.DEFAULT_LADDER
    ]
    assert len(controller.DEFAULT_LADDER) == 8
    with pytest.raises(ValueError, match="at least one rung"):
        controller.FallbackController(ladder=[])
    with pytest.raises(ValueError, match="outside ladder"):
        controller.FallbackController(start_index=8)
    c = controller.FallbackController(ladder=[controller.Rung("a", {}), controller.Rung("b", {"comm_chunks": 2})])
    d = c.observe(_h(controller, expiries=1))
    d.overrides["comm_chunks"] = 999  # the decision's copy, never the rung
    assert c.overrides == {"comm_chunks": 2}


PLANS = [
    ({"ladder": {"10GbE": ["compress", "ring"]}}, "10GbE", None),
    ({"ladder": {"10GbE": ["compress", "bogus", "baseline"]}}, "10GbE", 3),
    ({"ladder": {"10GbE": ["compress"]}}, "1GbE", None),
    ({}, "NVLink4(H100)", None),
    ({"ladder": {"NVLink4(H100)": ["baseline", "compress", "compress-low-rank"]}}, "NVLink4(H100)", None),
]


@pytest.mark.parametrize("plan,fabric,max_rungs", PLANS)
def test_ladder_from_plan_as_the_jax_one(plan, fabric, max_rungs):
    got = controller.ladder_from_plan(plan, fabric, max_rungs=max_rungs)
    want = jax_controller.ladder_from_plan(plan, fabric, max_rungs=max_rungs)
    assert [(r.name, r.overrides) for r in got] == [(r.name, r.overrides) for r in want]


CONFIGS = [
    None, {}, {"reducer": "PowerSGDReducer"}, {"reducer": "powersgd", "reducer_rank": 4, "comm_chunks": 8},
    {"reducer": "HierarchicalReducer", "reducer_rank": 1, "sync_every": 8, "outer_async": 1, "sites": 2},
    {"reducer": "exactreducer", "comm_strategy": "ring", "bucket_bytes": 1 << 20, "name": "x"},
    {"reducer": "topk"}, {"sync_every": 0},
]


@pytest.mark.parametrize("config", CONFIGS)
def test_canonical_config_as_the_jax_one(config):
    assert costmodel.canonical_config(config, "n") == jax_costmodel.canonical_config(config, "n")


@pytest.mark.parametrize("fabric", ["1GbE", "10GbE", "100GbE"])
@pytest.mark.parametrize("payload,workers,p50,slack,floor", [
    (16, 8, None, 4.0, 0.25), (16, 8, 0.1, 4.0, 0.05), (100 << 20, 8, None, 2.0, 0.05), (64 << 20, 2, 0.3, 1.0, 0.5),
])
def test_deadlines_as_the_jax_ones(fabric, payload, workers, p50, slack, floor):
    kw = dict(measured_p50_s=p50, slack=slack, floor_s=floor)
    assert guards.derive_collective_deadline(payload, workers, fabric, **kw) == pytest.approx(
        jax_guards.derive_collective_deadline(payload, workers, fabric, **kw)
    )
    assert guards.derive_outer_deadline(payload, workers, fabric) == pytest.approx(
        jax_guards.derive_outer_deadline(payload, workers, fabric)
    )


def test_deadlines_scale_with_the_fabric_and_the_floor():
    assert guards.derive_collective_deadline(16, 8, "NVLink4(H100)") == 0.05  # the floor
    assert guards.derive_outer_deadline(64, 2, "1GbE") >= 0.25
    big, small = (guards.derive_collective_deadline(100 << 20, 8, f, slack=2.0) for f in ("1GbE", "10GbE"))
    assert big > small > 0.05
