"""The geo-resilient plane of the port against the JAX package's: the
partition policy and the outer-sync driver (the cases of
``tests/test_geo_resilience.py``), and ``make_hierarchical_train_fn`` on
four Gloo ranks as a 2 x 2 grid against the JAX function on a 2 x 2 mesh
of CPU devices (the cases of ``tests/test_hierarchical.py``): exact site
averaging, PowerSGD outer reductions synchronous and async, an inner
optimizer of its own, and local rounds then a rejoin; the bits by level.

Tolerance: parameters and site losses within rtol = atol = 1e-5 of the
JAX rounds (the frameworks' matmuls, Gram-Schmidt and all-reduces sum in
other orders); what the JAX tests pin bitwise inside one framework (the
copies equal at a sync point, a site's copies equal during a partition)
is held bitwise here too; the bits exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from network_distributed_pytorch_tpu.observe import MemorySink as JaxMemorySink
from network_distributed_pytorch_tpu.observe import Telemetry as JaxTelemetry
from network_distributed_pytorch_tpu.parallel import make_mesh
from network_distributed_pytorch_tpu.parallel.hierarchical import make_hierarchical_train_fn as jax_hier_fn
from network_distributed_pytorch_tpu.parallel.reducers import ExactReducer as JaxExactReducer
from network_distributed_pytorch_tpu.parallel.reducers import PowerSGDReducer as JaxPowerSGDReducer
from network_distributed_pytorch_tpu.parallel.trainer import stateless_loss
from network_distributed_pytorch_tpu.resilience import guards as jax_guards
from network_distributed_pytorch_tpu_torch.observe import MemorySink, Telemetry
from network_distributed_pytorch_tpu_torch.resilience import guards
from torch_adaptive_worker import geo_rank
from torch_worker import few_torch_threads, run_all, spawn  # few_torch_threads: autouse

WORLD, SITES, H = 4, 2, 4
TOL = 1e-5
EXACT = {"outer_learning_rate": 1.0, "outer_momentum": 0.0, "outer_nesterov": False, "inner_algorithm": "sgd_plain",
         "inner_learning_rate": 0.05, "outer_async": False}
ASYNC = {"outer_learning_rate": 0.5, "outer_momentum": 0.5, "outer_nesterov": False, "inner_algorithm": "sgd_plain",
         "inner_learning_rate": 0.05}
CASES = {
    # name: (kwargs with "outer", the rounds)
    "sync_exact": ({**EXACT, "outer": "exact"}, ["sync"] * 3),
    "powersgd_sync": ({"outer": 2, "inner_learning_rate": 0.05, "outer_async": False, "sync_every": H},
                      ["sync"] * 2),
    "powersgd_async": ({**ASYNC, "outer": 2, "outer_async": True}, ["sync"] * 3),
    "optax_inner": ({"outer": 2, "inner_algorithm": "optax", "outer_async": True}, ["sync"] * 2),
    "partition_rejoin": ({**EXACT, "outer": 1, "outer_learning_rate": 0.7}, ["sync", "sync", "local", "local",
                                                                               "sync", "sync"]),
}


def _rounds(n):
    """``n`` rounds of ``H`` global batches of 64 regression samples."""
    rng = np.random.RandomState(0)
    w_true = rng.randn(16, 4).astype(np.float32)
    out = []
    for _ in range(n):
        batches = []
        for _ in range(H):
            x = rng.randn(64, 16).astype(np.float32)
            batches.append((x, (x @ w_true + 0.1 * rng.randn(64, 4)).astype(np.float32)))
        out.append(batches)
    return out


def _loss(p, batch):
    x, y = batch
    return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)


def _jax_case(kwargs, plan, rounds):
    kwargs = dict(kwargs)
    outer = kwargs.pop("outer")
    kwargs.setdefault("sync_every", H)
    if kwargs.get("inner_algorithm") == "optax":
        kwargs["inner_optimizer"] = optax.sgd(0.05)
    reducer = JaxExactReducer() if outer == "exact" else JaxPowerSGDReducer(
        random_seed=1, compression_rank=outer, matricize="last"
    )
    mesh = make_mesh(axis_sizes=(SITES, WORLD // SITES), axis_names=("dcn", "ici"), devices=jax.devices()[:WORLD])
    params = {"w": jnp.zeros((16, 4)), "b": jnp.zeros((4,))}
    fn = jax_hier_fn(stateless_loss(_loss), params, outer_reducer=reducer, mesh=mesh, donate_state=False, **kwargs)
    state = fn.init_state(params)
    q = None if outer == "exact" else np.asarray(state.reducer_state.q_memory)
    per_round = []
    for kind, batches in zip(plan, rounds):
        stacked = tuple(jnp.asarray(np.stack([b[i] for b in batches])) for i in range(2))
        state, losses = fn(state, stacked, local=kind == "local")
        per_round.append({"w": np.asarray(state.params["w"]), "b": np.asarray(state.params["b"]),
                          "losses": np.asarray(losses)})
    bits = {"round": fn.bits_per_round, "local": fn.local_bits_per_round, "inner": fn.inner_bits_per_round,
            "outer": fn.outer_bits_per_round, "ledger": fn.ledger.by_tag()}
    return per_round, q, bits, np.asarray(fn.eval_params(state)["w"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rounds = _rounds(max(len(plan) for _, plan in CASES.values()))
    jax_out = {name: _jax_case(kw, plan, rounds) for name, (kw, plan) in CASES.items()}
    q_port = {}
    for name, (kw, _) in CASES.items():
        if kw["outer"] != "exact":
            q_port[kw["outer"]] = torch.from_numpy(np.array(jax_out[name][1]))
    port_cases = {name: ({"sync_every": H, **kw}, plan) for name, (kw, plan) in CASES.items()}
    ranks = spawn(run_all, WORLD, tmp_path_factory.mktemp("ranks"), [(geo_rank, (rounds, port_cases, q_port))])
    return jax_out, [r[0] for r in ranks]


def test_grid_groups(runs):
    _, ranks = runs
    for rank, res in enumerate(ranks):
        assert res["inner_ranks"] == ((0, 1) if rank < 2 else (2, 3))
        assert res["outer_ranks"] == ((0, 2) if rank % 2 == 0 else (1, 3))


@pytest.mark.parametrize("name", list(CASES))
def test_rounds_match_the_jax_rounds(runs, name):
    """Every rank's parameters after every round within TOL of its JAX
    worker's copy, and its site losses of its site's; the evaluation mean
    too."""
    jax_out, ranks = runs
    j_rounds, _, _, j_eval = jax_out[name]
    for rank, res in enumerate(ranks):
        for i, (got, want) in enumerate(zip(res[name]["rounds"], j_rounds)):
            np.testing.assert_allclose(got["w"].numpy().T, want["w"][rank], rtol=TOL, atol=TOL, err_msg=f"{name} {i}")
            np.testing.assert_allclose(got["b"].numpy(), want["b"][rank], rtol=TOL, atol=TOL, err_msg=f"{name} {i}")
            np.testing.assert_allclose(got["losses"].numpy(), want["losses"][rank // 2], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(res[name]["eval_w"].numpy().T, j_eval, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", [n for n, (_, plan) in CASES.items() if "local" not in plan])
def test_copies_are_equal_at_every_sync(runs, name):
    _, ranks = runs
    for i in range(len(CASES[name][1])):
        for res in ranks[1:]:
            assert torch.equal(res[name]["rounds"][i]["w"], ranks[0][name]["rounds"][i]["w"])


def test_local_rounds_then_rejoin(runs):
    """During the partition each site's copies stay equal bit for bit and
    the sites diverge; the rejoin sync makes every copy equal again, and
    the local rounds issue no collective over the outer groups."""
    _, ranks = runs
    plan = CASES["partition_rejoin"][1]
    for i, kind in enumerate(plan):
        ws = [r["partition_rejoin"]["rounds"][i]["w"] for r in ranks]
        if kind == "local":
            assert torch.equal(ws[0], ws[1]) and torch.equal(ws[2], ws[3]) and not torch.equal(ws[0], ws[2])
            for res in ranks:
                rec = res["partition_rejoin"]["rounds"][i]["records"]
                assert all(r[1] == res["inner_ranks"] for r in rec)
        else:
            assert all(torch.equal(w, ws[0]) for w in ws)


@pytest.mark.parametrize("name", list(CASES))
def test_bits_by_level_equal_the_jax_bits_and_the_recorded(runs, name):
    jax_out, ranks = runs
    j_bits = jax_out[name][2]
    for res in ranks:
        bits = res[name]["bits"]
        assert bits == j_bits
        assert bits["round"] == bits["inner"] + bits["outer"]
        for kind, rnd in zip(CASES[name][1], res[name]["rounds"]):
            inner = 8 * sum(r[2] for r in rnd["records"] if r[1] == res["inner_ranks"])
            outer = 8 * sum(r[2] for r in rnd["records"] if r[1] == res["outer_ranks"])
            if kind == "local":
                assert (inner, outer) == (bits["local"], 0)
            else:
                assert (inner, outer) == (bits["inner"], bits["outer"])
    assert {"inner.step_grads", "inner.loss-sync", "inner.grads"} <= set(j_bits["ledger"])


# ---- the partition policy and the outer-sync driver ----------------------------------


SIDES = {"port": (guards, Telemetry, MemorySink), "jax": (jax_guards, JaxTelemetry, JaxMemorySink)}


def _events(sink):
    return [{k: v for k, v in r.items() if k not in ("ts", "ts_mono")} for r in sink.records]


def _policy_script(side):
    mod, Telemetry_, MemorySink_ = SIDES[side]
    sink = MemorySink_()
    policy = mod.PartitionPolicy(max_local_steps=16, telemetry=Telemetry_([sink]), rank=1, incarnation=2)
    policy.note_partition(edge=(0, 1), step=5, reason="test fault")
    policy.note_partition(edge=(0, 1), step=6)
    trace = [(policy.partitioned, policy.edge)]
    policy.note_local_round(8, step=6)
    policy.note_local_round(8, step=7)
    trace.append((policy.local_steps, policy.outer_staleness, policy.remaining_budget))
    with pytest.raises(mod.CommEscalationError):
        policy.note_local_round(8, step=8)
    healed = mod.PartitionPolicy(max_local_steps=16, telemetry=Telemetry_([sink]))
    healed.note_partition(edge=(0, 1), step=2)
    healed.note_local_round(8, step=3)
    healed.note_sync(step=4)
    trace.append((healed.partitioned, healed.outer_staleness, [e.phase for e in healed.events]))
    return trace, _events(sink)


def _driver_script(side):
    mod, Telemetry_, MemorySink_ = SIDES[side]
    sink = MemorySink_()
    down = {"v": False}
    policy = mod.PartitionPolicy(max_local_steps=32, telemetry=Telemetry_([sink]))
    driver = mod.OuterSyncDriver(policy, probes=[lambda: down["v"]], edge_probe=lambda: (0, 1))
    trace = [driver.should_sync(step=0)]
    driver.note_sync(step=0)
    down["v"] = True
    trace += [driver.should_sync(step=1), policy.partitioned, policy.edge]
    driver.note_local(8, step=1)
    trace.append(policy.local_steps)
    down["v"] = False
    trace.append(driver.should_sync(step=2))
    driver.note_sync(step=2)
    trace += [policy.partitioned, [e.phase for e in policy.events]]
    return trace, _events(sink)


def test_partition_policy_as_the_jax_policy():
    assert _policy_script("port") == _policy_script("jax")


def test_outer_sync_driver_as_the_jax_driver():
    port = _driver_script("port")
    assert port == _driver_script("jax")
    assert port[0][-1] == ["partitioned", "local", "rejoin"]


def test_driver_reads_an_outer_watchdog():
    """An expired outer deadline declares the edge dead (the JAX driver
    calls the watchdog's property as a function, which would raise: the
    port reads it); a completed sync starts a new attempt."""

    class Watchdog:
        expired_this_attempt = True
        attempts = 0

        def begin_attempt(self):
            self.attempts += 1
            self.expired_this_attempt = False

    wd = Watchdog()
    policy = guards.PartitionPolicy(max_local_steps=8)
    driver = guards.OuterSyncDriver(policy, watchdog=wd)
    assert not driver.should_sync(step=0) and policy.events[0].reason == "outer sync deadline expired"
    driver.note_local(4, step=0)
    driver.note_sync(step=1)
    assert wd.attempts == 1 and driver.should_sync(step=2) and not policy.partitioned
