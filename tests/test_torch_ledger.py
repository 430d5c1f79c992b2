"""The wire ledger and its audit (``observe/ledger.py``) against the JAX
package's: ``ledger_entries`` of every ``ExactReducer`` layout, PowerSGD at
``comm_chunks`` None and 4 (and with a power iteration), the hierarchical
reducer, the fallback entry of a reducer without ``ledger_entries``, the
training step's and the FSDP step's ledgers (the loss-sync rule at one
process and on a group), the ledger's totals and events; then
``audit_recorded_step`` on two Gloo ranks, where each case's first step is
reconciled against what it issued and must read ``exact: true``.

Bucketed layouts: both packages fill DDP buckets in backward order of
their own leaves (flax's sorted paths against torch's parameter order), so
the split into buckets differs; the test holds their number of entries and
total bytes to JAX's and each port bucket to the port's own
``bucket_assignments``. Every other layout is held entry for entry.
"""

import jax
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.models import resnet18 as jax_resnet18
from network_distributed_pytorch_tpu.models.cnn import SmallCNN as JaxSmallCNN
from network_distributed_pytorch_tpu.observe import ledger as jax_ledger
from network_distributed_pytorch_tpu.parallel import fsdp as jax_fsdp
from network_distributed_pytorch_tpu.parallel import make_mesh
from network_distributed_pytorch_tpu.parallel.compression import TopKReducer as JaxTopK
from network_distributed_pytorch_tpu.parallel.hierarchical import HierarchicalReducer as JaxHierarchical
from network_distributed_pytorch_tpu.parallel.reducers import ExactReducer as JaxExact
from network_distributed_pytorch_tpu.parallel.reducers import PowerSGDReducer as JaxPowerSGD
from network_distributed_pytorch_tpu.parallel.trainer import make_train_step as jax_make_train_step
from network_distributed_pytorch_tpu.parallel.trainer import stateless_loss
from network_distributed_pytorch_tpu.utils.losses import cross_entropy_loss as jax_cross_entropy
from network_distributed_pytorch_tpu_torch.experiments.common import image_classifier_loss, process_group
from network_distributed_pytorch_tpu_torch.models.cnn import SmallCNN
from network_distributed_pytorch_tpu_torch.models.resnet import resnet18
from network_distributed_pytorch_tpu_torch.observe import ledger
from network_distributed_pytorch_tpu_torch.parallel.comm import CollectiveRecord, bucket_assignments, n_bits
from network_distributed_pytorch_tpu_torch.parallel.compression import TopKReducer
from network_distributed_pytorch_tpu_torch.parallel.fsdp import make_fsdp_train_step
from network_distributed_pytorch_tpu_torch.parallel.hierarchical import HierarchicalReducer
from network_distributed_pytorch_tpu_torch.parallel.reducers import ExactReducer, PowerSGDReducer
from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step
from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig
from torch_parity import random_flax_variables, to_numpy
from torch_worker import FSDP_HW, FSDP_WIDTH, TELEMETRY_CASES, few_torch_threads, numpy_batches, run_all, spawn, telemetry_rank  # noqa: F401


def _row(e):
    return (e.tag, e.layer, e.op, e.axis, e.dtype, e.payload_bytes, e.count)


@pytest.fixture(scope="module")
def resnet():
    """The small ResNet-18's parameters in both packages (shapes only
    matter here)."""
    model = jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16)
    params = random_flax_variables(model, (1, 32, 32, 3), seed=1)["params"]
    return params, list(resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device="cpu").parameters())


EXACT_LAYOUTS = {
    "monolithic": {}, "chunked": {"comm_chunks": 4}, "per_tensor": {"packed": False},
    "ring": {"comm_strategy": "ring"}, "bucketed": {"bucket_bytes": 50_000},
    "bucketed_chunked": {"bucket_bytes": 50_000, "comm_chunks": 3},
}


@pytest.mark.parametrize("layout", list(EXACT_LAYOUTS))
def test_exact_ledger_entries_match_jax(resnet, layout):
    jparams, leaves = resnet
    kw = EXACT_LAYOUTS[layout]
    want = [_row(e) for e in JaxExact(**kw).ledger_entries(jparams, axis="data")]
    reducer = ExactReducer(**kw)
    got = [_row(e) for e in reducer.ledger_entries(leaves, axis="data")]
    assert sum(r[5] for r in got) * 8 == reducer.bits_per_step(leaves)
    if "bucket_bytes" not in kw:
        assert got == want
        return
    assert len(got) == len(want) and sum(r[5] for r in got) == sum(r[5] for r in want)
    buckets = bucket_assignments([n_bits(t) // 8 for t in leaves], kw["bucket_bytes"])
    assert [r[5] for r in got] == [sum(n_bits(leaves[i]) // 8 for i in idx) for idx in buckets]
    assert [r[0] for r in got] == [f"grads.b{i}" for i in range(len(buckets))]
    assert {r[6] for r in got} == {kw.get("comm_chunks", 1)}


@pytest.mark.parametrize("kw", [{}, {"comm_chunks": 4}, {"n_power_iterations": 1}], ids=["plain", "chunks4", "power_it"])
def test_powersgd_ledger_entries_match_jax(resnet, kw):
    jparams, leaves = resnet
    want = [_row(e) for e in JaxPowerSGD(compression_rank=4, matricize="last", **kw).ledger_entries(jparams, axis="data")]
    reducer = PowerSGDReducer(compression_rank=4, matricize="last", **kw)
    got = [_row(e) for e in reducer.ledger_entries(leaves, axis="data")]
    assert got == want
    assert sum(r[5] for r in got) * 8 == reducer.bits_per_step(leaves)


def test_powersgd_fidelity_groups_match_jax(resnet):
    """The same shape groups (numbered in each package's leaf order) and
    tags, every tag priced by the ledger."""
    jparams, leaves = resnet
    reducer = PowerSGDReducer(compression_rank=4, matricize="last")
    want = JaxPowerSGD(compression_rank=4, matricize="last").fidelity_group_tags(jparams)
    got = reducer.fidelity_group_tags(leaves)
    assert sorted(k.split(":")[-1] for k in got) == sorted(k.split(":")[-1] for k in want)
    assert sorted(got.values()) == sorted(want.values())
    assert set(got.values()) <= set(ledger.WireLedger(reducer.ledger_entries(leaves)).by_tag())


def test_hierarchical_ledger_entries_match_jax(resnet):
    jparams, leaves = resnet
    mesh = make_mesh(axis_sizes=(2, 2), axis_names=("dcn", "ici"), devices=jax.devices()[:4])
    jhier = JaxHierarchical(JaxPowerSGD(compression_rank=4, matricize="last"), mesh, inner_axis="ici", outer_axis="dcn")
    hier = HierarchicalReducer(PowerSGDReducer(compression_rank=4, matricize="last"), None, None, 2, 2)
    want = [_row(e) for e in jhier.ledger_entries(jparams)]
    got = [_row(e) for e in hier.ledger_entries(leaves)]
    assert got == want
    assert sum(r[5] for r in got) * 8 == hier.bits_per_step(leaves)
    assert sorted(hier.fidelity_group_tags(leaves).values()) == sorted(jhier.fidelity_group_tags(jparams).values())


def test_a_reducer_without_entries_gets_one_at_its_bits(resnet):
    jparams, leaves = resnet
    want = [_row(e) for e in jax_ledger.reducer_ledger_entries(JaxTopK(k_fraction=0.01), jparams, "data", n_workers=4)]
    got = [_row(e) for e in ledger.reducer_ledger_entries(TopKReducer(k_fraction=0.01), leaves, "data", n_workers=4)]
    assert got == want and got[0][0] == "reduction"


def _jax_cnn():
    model = JaxSmallCNN(width=FSDP_WIDTH)
    params = to_numpy(random_flax_variables(model, (1, FSDP_HW, FSDP_HW, 3), seed=51, init_kwargs={}))["params"]

    def loss_fn(p, batch):
        x, y = batch
        return jax_cross_entropy(model.apply({"params": p}, x), y)

    return params, stateless_loss(loss_fn)


@pytest.mark.parametrize("on_a_group", [False, True], ids=["one_process", "world_1_group"])
def test_train_step_ledger_matches_jax(on_a_group):
    """The single-process step has no loss collective, the step on a group
    (a world of one included) has it, in both packages; the ledger sums to
    ``bits_per_step`` and records the dense gradient."""
    params, loss_fn = _jax_cnn()
    mesh = make_mesh(devices=jax.devices()[:1]) if on_a_group else None
    jstep = jax_make_train_step(
        loss_fn, JaxPowerSGD(compression_rank=2, matricize="last"), params, 0.05, mesh=mesh, donate_state=False
    )
    model = SmallCNN(width=FSDP_WIDTH, image_size=FSDP_HW, device="cpu")
    reducer = PowerSGDReducer(compression_rank=2, matricize="last")

    def check(group):
        step = make_train_step(image_classifier_loss(), reducer, model, 0.05, group=group)
        assert [_row(e) for e in step.ledger.entries] == [_row(e) for e in jstep.ledger.entries]
        assert step.ledger.total_bits() == step.bits_per_step == jstep.bits_per_step
        assert step.ledger.dense_grad_bits == jstep.ledger.dense_grad_bits
        assert step.ledger.compression_ratio() == pytest.approx(jstep.ledger.compression_ratio(), rel=1e-12)
        assert step.comm_config == jstep.comm_config

    if on_a_group:
        with process_group(ExperimentConfig(), torch.device("cpu")) as group:
            check(group)
    else:
        check(None)


@pytest.mark.parametrize("chunks", [None, 3])
def test_fsdp_step_ledger_matches_jax(chunks):
    params, loss_fn = _jax_cnn()
    jstep = jax_fsdp.make_fsdp_train_step(
        loss_fn, params, 0.05, mesh=make_mesh(devices=jax.devices()[:1]), donate_state=False, comm_chunks=chunks
    )
    with process_group(ExperimentConfig(), torch.device("cpu")) as group:
        model = SmallCNN(width=FSDP_WIDTH, image_size=FSDP_HW, device="cpu")
        step = make_fsdp_train_step(image_classifier_loss(), model, 0.05, group=group, comm_chunks=chunks)
    assert [_row(e) for e in step.ledger.entries] == [_row(e) for e in jstep.ledger.entries]
    assert step.bits_per_step == jstep.bits_per_step == step.ledger.total_bits()
    assert step.ledger.dense_grad_bits == jstep.ledger.dense_grad_bits


def test_step_ledger_refuses_a_drifting_total(resnet):
    _, leaves = resnet
    bits = ExactReducer().bits_per_step(leaves)
    assert ledger.step_ledger(ExactReducer(), leaves, "data", 1, expected_bits=bits + 32).total_bits() == bits + 32
    with pytest.raises(AssertionError, match="must sum"):
        ledger.step_ledger(ExactReducer(), leaves, "data", 1, expected_bits=bits)


def test_wire_ledger_totals_and_events_match_jax():
    rows = [("powersgd.P", "reducer", "all-reduce", "data", "float32", 1000, 2),
            ("powersgd.rank1", "reducer", "all-reduce", "data", "float32", 24, 1),
            ("loss-sync", "trainer", "all-reduce", "data", "float32", 4, 1)]
    got = ledger.WireLedger([ledger.LedgerEntry(*r) for r in rows], dense_grad_bits=80_000)
    want = jax_ledger.WireLedger([jax_ledger.LedgerEntry(*r) for r in rows], dense_grad_bits=80_000)
    assert got.total_bits() == want.total_bits() and got.by_tag() == want.by_tag()
    assert got.by_layer() == want.by_layer() and got.layer_bytes("trainer") == want.layer_bytes("trainer")
    assert got.compression_ratio() == want.compression_ratio()
    assert [e.record() for e in got.collective_events("x")] == [e.record() for e in want.collective_events("x")]
    assert ledger.loss_sync_entry("data") == ledger.LedgerEntry(*rows[2])


def test_reconcile_reports_the_signed_delta():
    lg = ledger.WireLedger([ledger.LedgerEntry("grads", "reducer", "all-reduce", "data", "float32", 100, 2)])
    recs = [CollectiveRecord("all-reduce", (0, 1), 50), CollectiveRecord("all-reduce", (0, 1), 50)]
    assert lg.reconcile(recs) == {
        "analytic_bytes": 100, "hlo_bytes": 100, "delta_bytes": 0, "exact": True,
        "hlo_by_kind": {"all-reduce": 2}, "hlo_collective_count": 2,
    }
    more = lg.reconcile(recs + [CollectiveRecord("all-gather", (0, 1), 8)])
    assert (more["delta_bytes"], more["exact"], more["hlo_by_kind"]) == (8, False, {"all-gather": 1, "all-reduce": 2})


def test_audit_of_a_step_without_a_ledger_uses_its_bits():
    from network_distributed_pytorch_tpu_torch.observe import MemorySink, Telemetry

    class Bare:
        bits_per_step = 96

    sink = MemorySink()
    event = ledger.audit_recorded_step(
        Bare(), [CollectiveRecord("all-reduce", (0,), 12)], label="bare", telemetry=Telemetry([sink])
    )
    assert event.exact and event.analytic_bytes == 12 and event.comm_config == {}
    assert [r["event"] for r in sink.records] == ["collective", "compile"]
    assert sink.of_kind("collective")[0]["tag"] == "step"


# ---- the audit on two Gloo ranks ---------------------------------------------

AUDIT_BATCHES = numpy_batches(seed=71, n_steps=2, batch=8, hw=FSDP_HW)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(run_all, 2, tmp_path_factory.mktemp("ledger_ranks"), [(telemetry_rank, (AUDIT_BATCHES,))])


@pytest.mark.parametrize("case", TELEMETRY_CASES)
def test_audit_reads_exact_on_two_ranks(ranks, case):
    """Each rank's first step issued exactly the bytes its ledger itemises:
    one ``CollectiveEvent`` a ledger line, then an exact ``CompileEvent``
    before the first ``StepEvent``, and no failure."""
    for (out,) in ranks:
        recs = out[case]["records"]
        kinds = [r["event"] for r in recs if r["event"] != "span"]
        first = kinds.index("compile")
        assert set(kinds[:first]) == {"collective"} and kinds.index("step") == first + 1
        audit = recs[[r["event"] for r in recs].index("compile")]
        assert audit["exact"] and audit["delta_bytes"] == 0, audit
        lines = [r for r in recs if r["event"] == "collective"]
        assert sum(r["payload_bytes"] for r in lines) == audit["analytic_bytes"] == audit["hlo_bytes"]
        assert sum(r["count"] for r in lines) <= audit["hlo_collective_count"]
        assert not [r for r in recs if r["event"] == "failure"]


def test_probe_on_two_ranks_averages_the_ranks(ranks):
    """The probe's values on a group are the ranks' own values averaged by
    its one all-reduce (the norms as the root of the mean square), the
    same on both ranks, with a ``FidelityEvent`` a fidelity group."""
    (a,), (b,) = ranks
    local = [r["powersgd_chunks"]["local_probe"] for r in (a, b)]
    seen = [[r for r in out["powersgd_chunks"]["records"] if r["event"] == "train_health"][-1] for out in (a, b)]
    assert {k: v for k, v in seen[0].items() if k != "rank"} == {k: v for k, v in seen[1].items() if k != "rank"}
    for key in ("loss", "powersgd_rel_error"):
        assert seen[0][key] == pytest.approx(np.mean([p[key] for p in local]), rel=1e-6)
    for key in ("grad_norm", "ef_memory_norm"):
        assert seen[0][key] == pytest.approx(np.sqrt(np.mean([p[key] ** 2 for p in local])), rel=1e-6)
    fid = [r for r in a["powersgd_chunks"]["records"] if r["event"] == "fidelity"]
    assert len(fid) == len(AUDIT_BATCHES) * len(local[0]["fidelity"])
