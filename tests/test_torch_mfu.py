"""MFU accounting (``observe/mfu.py``) and the step's FLOPs count
(``observe.ledger.count_flops`` in the audit) against the JAX package.

The same inputs (the JAX package's own ``tests/test_spans.py`` MFU cases)
go through both packages' functions, and the returned records must be
equal. The pinned differences, each by name:

- the peak tables: the port's rows are the H100's (``"h100"``,
  ``"h100 pcie"``, ``"h100 nvl"``), the JAX package's TPU generations';
- the platform: the port's lookup answers only for ``"gpu"``, the JAX
  package's only for ``"tpu"``; the CPU gets no peak in either;
- ``flops_source``: the port's audit counts the first call's FLOPs with
  ``torch.utils.flop_counter.FlopCounterMode`` (``"flop_counter"``), the
  JAX package reads XLA's ``cost_analysis`` (``"cost_analysis"``), which
  also gives the bytes accessed that the port leaves None.

The count of the tiny ResNet's forward equals a hand count of its
convolutions and its linear layer (2 FLOPs a multiply-add); its training
step counts between 2 and 3 forwards. Beside them, unchecked, XLA's
``cost_analysis`` FLOPs of the JAX model (printed; ``-s`` shows them).
"""

import contextlib
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu._jax_compat import compiled_cost
from network_distributed_pytorch_tpu.models import resnet18 as jax_resnet18
from network_distributed_pytorch_tpu.observe import ledger as jax_ledger
from network_distributed_pytorch_tpu.observe import mfu as jax_mfu
from network_distributed_pytorch_tpu_torch.experiments import exact_cifar10, powersgd_cifar10
from network_distributed_pytorch_tpu_torch.observe import ledger, mfu
from network_distributed_pytorch_tpu_torch.ops import flash_attention as fa
from torch_parity import random_flax_variables
from torch_worker import few_torch_threads, numpy_batches  # noqa: F401

H100_SXM = "NVIDIA H100 80GB HBM3"


# ---- the device tables -------------------------------------------------------


@pytest.mark.parametrize("kind, platform", [
    ("TPU v5 lite", "tpu"), ("tpu v5 litepod-8", "tpu"), ("TPU v5p", "tpu"), ("TPU v4", "tpu"),
    (H100_SXM, "gpu"), ("NVIDIA H100 PCIe", "gpu"), ("NVIDIA H100 NVL", "gpu"), ("NVIDIA A100-SXM4-80GB", "gpu"),
    ("cpu", "cpu"), ("", ""),
])
def test_peak_tables_differ_only_in_their_rows(kind, platform):
    """The lookup rule is the JAX package's (substring, longest match,
    0.0 when unknown or on another platform); the rows and the platform
    are the pinned differences."""
    port = (mfu.peak_flops(kind, platform), mfu.hbm_bandwidth(kind, platform))
    ref = (jax_mfu.peak_flops(kind, platform), jax_mfu.hbm_bandwidth(kind, platform))
    want_port = {
        H100_SXM: (989.4e12, 3.35e12), "NVIDIA H100 PCIe": (756e12, 2.0e12), "NVIDIA H100 NVL": (835e12, 3.9e12),
    }.get(kind, (0.0, 0.0))
    assert port == want_port
    if platform == "tpu":
        assert ref[0] > 0 and ref[1] > 0
    else:
        assert ref == (0.0, 0.0)
    # each package answers for its own platform only
    assert jax_mfu.peak_flops(kind, "gpu") == 0.0 and mfu.peak_flops(kind, "tpu") == 0.0


def test_peak_table_keys():
    assert set(mfu.PEAK_BF16_FLOPS) == set(mfu.HBM_BYTES_PER_S) == {"h100", "h100 pcie", "h100 nvl"}
    # the default platform is each package's own
    assert mfu.peak_flops(H100_SXM) == 989.4e12 and jax_mfu.peak_flops("TPU v5 lite") == 197e12


# ---- the roofline and the MFU events: the JAX package's cases ---------------

ROOFLINE_CASES = [
    (1e12, 1e9, 0.0, 1e12, None),
    (1e12, 1e9, 2e14, 1e12, 0.7),
    (1e9, 1e9, 2e14, 1e12, None),
    (1e13, 1e9, 2e14, 1e12, None),
    (1e13, None, 2e14, 1e12, None),  # bytes unknown: compute, never hbm
    (1e13, None, 2e14, 1e12, 0.49),
    (0.0, 1e9, 2e14, None, 0.5),
]


@pytest.mark.parametrize("case", ROOFLINE_CASES)
def test_classify_roofline_matches(case):
    assert mfu.classify_roofline(*case) == jax_mfu.classify_roofline(*case)
    assert mfu.COMM_EXPOSED_THRESHOLD == jax_mfu.COMM_EXPOSED_THRESHOLD
    assert mfu.STEADY_STATE == jax_mfu.STEADY_STATE


def test_bytes_unknown_never_reads_hbm():
    """The port's audit leaves the bytes None: its verdict is compute or
    comm-exposed, in both packages."""
    for exposed in (None, 0.1, 0.9):
        got = mfu.classify_roofline(1e6, None, 989.4e12, 3.35e12, exposed)
        assert got["bound"] == ("comm-exposed" if exposed == 0.9 else "compute")
        assert got == jax_mfu.classify_roofline(1e6, None, 989.4e12, 3.35e12, exposed)


MFU_EVENT_CASES = [
    dict(label="toy", step_time_s=0.01, flops_per_step=2.0e9, peak_flops_per_s=1e12, exposed_comm_fraction=1.0),
    dict(label="toy", step_time_s=0.01, flops_per_step=2.0e9, n_steps=5, flops_source="flop_counter",
         device_kind="toy-sim", peak_flops_per_s=1e12, bytes_accessed_per_step=1e9, hbm_bytes_per_s_=1e11),
    dict(label="cpu", step_time_s=0.5, flops_per_step=3.0e9, device_kind="cpu", platform="cpu"),
    dict(label="zero", step_time_s=0.0, flops_per_step=3.0e9, peak_flops_per_s=1e12, window="warm"),
]


@pytest.mark.parametrize("case", MFU_EVENT_CASES)
def test_mfu_event_records_match(case):
    got, want = mfu.mfu_event(**case), jax_mfu.mfu_event(**case)
    assert got.record() == want.record()
    assert got.banner() == want.banner()


def test_mfu_event_on_the_card_kind():
    """By the table: the same numbers as the JAX package given the peak."""
    got = mfu.mfu_event(label="step", step_time_s=0.1, flops_per_step=9.894e12, device_kind=H100_SXM)
    assert got.peak_flops_per_s == 989.4e12 and got.hbm_bytes_per_s == 3.35e12
    assert got.mfu == pytest.approx(0.1) and got.bound == "compute"
    want = jax_mfu.mfu_event(
        label="step", step_time_s=0.1, flops_per_step=9.894e12, device_kind=H100_SXM,
        peak_flops_per_s=989.4e12, hbm_bytes_per_s_=3.35e12,
    )
    assert got.record() == want.record()


COMPILE_RECORDS = [
    {"label": "toy", "flops_per_step": 2.0e9, "flops_source": "analytic", "device_kind": "toy-sim",
     "peak_flops_per_s": 1e12},
    {"label": "toy", "flops_per_step": 9.9e9},  # a duplicate label: dropped
    {"label": "no-cost"},  # no flops: skipped
    {"label": "overlap", "flops_per_step": 4.0e9, "peak_flops_per_s": 1e12,
     "overlap": {"scheduled": True, "n_sync_collectives": 2, "n_sync_gaps_with_compute": 1}},
    {"label": "cpu-run", "flops_per_step": 1.5e9, "flops_source": "flop_counter", "device_kind": "cpu",
     "peak_flops_per_s": None},
]


@pytest.mark.parametrize("step_time_s", [0.01, 0.0, None])
def test_mfu_from_compile_records_matches(step_time_s):
    got = [e.record() for e in mfu.mfu_from_compile_records(COMPILE_RECORDS, step_time_s, n_steps=5)]
    want = [e.record() for e in jax_mfu.mfu_from_compile_records(COMPILE_RECORDS, step_time_s, n_steps=5)]
    assert got == want
    if step_time_s:
        assert [r["label"] for r in got] == ["toy", "overlap", "cpu-run"]
        assert got[0]["mfu"] == pytest.approx(0.2)
        # a CPU record: no peak, no MFU, no verdict
        assert got[2]["mfu"] is None and got[2]["bound"] == "unknown"


def test_h100_compile_record_joins():
    """A port record from the card carries its device kind and peak; the
    JAX package's join of it (its own table has no H100 row) uses the
    record's peak and gives the same verdict."""
    rec = {"label": "resnet", "flops_per_step": 2.0e12, "flops_source": "flop_counter", "device_kind": H100_SXM,
           "peak_flops_per_s": 989.4e12}
    (got,) = mfu.mfu_from_compile_records([rec], 0.05)
    (want,) = jax_mfu.mfu_from_compile_records([rec], 0.05)
    assert got.mfu == pytest.approx(2.0e12 / 0.05 / 989.4e12) and 0 < got.mfu < 1
    # the HBM row: the port's table has it, the JAX package's does not
    assert got.hbm_bytes_per_s == 3.35e12 and want.hbm_bytes_per_s is None
    assert dataclasses.replace(got, hbm_bytes_per_s=None, ridge_flops_per_byte=None).record() == want.record()


# ---- the step's FLOPs count ---------------------------------------------------


def hand_count_resnet18(batch, width=16, classes=10, hw=32):
    """2 x the multiply-adds of the small ResNet-18's convolutions (CIFAR
    stem, no bias) and its head (bias adds not counted, as the counter's
    ``addmm``)."""
    def conv(cin, cout, k, out_hw):
        return 2 * batch * out_hw * out_hw * cout * cin * k * k

    flops = conv(3, width, 3, hw)
    cin, size = width, hw
    for i in range(4):
        f = width * 2**i
        for j in range(2):
            stride = 2 if i > 0 and j == 0 else 1
            size //= stride
            flops += conv(cin, f, 3, size) + conv(f, f, 3, size)
            if stride != 1 or cin != f:
                flops += conv(cin, f, 1, size)
            cin = f
    return flops + 2 * batch * cin * classes


def jax_cost_flops(batch):
    """XLA's ``cost_analysis`` FLOPs of the JAX small ResNet-18's forward
    and of its loss's value and gradient, on the CPU."""
    model = jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16)
    variables = random_flax_variables(model, (1, 32, 32, 3), seed=1)
    x = jnp.zeros((batch, 32, 32, 3), jnp.float32)
    y = jnp.zeros((batch,), jnp.int32)

    def forward(v, x):
        return model.apply(v, x, train=False)

    def loss(params, x, y):
        logits, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, train=True,
                                mutable=["batch_stats"])
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], axis=1))

    fwd = compiled_cost(jax.jit(forward).lower(variables, x).compile())
    grad = compiled_cost(jax.jit(jax.value_and_grad(loss)).lower(variables["params"], x, y).compile())
    return (fwd or {}).get("flops"), (grad or {}).get("flops")


BATCH = 8


def test_forward_count_is_the_hand_count_and_a_step_two_to_three_forwards():
    model = exact_cifar10.build_model("small", "cpu", seed=0)
    x = torch.from_numpy(numpy_batches(seed=3, n_steps=1, batch=BATCH)[0][0])
    with torch.no_grad(), ledger.count_flops() as fwd:
        model(x)
    hand = hand_count_resnet18(BATCH)
    assert fwd["flops"] == hand

    cfg = exact_cifar10.default_config()
    _, step, state = exact_cifar10.build(cfg, "small", "cpu", None)
    xs, ys = numpy_batches(seed=4, n_steps=1, batch=BATCH)[0]
    with ledger.count_flops() as counted:
        step(state, (torch.from_numpy(xs), torch.from_numpy(ys)))
    ratio = counted["flops"] / hand
    assert 2.0 <= ratio <= 3.0, ratio
    jax_fwd, jax_step = jax_cost_flops(BATCH)
    print(
        f"\nsmall ResNet-18, batch {BATCH}: hand count {hand:,} FLOPs; flop counter forward {fwd['flops']:,.0f},"
        f" step {counted['flops']:,.0f} ({ratio:.4f} forwards); XLA cost_analysis (CPU) forward {jax_fwd},"
        f" value_and_grad {jax_step}; flop counter / XLA: forward "
        f"{fwd['flops'] / jax_fwd if jax_fwd else None}, step {counted['flops'] / jax_step if jax_step else None}"
    )


def test_flagship_step_count_from_shapes(monkeypatch):
    """The flagship's forward and backward (ResNet-152, batch 512, 32 x 32)
    counted from shapes alone, on the meta device: what the audit of the
    fused pipeline's first step counts on the card (its K2a, K3 and K4,
    ctypes launches, add nothing)."""
    from network_distributed_pytorch_tpu_torch.models import resnet as resnet_mod

    monkeypatch.setattr(resnet_mod, "resolve_device", lambda device: torch.device("meta"))
    model = powersgd_cifar10.build_model("full", "meta")
    with ledger.count_flops() as counted:
        model(torch.zeros(512, 32, 32, 3, device="meta")).sum().backward()
    assert counted["flops"] == 719_302_164_480


def test_k5_launches_add_their_products():
    """The counter does not see a ctypes launch: each K5 launch inside an
    open count adds its products (here without a card, through the
    wrapper's tally), and nothing outside one."""
    fwd = fa.attention_flops(16 * 12, 1024, 64, causal=True)
    assert fwd == 4.0 * 16 * 12 * 1024 * 1024 * 64 / 2
    assert fa.attention_flops(16 * 12, 1024, 64, causal=True, backward=True) == 2.5 * fwd
    assert fa.attention_flops(6, 256, 64, causal=False) == 4.0 * 6 * 256 * 256 * 64
    with ledger.count_flops() as outer:
        a = torch.ones(4, 8)
        a @ torch.ones(8, 2)
        with ledger.count_flops() as inner:
            fa._count(fwd)
        fa._count(10.0)
    fa._count(99.0)  # no count open: dropped
    assert inner["flops"] == fwd and outer["flops"] == 2 * 4 * 8 * 2 + fwd + 10.0
    assert fa._flop_counts == []


def test_the_count_leaves_the_step_bit_for_bit():
    """Two identical steps, one under the count: the same state."""
    cfg = powersgd_cifar10.default_config()
    xs, ys = (torch.from_numpy(a) for a in numpy_batches(seed=5, n_steps=1, batch=BATCH)[0])
    finals = []
    for counted in (False, True):
        _, step, state = powersgd_cifar10.build(cfg, "small", "cpu", None)
        with ledger.count_flops() if counted else contextlib.nullcontext():
            state, loss = step(state, (xs, ys))
        finals.append((loss.item(), {k: v.clone() for k, v in state.params.items()},
                       {k: v.clone() for k, v in state.momenta.items()}))
    assert finals[0][0] == finals[1][0]
    for a, b in zip(finals[0][1:], finals[1][1:]):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ---- the audit's record on a run ---------------------------------------------


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """``powersgd_cifar10`` at preset small on the CPU with the event log
    and the audit: its compile record and step times."""
    path = os.path.join(tmp_path_factory.mktemp("mfu_run"), "run.jsonl")
    cfg = powersgd_cifar10.default_config()
    cfg.training_epochs, cfg.global_batch_size = 1, 16
    cfg.event_log, cfg.audit_wire = path, True
    powersgd_cifar10.run(cfg, preset="small", device="cpu", max_steps_per_epoch=3)
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return recs


def test_cpu_audit_counts_flops_and_publishes_no_mfu(cpu_run):
    (compile_,) = [r for r in cpu_run if r["event"] == "compile"]
    assert compile_["flops_per_step"] > 0 and compile_["flops_source"] == "flop_counter"
    assert compile_["device_kind"] == "cpu" and compile_["peak_flops_per_s"] is None
    assert compile_["bytes_accessed_per_step"] is None
    # at least the forward's hand count (batch 16) and at most 3.5 of it
    # (the reducer's products on top of a backward)
    hand = hand_count_resnet18(16)
    assert 2 * hand <= compile_["flops_per_step"] <= 3.5 * hand
    steps = [r["step_time_s"] for r in cpu_run if r["event"] == "step"]
    (m,) = mfu.mfu_from_compile_records([compile_], float(np.median(steps[1:])), n_steps=len(steps) - 1)
    assert m.mfu is None and m.bound == "unknown" and m.flops_source == "flop_counter"
    assert [e.record() for e in jax_mfu.mfu_from_compile_records([compile_], float(np.median(steps[1:])),
                                                                  n_steps=len(steps) - 1)] == [m.record()]


def test_audit_fields_against_the_jax_device_cost_fields(cpu_run):
    """The port's audit fills the fields of the JAX package's
    ``device_cost_fields``; only ``flops_source`` and the bytes differ."""
    (compile_,) = [r for r in cpu_run if r["event"] == "compile"]
    model = jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16)
    variables = random_flax_variables(model, (1, 32, 32, 3), seed=1)
    compiled = jax.jit(lambda v, x: model.apply(v, x, train=False)).lower(
        variables, jnp.zeros((2, 32, 32, 3))).compile()
    want = jax_ledger.device_cost_fields(compiled)
    got = {k: compile_[k] for k in want}
    assert set(want) == {"flops_per_step", "bytes_accessed_per_step", "flops_source", "device_kind",
                         "peak_flops_per_s"}
    assert (got["flops_source"], want["flops_source"]) == ("flop_counter", "cost_analysis")
    assert got["bytes_accessed_per_step"] is None and want["bytes_accessed_per_step"] > 0
    assert got["device_kind"] == "cpu" and got["peak_flops_per_s"] is want["peak_flops_per_s"] is None


def test_audit_recorded_step_fills_the_card_peak():
    class Bare:
        bits_per_step = 96

    from network_distributed_pytorch_tpu_torch.parallel.comm import CollectiveRecord

    rec = [CollectiveRecord("all-reduce", (0,), 12)]
    ev = ledger.audit_recorded_step(Bare(), rec, device_kind=H100_SXM, flops_per_step=1e12)
    assert (ev.flops_per_step, ev.flops_source, ev.peak_flops_per_s) == (1e12, "flop_counter", 989.4e12)
    ev = ledger.audit_recorded_step(Bare(), rec, device_kind="cpu", flops_per_step=1e12)
    assert (ev.flops_per_step, ev.flops_source, ev.peak_flops_per_s) == (1e12, "flop_counter", None)
    ev = ledger.audit_recorded_step(Bare(), rec, device_kind="cpu")
    assert (ev.flops_per_step, ev.flops_source, ev.peak_flops_per_s) == (None, None, None)
