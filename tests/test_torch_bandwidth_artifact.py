"""``scripts/torch_bandwidth_artifact.py`` against the JAX package's
``scripts/bandwidth_artifact.py``, on the CPU: ``project`` against the JAX
``phase_project`` on the same hand-built structure and card times (the
table, ``speedup_vs_exact`` and its refusal of a ratio across sources),
the structure record's names pinned against the JAX record's, the
structure phase on Gloo ranks, the full-preset row's bits against the JAX
``_reducer_bits`` at ResNet-152's shapes, and the departure: the port's
record takes no number from ``artifacts/TPU_EVIDENCE.json``.

The JAX projection's in-node row is ``ICI(v5e)`` (200 GB/s, 1 us); the
port's ``NVLink4(H100)`` (450 GB/s, no latency). The comparison sets the JAX
row to the port's rate and latency and reads it under the port's name; the
JAX record's ``"chip"`` source is the port's ``"card"``.
"""

import functools
import importlib.util
import json
import math
import os

import jax
import jax.numpy as jnp
import pytest

from network_distributed_pytorch_tpu.models import resnet152 as jax_resnet152
from network_distributed_pytorch_tpu.parallel import ExactReducer as JaxExact
from network_distributed_pytorch_tpu.parallel import PowerSGDReducer as JaxPowerSGD
from network_distributed_pytorch_tpu.parallel.trainer import LOSS_SYNC_BITS as JAX_LOSS_SYNC_BITS
from network_distributed_pytorch_tpu.parallel.trainer import _reducer_bits
from network_distributed_pytorch_tpu.utils import bandwidth as jax_bandwidth
from network_distributed_pytorch_tpu_torch.experiments import bandwidth_study
from network_distributed_pytorch_tpu_torch.utils.bandwidth import allreduce_time_s
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ICI, PORT_NVLINK = "ICI(v5e)", "NVLink4(H100)"
SMI = "NVIDIA H100 80GB HBM3, 700.00 W"
# the JAX record's row keys the port names otherwise, by row kind
RENAMED = {
    "flat": {"hlo_collectives": "collectives", "audited_bits_per_step": "recorded_bits_per_step"},
    "scan": {"hlo_collectives": "collectives_per_round", "audited_bits_per_round": "recorded_bits_per_round"},
}


def _load(name, path, monkeypatch, out):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "OUT", str(out))
    return mod


@pytest.fixture
def scripts(monkeypatch, tmp_path):
    """``(port, jax)``, each writing its record into ``tmp_path``."""
    return (
        _load("torch_bandwidth_artifact", "torch_bandwidth_artifact.py", monkeypatch, tmp_path / "port.json"),
        _load("bandwidth_artifact", "bandwidth_artifact.py", monkeypatch, tmp_path / "jax.json"),
    )


# ---- project against phase_project ------------------------------------------------

# name: (kind, bits a step, the JAX audit's collectives, the port recorder's,
# CPU seconds, card seconds or None). An avoidance row's JAX count holds its
# in-round loss all-reduce once, the port's each of the round's 8 times
ROWS = {
    "local_sgd_h8": ("scan", 2_805_896.0, {"all-reduce": 2}, {"all-reduce": 9}, 0.153, 0.0021),
    "diloco_psgd_r4_h8": ("scan", 155_416.0, {"all-reduce": 4}, {"all-reduce": 11}, 0.163, 0.0024),
    "exact": ("flat", 22_446_944, {"all-reduce": 2}, {"all-reduce": 2}, 0.156, 0.0183),
    "powersgd_r4": ("flat", 1_243_104, {"all-reduce": 4}, {"all-reduce": 4}, 0.192, 0.0206),
    "topk_1pct": ("flat", 3_591_552, {"all-gather": 2, "all-reduce": 1}, {"all-gather": 2, "all-reduce": 1}, 0.182, 0.0199),
    "hier_powersgd_r4": ("flat", 1_243_136, {"all-reduce": 5}, {"all-reduce": 5}, 0.191, None),
}


def _structures(rows, timed=True):
    """The same rows in the JAX record's names and in the port's, and the
    card times of each."""
    jax_rows, port_rows, times = {}, {}, {}
    for name, (kind, bits, jax_coll, port_coll, cpu_s, card_s) in rows.items():
        common = {"bits_per_step": bits, "measured_step_s": cpu_s, "mbytes_per_step": bits / 8e6}
        if kind == "scan":
            jax_rows[name] = {**common, "sync_every": 8, "hlo_collectives": jax_coll, "audited_bits_per_round": int(bits * 8)}
            port_rows[name] = {
                **common, "sync_every": 8, "collectives_per_round": port_coll, "recorded_bits_per_round": int(bits * 8),
                "projected_bits_per_step": bits,
            }
        else:
            jax_rows[name] = {**common, "hlo_collectives": jax_coll, "audited_bits_per_step": bits}
            port_rows[name] = {
                **common, "collectives": port_coll, "recorded_bits_per_step": bits, "projected_bits_per_step": bits,
            }
        if timed and card_s is not None:
            times[name] = card_s
    return (
        {"structure": {"num_devices": 8, "results": jax_rows}, "chip": {"compute_step_s": times}},
        {
            "structure": {"num_devices": 8, "projected_workers": 8, "results": port_rows},
            "chip": {"compute_step_s": times, "nvidia_smi": SMI, "device": "NVIDIA H100 80GB HBM3", "torch": "t"},
        },
    )


def _as_port(obj):
    """The JAX projection in the port's names: the in-node row, the card."""
    text = json.dumps(obj).replace(JAX_ICI, PORT_NVLINK).replace("'chip'", "'card'").replace('"chip"', '"card"')
    return json.loads(text)


@pytest.mark.parametrize("timed", [True, False], ids=["card_times", "cpu_fallback_only"])
def test_project_matches_the_jax_phase_project(scripts, monkeypatch, timed):
    port, ref = scripts
    monkeypatch.setitem(jax_bandwidth.FABRICS_BYTES_PER_S, JAX_ICI, 450e9)
    monkeypatch.setitem(jax_bandwidth.LATENCY_S, JAX_ICI, 0.0)
    monkeypatch.setattr(ref, "_full_preset_row", lambda art: None)  # its TPU_EVIDENCE.json: see below
    jax_art, port_art = _structures(ROWS, timed)
    for mod, art in ((ref, jax_art), (port, port_art)):
        with open(mod.OUT, "w") as f:
            json.dump(art, f)
    ref.phase_project()
    got = port.phase_project()
    want = json.load(open(ref.OUT))
    assert got == json.load(open(port.OUT))
    assert got["projection"]["table"] == _as_port(want["projection"]["table"])
    assert got["speedup_vs_exact"] == _as_port(want["speedup_vs_exact"])
    assert got["projection"]["workers"] == want["projection"]["workers"] == port.N_WORKERS == 8
    if timed:
        # the hierarchical row keeps its CPU time, so no ratio against the card's exact
        assert set(got["speedup_vs_exact"]["hier_powersgd_r4"]) == {"skipped"}
        assert got["projection"]["table"]["exact"]["compute_source"] == "card"
    else:
        assert all("skipped" not in v for v in got["speedup_vs_exact"].values())
    # a projected step is the compute time plus the ring's time of the row's bits
    for name, row in got["projection"]["table"].items():
        for fabric, e in row["fabrics"].items():
            want_s = row["compute_s"] + allreduce_time_s(row["bits_per_step"] / 8, 8, fabric, row["n_collectives"])
            assert math.isclose(e["step_time_s"], want_s, rel_tol=1e-12), (name, fabric)
    assert "full_preset" not in got  # no card time of the flagship in these records


def test_project_refuses_a_structure_of_another_world(scripts):
    port, _ = scripts
    _, art = _structures(ROWS)
    art["structure"]["projected_workers"] = 4
    with open(port.OUT, "w") as f:
        json.dump(art, f)
    with pytest.raises(ValueError, match="projects 4 workers"):
        port.phase_project()
    with open(port.OUT, "w") as f:
        json.dump({}, f)
    with pytest.raises(SystemExit, match="structure phase first"):
        port.phase_project()


# ---- the structure record's names --------------------------------------------------


@functools.lru_cache(maxsize=None)
def _world_one_study():
    """The port's study at world 1 on the CPU, cut to a batch of 8 and one
    timed step or round a row, projected for 8 workers."""
    return bandwidth_study.run(
        preset="small", device="cpu", global_batch=8, timed_steps=1, timed_rounds=1, project_workers=8
    )


def test_structure_names_map_the_jax_records(scripts):
    """Every key of each row of the JAX package's committed
    ``artifacts/BANDWIDTH.json`` structure is in the port's record under its
    own name or under the name ``RENAMED`` gives it; no port row carries a
    JAX-only name."""
    port, _ = scripts
    with open(os.path.join(REPO, "artifacts", "BANDWIDTH.json")) as f:
        jax_rows = json.load(f)["structure"]["results"]
    record = port.structure_record(_world_one_study())
    assert record["num_devices"] == 1 and record["projected_workers"] == 8
    port_rows = record["results"]
    assert set(port_rows) == set(jax_rows) - {"hier_powersgd_r4"}  # the two-level row needs 4 ranks
    for name, row in port_rows.items():
        kind = "scan" if "sync_every" in jax_rows[name] else "flat"
        assert ("sync_every" in row) == (kind == "scan"), name
        for key in jax_rows[name]:
            assert RENAMED[kind].get(key, key) in row, (name, key)
        assert not {"hlo_collectives", "audited_bits_per_step", "audited_bits_per_round"} & set(row), name


def test_project_of_a_world_one_structure_takes_the_bits_at_eight_workers(scripts):
    """The smoke's structure (world 1, projected for 8): each row's bits are
    the reducers' at 8 workers, which grow with the world for the gather
    compressors; the projected steps hold the ring model."""
    port, _ = scripts
    study = _world_one_study()
    with open(port.OUT, "w") as f:
        json.dump({"structure": port.structure_record(study)}, f)
    art = port.phase_project()
    assert art["projection"]["bits_source"] == "reducers at 8 workers"
    for name, row in art["projection"]["table"].items():
        assert row["bits_per_step"] == study["results"][name]["projected_bits_per_step"]
        assert row["compute_source"] == "cpu-mesh fallback"
    topk = study["results"]["topk_1pct"]
    assert art["projection"]["table"]["topk_1pct"]["bits_per_step"] > topk["recorded_bits_per_step"]


def test_structure_phase_on_two_gloo_ranks(scripts, monkeypatch):
    """The structure phase spawns its ranks (processes of the script) and
    keeps rank 0's record: the same rows and collectives as the study in
    process, the bits as recorded at world 2."""
    port, _ = scripts
    monkeypatch.setattr(port, "STRUCTURE_RANKS", 2)
    monkeypatch.setattr(port, "STUDY_BATCH", 8)
    monkeypatch.setattr(port, "STRUCTURE_TIMEOUT_S", 600.0)
    structure = port.phase_structure()
    assert structure["num_devices"] == 2 and structure["projected_workers"] == 8
    assert json.load(open(port.OUT))["structure"] == structure
    one = _world_one_study()["results"]
    assert set(structure["results"]) == set(one)
    for name, row in structure["results"].items():
        assert row.get("collectives", row.get("collectives_per_round")) == one[name].get(
            "collectives", one[name].get("collectives_per_round")
        ), name
        recorded = row.get("recorded_bits_per_step", row.get("recorded_bits_per_round"))
        assert recorded == row.get("bits_per_round", row["bits_per_step"]), name


# ---- the full-preset row --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _full_bits(port_path):
    spec = importlib.util.spec_from_file_location("full_bits", port_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.full_preset_bits()


def test_full_preset_bits_equal_the_jax_reducer_bits():
    """Exact and PowerSGD rank 4 on ResNet-152 with the ImageNet stem, each
    plus the loss's 32: the port's reducers on its model against the JAX
    ``_reducer_bits`` on the JAX model's shapes."""
    got = _full_bits(os.path.join(REPO, "scripts", "torch_bandwidth_artifact.py"))
    model = jax_resnet152(num_classes=10, norm="batch", stem="imagenet")
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=True))["params"]
    want = {
        "exact": _reducer_bits(JaxExact(), shapes) + JAX_LOSS_SYNC_BITS,
        "powersgd_r4": _reducer_bits(JaxPowerSGD(random_seed=714, compression_rank=4, matricize="last"), shapes)
        + JAX_LOSS_SYNC_BITS,
    }
    assert got == want
    assert got["powersgd_r4"] == 36_249_536 + 32  # PERF.md's ResNet-152 payload, plus the loss


def test_the_record_takes_nothing_from_tpu_evidence(scripts, monkeypatch, tmp_path):
    """The departure from the JAX script: in a root that holds a synthetic
    ``artifacts/TPU_EVIDENCE.json``, the JAX full-preset row reads its step
    times, and the port's record holds no number of it: no full-preset row
    without the card's own times, and with them only those."""
    port, ref = scripts
    root = tmp_path / "root"
    (root / "artifacts").mkdir(parents=True)
    marker = 0.123456789
    evidence = {"phases": {
        name: {"ok": True, "raw": {"mean_step_time_s": marker}}
        for name in ("powersgd_cifar10_full_bf16", "powersgd_cifar10_full_fp32")
    }}
    (root / "artifacts" / "TPU_EVIDENCE.json").write_text(json.dumps(evidence))
    monkeypatch.setattr(ref, "REPO", str(root))
    jax_row = ref._full_preset_row({})
    assert {r["chip_step_s"] for r in jax_row["chip_rows"].values()} == {marker}

    monkeypatch.setattr(port, "REPO", str(root))
    monkeypatch.setattr(port, "OUT", str(root / "artifacts" / "TORCH_BANDWIDTH.json"))
    bits = _full_bits(os.path.join(REPO, "scripts", "torch_bandwidth_artifact.py"))
    monkeypatch.setattr(port, "full_preset_bits", lambda: bits)
    _, art = _structures(ROWS)
    (root / "artifacts" / "TORCH_BANDWIDTH.json").write_text(json.dumps(art))
    got = port.phase_project()
    assert "full_preset" not in got and str(marker) not in json.dumps(got)

    art["chip"]["full_preset"] = {
        name: {"config": "powersgd_r4", "chip_step_s": 0.25 + i, "compute_dtype": dtype}
        for i, (name, dtype) in enumerate(port.FULL_PRESET_RUNS.items())
    }
    (root / "artifacts" / "TORCH_BANDWIDTH.json").write_text(json.dumps(art))
    got = port.phase_project()
    row = got["full_preset"]
    assert {r["chip_step_s"] for r in row["chip_rows"].values()} == {0.25, 1.25}
    assert row["bits_per_step"] == bits and SMI in row["source"] and "TPU" not in row["source"]
    assert str(marker) not in json.dumps(got)
    assert row["exact_over_powersgd_bytes"] == round(bits["exact"] / bits["powersgd_r4"], 1)


def test_chip_phase_refuses_the_cpu_and_a_missing_card(scripts):
    """No fallback: the chip phase times the card or raises."""
    import torch

    port, _ = scripts
    with pytest.raises(RuntimeError, match="not cpu"):
        port.phase_chip(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.main(["chip"])
        assert not os.path.exists(port.OUT)
