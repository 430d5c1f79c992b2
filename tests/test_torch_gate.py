"""``scripts/torch_gate.py`` against the JAX package's ``scripts/gate.py``.

The same synthetic report and baseline documents, written to ``tmp_path``,
go through both gates: ``extract_metrics``, ``compare``, each verdict
function, and ``main``'s exit code and JSON stdout line must be equal.
Each of the 18 metrics is gated in both directions, in the nested form a
run report carries and in the flat form a recorded baseline carries.

The one departure, pinned here: the port's gate resolves ``--baseline``
and then ``artifacts/GATE_BASELINE.json``, and never the newest
``BENCH_r*.json`` at the root, which records a TPU round.
"""

import contextlib
import io
import json
import os

import pytest

from torch_report_parity import load_script

PORT = load_script("torch_gate", "torchgate")
REF = load_script("gate", "jaxgate")


# each metric in a run report's nested form, and its value a step better and
# a step worse than the baseline's BASE (worse by more than the tolerance)
NESTED = {
    "step_p50_s": lambda v: {"step_p50_s": v},
    "achieved_bytes_per_s": lambda v: {"bandwidth": {"total": {"achieved_bytes_per_s": v}}},
    "flagship_imgs_per_sec": lambda v: {"flagship_imgs_per_sec": v},
    "value": lambda v: {"value": v},
    "mfu": lambda v: {"mfu_headline": v},
    "recovery_latency_s": lambda v: {"recovery_latency_s": v},
    "recovery_time_s": lambda v: {"recovery_time_s": v},
    "p99_decode_ms_per_token": lambda v: {"slo": {"p99_decode_ms_per_token": v}},
    "alerts_fired": lambda v: {"alerts": {"fired": v}},
    "loader_samples_per_s": lambda v: {"loader_samples_per_s": v},
    "data_load_share": lambda v: {"spans": {"by_name": {"data_load": {"share": v}}}},
    "costmodel_error": lambda v: {"costmodel": {"error": v}},
    "critpath_comm_share": lambda v: {"critpath": {"comm_share": v}},
    "hbm_peak_bytes": lambda v: {"memory": {"hbm_peak_bytes": v}},
    "fleet_goodput": lambda v: {"fleet": {"goodput": v}},
    "serving_tokens_per_s_per_chip": lambda v: {"serving": {"serving_tokens_per_s_per_chip": v}},
    "kv_capacity_ratio": lambda v: {"kv_capacity_ratio": v},
    "fidelity_rel_error": lambda v: {"fidelity": {"rel_error": v}},
}
FLAT = {
    "mfu": "mfu", "achieved_bytes_per_s": "achieved_bytes_per_s", "p99_decode_ms_per_token": "p99_decode_ms_per_token",
    "alerts_fired": "alerts_fired", "data_load_share": "data_load_share", "costmodel_error": "costmodel_error",
    "critpath_comm_share": "critpath_comm_share", "hbm_peak_bytes": "hbm_peak_bytes", "fleet_goodput": "fleet_goodput",
    "serving_tokens_per_s_per_chip": "serving_tokens_per_s_per_chip", "fidelity_rel_error": "fidelity_rel_error",
}
BASE = {"costmodel_error": 0.05, "data_load_share": 0.02, "critpath_comm_share": 0.2, "fidelity_rel_error": 0.1,
        "mfu": 0.4, "kv_capacity_ratio": 4.0, "alerts_fired": 2.0}


def _values(metric, direction):
    base = BASE.get(metric, 10.0)
    lower = REF.METRICS[metric] == "lower"
    better = base * (0.9 if lower else 1.1)
    worse = base * (1.5 if lower else 0.5)
    return base, (better if direction == "better" else worse)


def _write(tmp_path, name, doc):
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


def _run(mod, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = mod.main(argv)
    return rc, out.getvalue()


def _both(argv):
    (rc, got), (jrc, want) = _run(PORT, argv), _run(REF, argv)
    assert rc == jrc and got == want, (got, want)
    assert got.endswith("\n") and got.count("\n") == 1
    return rc, json.loads(got)


def test_metrics_and_targets_are_the_jax_gates():
    assert list(PORT.METRICS.items()) == list(REF.METRICS.items()) and len(PORT.METRICS) == 18
    assert set(NESTED) == set(PORT.METRICS)
    assert PORT.DEFAULT_COSTMODEL_ERROR_TARGET == REF.DEFAULT_COSTMODEL_ERROR_TARGET == 0.25
    assert PORT.DEFAULT_KV_CAPACITY_RATIO_TARGET == REF.DEFAULT_KV_CAPACITY_RATIO_TARGET == 2.0
    assert PORT.BASELINE_NAME == REF.BASELINE_NAME == "GATE_BASELINE.json"


@pytest.mark.parametrize("form", ["nested", "flat"])
@pytest.mark.parametrize("direction", ["better", "worse"])
@pytest.mark.parametrize("metric", sorted(NESTED))
def test_each_metric_gates_like_the_jax_gate(tmp_path, metric, direction, form):
    base, cur = _values(metric, direction)
    shape = NESTED[metric] if form == "nested" or metric not in FLAT else (lambda v: {FLAT[metric]: v})
    report, baseline = shape(cur), shape(base)
    assert PORT.extract_metrics(report) == REF.extract_metrics(report) == {metric: cur}
    rc, doc = _both(["--report", _write(tmp_path, "r.json", report), "--baseline",
                     _write(tmp_path, "b.json", baseline), "--root", str(tmp_path)])
    (v,) = [v for v in doc["verdicts"] if v["metric"] == metric]
    assert v["regressed"] is (direction == "worse") and v["baseline"] == base and v["current"] == cur
    assert rc == (1 if any(v["regressed"] for v in doc["verdicts"]) else 0)
    assert doc["gate"] == ("fail" if rc else "pass")


@pytest.mark.parametrize("doc", [
    {}, {"step_p50_s": 0.0}, {"step_p50_s": -1.0}, {"step_p50_s": float("nan")}, {"step_p50_s": "fast"},
    {"alerts": {"fired": 0}}, {"alerts": {"fired": -1}}, {"alerts": "none", "alerts_fired": 0},
    {"bandwidth": {"total": {}}, "achieved_bytes_per_s": 5.0}, {"bandwidth": None},
    {"spans": {"by_name": {"data_load": {"share": 0.0}, "step": {"share": 0.9}}}, "data_load_share": 0.3},
    {"spans": {"by_name": {"data_load": 3}}}, {"mfu_headline": None, "mfu": [{"mfu": 0.3}]},
    {"serving": {"kv_capacity_ratio": 3.0}, "kv_capacity_ratio": 5.0, "serving_tokens_per_s_per_chip": 7.0},
    {"costmodel": None, "costmodel_error": 0.0}, {"fleet": {"goodput": None}, "fleet_goodput": 0.0},
    {"memory": {"hbm_peak_bytes": None, "hbm_peak_source": None}}, {"fidelity": {"rel_error": 0.0}},
    {"critpath": None, "critpath_comm_share": 0.0},
])
def test_extract_metrics_matches(doc):
    assert PORT.extract_metrics(doc) == REF.extract_metrics(doc)
    assert PORT.extract_span_shares(doc) == REF.extract_span_shares(doc)


@pytest.mark.parametrize("tolerance", [0.0, 0.2, 1.0])
def test_compare_matches(tolerance):
    cur = {"step_p50_s": 0.12, "mfu": 0.3, "alerts_fired": 1.0, "hbm_peak_bytes": 5e9, "value": 7.0}
    base = {"step_p50_s": 0.1, "mfu": 0.4, "alerts_fired": 0.0, "hbm_peak_bytes": 5e9}
    got, want = PORT.compare(cur, base, tolerance), REF.compare(cur, base, tolerance)
    assert json.dumps(got) == json.dumps(want)
    by = {v["metric"]: v for v in got}
    # a baseline of 0 alerts: any alert regresses, at an infinite ratio
    assert by["alerts_fired"]["regressed"] and by["alerts_fired"]["ratio"] == float("inf")
    assert by["value"]["missing_baseline"] and not by["value"]["regressed"]


def test_alerts_fired_against_a_zero_baseline(tmp_path):
    base = _write(tmp_path, "b.json", {"alerts": {"fired": 0}})
    for fired, rc_want in ((0, 0), (1, 1)):
        rc, doc = _both(["--report", _write(tmp_path, "r.json", {"alerts": {"fired": fired}}), "--baseline", base])
        assert rc == rc_want
        (v,) = doc["verdicts"]
        assert (v["metric"], v["baseline"], v["limit"], v["regressed"]) == ("alerts_fired", 0.0, 0.0, bool(fired))


def test_missing_baseline_is_advisory(tmp_path):
    rc, doc = _both(["--report", _write(tmp_path, "r.json", {"mfu_headline": 0.3, "step_p50_s": 0.1}),
                     "--baseline", _write(tmp_path, "b.json", {"step_p50_s": 0.1})])
    assert rc == 0 and doc["gate"] == "pass"
    (v,) = [v for v in doc["verdicts"] if v["metric"] == "mfu"]
    assert v["missing_baseline"] is True and v["baseline"] is None and v["regressed"] is False


TARGET_DOCS = [
    ({"mfu": 0.3}, {}, {"mfu_target": 0.35}), ({"mfu": 0.4}, {"mfu_target": 0.35}, {"mfu_target": 0.5}),
    ({"mfu": 0.4}, {"mfu_target": None}, {}), ({}, {"mfu_target": 0.5}, {"mfu_target": 0.5}),
    ({"data_load_share": 0.06}, {}, {"data_load_share_target": 0.05}),
    ({"data_load_share": 0.0}, {"data_load_share_target": 0.05}, {}),
    ({"costmodel_error": 0.3}, {}, {}), ({"costmodel_error": 0.1}, {"costmodel_error_target": 0.05}, {}),
    ({"costmodel_error": 0.1}, {}, {"costmodel_error_target": float("nan")}),
    ({"kv_capacity_ratio": 1.5}, {}, {}), ({"kv_capacity_ratio": 2.5}, {"kv_capacity_ratio_target": 3.0}, {}),
]


@pytest.mark.parametrize("fn", ["mfu_target_verdict", "data_load_share_verdict", "costmodel_target_verdict",
                                "kv_capacity_target_verdict"])
@pytest.mark.parametrize("k", range(len(TARGET_DOCS)))
def test_target_verdicts_match(fn, k):
    current, report, baseline = TARGET_DOCS[k]
    assert getattr(PORT, fn)(current, report, baseline) == getattr(REF, fn)(current, report, baseline)


H100 = {"mfu": [{"label": "step", "device_kind": "NVIDIA H100 80GB HBM3", "mfu": 0.3}], "step_p50_s": 0.1}
PLATFORM_DOCS = [
    {}, {"platform": "cpu"}, {"platform": "  TPU  "}, {"device": "gpu"}, {"platform": ""}, H100,
    {"mfu": [{"device_kind": ""}, "x", {"device_kind": "cpu"}]}, {"mfu": "cpu"}, {"platform": "gpu", **H100},
]


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("b", range(len(PLATFORM_DOCS)))
@pytest.mark.parametrize("a", range(len(PLATFORM_DOCS)))
def test_device_provenance_matches(a, b, strict):
    ra, rb = PLATFORM_DOCS[a], PLATFORM_DOCS[b]
    assert PORT._platform_of(ra) == REF._platform_of(ra)
    assert PORT.device_mismatch_verdict(ra, rb, strict) == REF.device_mismatch_verdict(ra, rb, strict)


def test_a_card_report_against_a_cpu_baseline(tmp_path):
    """``_platform_of`` reads the card's name, lower-cased, off the MFU
    records: against a baseline that attests the CPU it is a mismatch,
    advisory unless ``--strict-device``."""
    assert PORT._platform_of(H100) == "nvidia h100 80gb hbm3"
    report = _write(tmp_path, "r.json", H100)
    base = _write(tmp_path, "b.json", {**H100, "platform": "cpu"})
    rc, doc = _both(["--report", report, "--baseline", base])
    (v,) = [v for v in doc["verdicts"] if v["metric"] == "device_mismatch"]
    assert rc == 0 and v["device_mismatch"] and not v["regressed"] and v["baseline"] == "cpu"
    rc, doc = _both(["--report", report, "--baseline", base, "--strict-device"])
    assert rc == 1 and doc["gate"] == "fail"


@pytest.mark.parametrize("span_tolerance", [0.1, 0.3])
def test_span_shares_match(tmp_path, span_tolerance):
    cur = {"checkpoint/save": 0.25, "step": 0.6, "new": 0.1, "data_load": 0.0}
    base = {"checkpoint/save": 0.05, "step": 0.65, "data_load": 0.0}
    got, want = PORT.compare_span_shares(cur, base, span_tolerance), REF.compare_span_shares(cur, base, span_tolerance)
    assert json.dumps(got) == json.dumps(want)
    assert [v["metric"] for v in got] == ["span:checkpoint/save", "span:data_load", "span:step"]
    spans = lambda shares: {"spans": {"by_name": {k: {"share": v} for k, v in shares.items()}}}  # noqa: E731
    rc, doc = _both(["--report", _write(tmp_path, "r.json", spans(cur)), "--baseline",
                     _write(tmp_path, "b.json", spans(base)), "--span-tolerance", str(span_tolerance)])
    assert rc == (1 if span_tolerance < 0.2 else 0)


@pytest.mark.parametrize("extra", [[], ["--advisory"], ["--tolerance", "0.6"], ["--tolerance", "0.6", "--advisory"]])
def test_advisory_and_tolerance(tmp_path, extra):
    report = _write(tmp_path, "r.json", {"step_p50_s": 0.15, "alerts": {"fired": 0}})
    base = _write(tmp_path, "b.json", {"step_p50_s": 0.1, "alerts": {"fired": 0}})
    rc, doc = _both(["--report", report, "--baseline", base, *extra])
    regressed = "--tolerance" not in extra
    assert doc["gate"] == ("fail" if regressed else "pass") and doc["advisory"] is ("--advisory" in extra)
    assert rc == (1 if regressed and "--advisory" not in extra else 0)


def test_skips_match(tmp_path):
    root = str(tmp_path / "empty_root")
    os.makedirs(root)
    assert _both(["--report", str(tmp_path / "absent.json"), "--root", root]) == (
        0, {"gate": "skipped", "reason": "no_report"})
    report = _write(tmp_path, "r.json", {"step_p50_s": 0.1})
    assert _both(["--report", report, "--root", root]) == (0, {"gate": "skipped", "reason": "no_baseline"})
    assert _both(["--report", report, "--baseline", str(tmp_path / "absent.json")]) == (
        0, {"gate": "skipped", "reason": "no_baseline"})
    assert _both(["--report", report, "--baseline", _write(tmp_path, "b.json", {"value": 3.0})]) == (
        0, {"gate": "pass", "advisory": False, "baseline": str(tmp_path / "b.json"), "report": report,
            "tolerance": 0.2, "verdicts": [{"metric": "step_p50_s", "direction": "lower", "current": 0.1,
                                            "baseline": None, "limit": None, "ratio": None, "regressed": False,
                                            "missing_baseline": True}]})
    nothing = _write(tmp_path, "n.json", {"note": 1})
    assert _both(["--report", nothing, "--baseline", _write(tmp_path, "b2.json", {"value": 3.0})]) == (
        0, {"gate": "skipped", "reason": "no_common_metrics"})


def test_recorded_baseline_resolves_in_both(tmp_path):
    os.makedirs(tmp_path / "artifacts")
    recorded = _write(tmp_path / "artifacts", "GATE_BASELINE.json", {"step_p50_s": 0.1})
    for mod in (PORT, REF):
        assert mod.resolve_baseline(None, str(tmp_path)) == (recorded, {"step_p50_s": 0.1})
        assert mod.resolve_baseline(recorded, "/nonexistent") == (recorded, {"step_p50_s": 0.1})
    report = _write(tmp_path, "r.json", {"step_p50_s": 0.2})
    rc, doc = _both(["--report", report, "--root", str(tmp_path)])
    assert rc == 1 and doc["baseline"] == recorded


def test_the_port_does_not_read_the_bench_history(tmp_path):
    """The departure: a root that holds only a ``BENCH_r01.json``. The JAX
    gate resolves it; the port's does not, and skips."""
    bench = tmp_path / "BENCH_r01.json"
    summary = {"flagship_imgs_per_sec": 100.0, "value": 3.0, "step_p50_s": 0.1}
    bench.write_text(json.dumps({"tail": "noise\n" + json.dumps(summary) + "\n"}))
    assert REF.resolve_baseline(None, str(tmp_path)) == (str(bench), summary)
    assert PORT.resolve_baseline(None, str(tmp_path)) is None
    assert not hasattr(PORT, "_from_bench_history") and not hasattr(PORT, "_summary_from_lines")
    report = _write(tmp_path, "r.json", {"step_p50_s": 0.5})
    (rc, got), (jrc, want) = _run(PORT, ["--report", report, "--root", str(tmp_path)]), _run(
        REF, ["--report", report, "--root", str(tmp_path)])
    assert (rc, json.loads(got)) == (0, {"gate": "skipped", "reason": "no_baseline"})
    assert jrc == 1 and json.loads(want)["baseline"] == str(bench)


def test_gate_reads_what_the_report_writes(tmp_path):
    """A port report document, gated against itself, passes on every
    metric it carries."""
    report = {"step_p50_s": 0.05, "mfu_headline": 0.3, "alerts": {"fired": 0, "by_kind": {}},
              "memory": {"hbm_peak_bytes": 2.1e9, "hbm_peak_source": "measured"}, "critpath": {"comm_share": 0.0},
              "spans": {"by_name": {"data_load": {"share": 0.01}, "step": {"share": 0.9}}},
              "mfu": [{"device_kind": "NVIDIA H100 80GB HBM3", "mfu": 0.3}]}
    path = _write(tmp_path, "r.json", report)
    rc, doc = _both(["--report", path, "--baseline", path])
    assert rc == 0 and doc["gate"] == "pass"
    assert {v["metric"] for v in doc["verdicts"]} == {
        "step_p50_s", "mfu", "alerts_fired", "data_load_share", "critpath_comm_share", "hbm_peak_bytes",
        "span:data_load", "span:step"}
