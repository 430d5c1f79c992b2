"""Shared helpers of the tests that hold ``scripts/torch_report.py`` and
``scripts/torch_gate.py`` to the JAX package's ``scripts/report.py`` and
``scripts/gate.py``: loading a script by path, the report keys, and the
comparisons with the pinned differences.

The pinned differences, and nothing else:

- ``generated_unix``, the wall time at which a report was made;
- the fabric rows: the port's last row is ``NVLink4(H100)`` where the JAX
  package's is ``ICI(v5e)``, so the per-fabric utilisations and modeled
  times of the ``bandwidth`` section, and the text lines that print them
  (the bandwidth table's ``line-rate utilization`` lines, the critical
  path's per-edge ``util`` lines and the dashboard's ``comm`` line), are
  held equal on the GbE rows, and each side must carry its own last row.
"""

import importlib.util
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GBE = ("1GbE", "10GbE", "100GbE")
PORT_ROW, JAX_ROW = "NVLink4(H100)", "ICI(v5e)"

# every key of the JAX package's run_report dict, in its order
REPORT_KEYS = (
    "schema", "run_dir", "run_id", "world_size", "generated_unix", "n_events", "torn_lines", "startup_s", "ranks",
    "step_p50_s", "step_p95_s", "step_skew", "straggler_factor", "stragglers", "bandwidth", "critpath",
    "clock_skew_bound_s", "fabric_matrix", "compile", "comm_buckets", "hierarchy", "partitions", "mfu",
    "mfu_headline", "spans", "failures", "policy", "alerts", "data_drops", "recovery_latency_s", "recovery",
    "recovery_time_s", "slo", "kv_pool", "fleet", "memory", "fidelity", "fidelity_frontier",
)

_ROW = re.compile(r"(NVLink4\(H100\)|ICI\(v5e\))")
# a fabric row's cell in each of the three renderings
_CELLS = (
    re.compile(r" \| (NVLink4\(H100\)|ICI\(v5e\)) [-0-9.e+]+%"),  # line-rate utilization: a | b
    re.compile(r"  (NVLink4\(H100\)|ICI\(v5e\)) +[-0-9.e+]+%"),  # util a  b (critpath, dashboard)
)


def load_script(name, tag):
    """``scripts/<name>.py`` as a module of its own, under ``_<tag>_<name>``."""
    key = f"_{tag}_{name}"
    spec = importlib.util.spec_from_file_location(key, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def gbe_view(bw):
    """A ``bandwidth`` section with each row's per-fabric maps cut to the GbE rows."""
    if not isinstance(bw, dict):
        return bw

    def row(view):
        return {k: ({f: v[f] for f in GBE} if k in ("utilization", "modeled_comm_s") else v) for k, v in view.items()}

    return {**bw, "total": row(bw["total"]), "by_tag": [row(r) for r in bw["by_tag"]]}


def assert_key_equal(port, ref, key):
    """One report key of the port's against the JAX package's, with the
    pinned differences."""
    assert key in port and key in ref, key
    if key == "generated_unix":
        assert isinstance(port[key], float) and isinstance(ref[key], float)
        return
    if key == "bandwidth" and isinstance(ref[key], dict):
        assert gbe_view(port[key]) == gbe_view(ref[key])
        assert set(port[key]["total"]["utilization"]) - set(GBE) == {PORT_ROW}
        assert set(ref[key]["total"]["utilization"]) - set(GBE) == {JAX_ROW}
        return
    assert port[key] == ref[key], key


def strip_fabric_row(line):
    for cell in _CELLS:
        line = cell.sub("", line)
    return line


def assert_text_equal(port_text, ref_text):
    """The port's text against the JAX package's, line by line: equal, but
    on the lines that name the last fabric row, equal without that row's
    cell, with each side's own row named."""
    got, want = port_text.split("\n"), ref_text.split("\n")
    assert len(got) == len(want), (len(got), len(want))
    pinned = 0
    for g, w in zip(got, want):
        if g == w:
            continue
        assert PORT_ROW in g and JAX_ROW in w, (g, w)
        assert _ROW.findall(g) == [PORT_ROW] and _ROW.findall(w) == [JAX_ROW], (g, w)
        assert strip_fabric_row(g) == strip_fabric_row(w), (g, w)
        pinned += 1
    return pinned
