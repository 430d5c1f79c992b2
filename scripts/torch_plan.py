#!/usr/bin/env python3
"""The what-if planner: price comm configs a run did not try, from that
run's report. The front end of the port's ``observe.costmodel``.

It calibrates the cost model from a run report (``scripts/
torch_report.py --json-out``, or straight from a ``--run-dir``), prices
the comm configs (the fallback ladder's rungs and the chunk and bucket
variants; with ``--hierarchical`` the two-level grid too) on each fabric,
and writes:

- ``--out`` (default ``artifacts/plan.json``): the plan, each fabric's
  ranked predictions, its best pick and the ladder's order by rung name.
  The launcher's ``--plan`` applies the pick for its ``--comm-fabric``
  (``NVLink4(H100)`` by default) and reorders the fallback ladder by it;
- ``--events-out`` (default ``artifacts/predictions.jsonl``): every
  prediction as a ``PredictionEvent`` record. When a predicted config is
  run, ``scripts/torch_report.py --plan`` joins prediction and run.

The fabrics are the port's four rows (``1GbE``, ``10GbE``, ``100GbE``,
``NVLink4(H100)``) unless ``--fabrics`` names some.

Usage (from the root of the repository)::

    python3 scripts/torch_plan.py --report artifacts/run_report.json
    python3 scripts/torch_plan.py --run-dir runs/r7 --fabrics 1GbE,100GbE
    python3 scripts/torch_plan.py --report r.json --source-fabric "NVLink4(H100)" --top 3
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from network_distributed_pytorch_tpu_torch.observe import costmodel  # noqa: E402
from network_distributed_pytorch_tpu_torch.observe import fabric as fabric_mod  # noqa: E402


def _say(msg: str) -> None:
    sys.stderr.write(f"# plan: {msg}\n")


def _load_report(args) -> dict:
    if args.run_dir:
        # the report of the run directory, built here (nothing written)
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import torch_report

        _, report = torch_report.run_report(args.run_dir)
        return report
    with open(args.report) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{args.report} is not a report dict")
    return doc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--report", default=os.path.join("artifacts", "run_report.json"),
        help="the run report to calibrate from",
    )
    parser.add_argument("--run-dir", default=None, help="calibrate straight from a run directory instead of --report")
    parser.add_argument(
        "--out", default=os.path.join("artifacts", "plan.json"),
        help="the plan file (the launcher's --plan reads it)",
    )
    parser.add_argument(
        "--events-out", default=os.path.join("artifacts", "predictions.jsonl"),
        help="PredictionEvent JSONL (one record a plan entry)",
    )
    parser.add_argument("--fabrics", default=None, help="comma-separated FABRICS_BYTES_PER_S keys (default: all)")
    parser.add_argument(
        "--source-fabric", default=None,
        help="the fabric the measured run ran on: its modeled exposed comm comes off the compute calibration"
             " (the step/compute span holds the step's collectives)",
    )
    parser.add_argument(
        "--fabric-matrix", default=None,
        help="a measured per-edge fabric matrix (scripts/torch_report.py writes fabric_matrix.json): every ring"
             " term is priced on its slowest edge instead of the named fabric's scalar",
    )
    parser.add_argument(
        "--hierarchical", action="store_true",
        help="add the two-level grid (sync period H x outer rank x sync/async) to the search",
    )
    parser.add_argument("--sites", type=int, default=0, help="sites of the hierarchical grid (0 = the model's default)")
    parser.add_argument("--top", type=int, default=3, help="predictions a fabric to summarise on stderr (default 3)")
    args = parser.parse_args(argv)

    try:
        report = _load_report(args)
    except (OSError, ValueError) as e:
        _say(f"no usable report ({e}); nothing to plan")
        return 1
    try:
        calib = costmodel.calibrate(report, source_fabric=args.source_fabric)
    except ValueError as e:
        _say(f"calibration failed: {e}")
        return 1

    fabrics = [f.strip() for f in args.fabrics.split(",") if f.strip()] if args.fabrics else None
    matrix = None
    if args.fabric_matrix:
        matrix = fabric_mod.load_matrix(args.fabric_matrix)
        if matrix is None:
            _say(f"no usable fabric matrix at {args.fabric_matrix}; falling back to scalar fabric tables")
        else:
            bn = matrix.get("bottleneck") or {}
            _say(f"per-edge matrix: {len(matrix.get('edges', []))} edge(s), bottleneck {bn.get('src')}->{bn.get('dst')}")
    configs = None
    if args.hierarchical:
        configs = costmodel.default_configs(calib) + costmodel.hierarchical_configs(calib, sites=args.sites)
        _say(f"hierarchical grid: +{len(configs) - len(costmodel.default_configs(calib))} two-level config(s)")
    plan = costmodel.build_plan(calib, fabrics=fabrics, configs=configs, matrix=matrix)

    for path in (args.out, args.events_out):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(plan, f, indent=1)
    events = costmodel.prediction_events(plan)
    with open(args.events_out, "w") as f:
        for ev in events:
            f.write(json.dumps(ev.record(), default=str) + "\n")

    _say(
        f"calibrated from {calib.source_run or args.report}: step "
        f"{calib.step_time_s * 1e3:.2f} ms (compute {calib.compute_s * 1e3:.2f}"
        f" ms), {calib.dense_bytes:.0f} dense B/step, W={calib.n_workers},"
        f" exposed {calib.exposed_fraction:.2f}"
    )
    for fabric, slot in plan["fabrics"].items():
        picks = "; ".join(
            f"{p['config']['name'] or p['config_key']} {p['predicted_step_s'] * 1e3:.2f} ms"
            for p in slot["ranked"][: max(1, args.top)]
        )
        _say(f"{fabric}: {picks}")
    _say(f"wrote {args.out} and {len(events)} prediction(s) -> {args.events_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
