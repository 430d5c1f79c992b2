#!/usr/bin/env python3
"""The offline planner's round trip and the critical path across four
cards: the supervising launcher of ``exact_cifar10`` under NCCL with a run
directory, its report, a plan, a relaunch on the plan, and a slow edge.

Run from the root of the repository on a machine with four CUDA cards (one
process: it starts the supervising launcher, which starts the ranks)::

    python3 scripts/torch_plan_cards.py [--out FILE]

(``--device cpu --preset small`` runs the same on four Gloo ranks with
ResNet-18.) Preset ``full`` is ``exact_cifar10``'s ResNet-50 at a global
batch of 256, 64 a rank, one epoch of ``STEPS`` steps a launch. It prints
one JSON line a scenario, then one with the card's name and power limit:

- ``plan_round_trip``: a clean launch with ``--run-dir``;
  ``scripts/torch_report.py`` on it; ``scripts/torch_plan.py
  --source-fabric "NVLink4(H100)"`` on that report; a relaunch with
  ``--plan`` (the launcher applies the ``NVLink4(H100)`` pick); then
  ``torch_report.py --plan`` on the relaunch, whose ``costmodel`` section
  holds the prediction of the config the relaunch ran against its
  measured step p50 (``error``). Held: both launches succeed, the plan has
  schema 1 and a prediction above 0 s on every fabric row, and the plan
  priced the config the relaunch ran (``matched``). Recorded: whether that
  config is the pick (``ran_pick``): the launcher applies a pick's chunk,
  strategy and bucket knobs, and only warns where the pick runs another
  reducer family than the experiment;
- ``slow_edge``: the same launch with ``--adaptive-comm`` (whose loop
  registers the chaos plan's comm faults as fence hooks) in ``CHUNKS``
  fenced chunks, its deadlines budgeted on ``1GbE`` (so that the guard
  lets the slow steps through), and a ``comm_slow_edge`` on rank 1's edge
  to rank 0 from step 2: each of rank 1's launches sleeps
  ``SLOW_SLEEP_S``. Held: the run succeeds at world 4. Recorded: the
  report's critical path (blame by rank and by phase, each step's gating
  rank) and whether it names rank 1 as the gating rank; the stragglers.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WORLD = 4
STEPS = 12
CHUNKS = 4
SLOW_STEP, SLOW_SLEEP_S = 2, 0.015
GLOBAL_BATCH = {"full": 256, "small": 32}
SOURCE_FABRIC = "NVLink4(H100)"


def script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launch(root, name, args, extra=(), faults=()):
    """One ``launch --supervise --run-dir`` in a subprocess: its summary,
    its run directory and its wall time."""
    from network_distributed_pytorch_tpu_torch.resilience import ChaosPlan

    d = os.path.join(root, name)
    run_dir = os.path.join(d, "run")
    os.makedirs(d)
    argv = [
        sys.executable, "-m", "network_distributed_pytorch_tpu_torch.launch", "exact_cifar10",
        "--preset", args.preset, "--device", args.device, "--global-batch", str(GLOBAL_BATCH[args.preset]),
        "--epochs", "1", "--max-steps-per-epoch", str(STEPS), "--supervise", "--num-processes", str(WORLD),
        "--run-dir", run_dir, "--json", "--log-every", "0", "--worker-log-dir", os.path.join(d, "logs"), *extra,
    ]
    if faults:
        ChaosPlan(list(faults)).save(os.path.join(d, "chaos.json"))
        argv += ["--chaos-plan", os.path.join(d, "chaos.json")]
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(argv, cwd=d, env=env, capture_output=True, text=True, timeout=args.timeout)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    summary = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    if summary is None:
        tails = {}
        logs = os.path.join(d, "logs")
        for log in sorted(os.listdir(logs)) if os.path.isdir(logs) else []:
            with open(os.path.join(logs, log)) as f:
                tails[log] = f.read()[-1500:]
        summary = {"success": False, "returncode": proc.returncode, "stderr": proc.stderr[-2000:], "logs": tails}
    return summary, run_dir, wall


def report_of(run_dir, out, *extra):
    """``scripts/torch_report.py`` on ``run_dir``: the report dict."""
    if script("torch_report").main(["--run-dir", run_dir, "--json-out", out, *extra]) != 0:
        return None
    with open(out) as f:
        return json.load(f)


def failure_kinds(run_dir):
    """The ``FailureEvent`` kinds of a run directory's logs, with counts."""
    from network_distributed_pytorch_tpu_torch.observe import runlog

    kinds = {}
    for e in runlog.merge_run(run_dir).events:
        if e.get("event") == "failure":
            kinds[e.get("kind")] = kinds.get(e.get("kind"), 0) + 1
    return kinds


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--preset", choices=["full", "small"], default="full")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--out", default=None, help="also write the records here, one JSON line each")
    args = p.parse_args()
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
            raise SystemExit(f"needs {WORLD} CUDA cards")
    from network_distributed_pytorch_tpu_torch.resilience import FaultSpec

    records, ok = [], True
    root = tempfile.mkdtemp(prefix="plan_cards_")
    common = {"world": WORLD, "preset": args.preset, "global_batch": GLOBAL_BATCH[args.preset], "steps": STEPS}

    # ---- plan_round_trip ----------------------------------------------------------
    clean, clean_dir, clean_wall = launch(root, "clean", args)
    rec = {"scenario": "plan_round_trip", **common, "clean": clean, "clean_wall_s": clean_wall}
    report = report_of(clean_dir, os.path.join(root, "clean_report.json")) if clean.get("success") else None
    plan_path = os.path.join(root, "plan.json")
    planned = None
    if report is not None:
        rc = script("torch_plan").main([
            "--report", os.path.join(root, "clean_report.json"), "--source-fabric", SOURCE_FABRIC,
            "--out", plan_path, "--events-out", os.path.join(root, "predictions.jsonl"),
        ])
        with open(plan_path) as f:
            plan = json.load(f)
        best = plan["fabrics"][SOURCE_FABRIC]["best"]
        rec.update(
            clean_step_p50_s=report["step_p50_s"], clean_compile=report["compile"], clean_mfu=report["mfu"],
            clean_critpath={k: report["critpath"][k] for k in ("n_steps", "comm_share", "blame_by_rank",
                                                                "blame_by_phase")} if report["critpath"] else None,
            plan_rc=rc, calibration=plan["calibration"], best={f: s["best"]["config"]["name"]
                                                              for f, s in plan["fabrics"].items()},
            best_on_source_fabric=best,
        )
        ok &= rc == 0 and plan["schema"] == 1 and all(
            p["predicted_step_s"] > 0 for s in plan["fabrics"].values() for p in s["ranked"])
        relaunch, relaunch_dir, relaunch_wall = launch(root, "planned", args, extra=("--plan", plan_path))
        rec.update(relaunch=relaunch, relaunch_wall_s=relaunch_wall)
        if relaunch.get("success"):
            planned = report_of(relaunch_dir, os.path.join(root, "planned_report.json"), "--plan", plan_path,
                                "--plan-fabric", SOURCE_FABRIC)
    if planned is not None:
        joined = planned.get("costmodel") or {}
        rec.update(planned_step_p50_s=planned["step_p50_s"], planned_compile=planned["compile"], costmodel=joined,
                   ran_pick=joined.get("config_key") == best["config_key"])
    ok &= bool(clean.get("success") and planned is not None and (planned.get("costmodel") or {}).get("matched"))
    records.append(rec)

    # ---- slow_edge ---------------------------------------------------------------
    slow = {"edge": [1, 0], "bytes_per_s": 1e3, "max_sleep_s": SLOW_SLEEP_S, "duration_steps": STEPS}
    summary, slow_dir, wall = launch(
        root, "slow_edge", args, extra=("--adaptive-comm", "--comm-chunks", str(CHUNKS), "--comm-fabric", "1GbE"),
        faults=[FaultSpec(kind="comm_slow_edge", step=SLOW_STEP, rank=1, payload=slow)],
    )
    rec = {"scenario": "slow_edge", **common, "chunks": CHUNKS, "fault": {"step": SLOW_STEP, **slow},
           "summary": summary, "wall_s": wall}
    report = report_of(slow_dir, os.path.join(root, "slow_report.json")) if summary.get("success") else None
    if report is not None and report["critpath"]:
        crit = report["critpath"]
        late = [e for e in crit["events"] if e["step"] >= SLOW_STEP]
        gating = max(crit["blame_by_rank"], key=crit["blame_by_rank"].get)
        rec.update(
            step_p50_s=report["step_p50_s"], per_rank={r: {k: v for k, v in s.items() if k in ("n", "p50_s")}
                                                      for r, s in (report.get("ranks") or {}).items()},
            critpath={k: crit[k] for k in ("n_steps", "comm_share", "blame_by_rank", "blame_by_phase", "top_edge")},
            gating_rank_by_step=[(e["step"], e["rank"], e["phase"]) for e in crit["events"]],
            gating_rank=int(gating), rank1_gates=gating == "1",
            rank1_share_after_fault=sum(e["rank"] == 1 for e in late) / len(late) if late else None,
            stragglers=report["stragglers"], compile=report["compile"], failures=failure_kinds(slow_dir),
        )
    ok &= bool(summary.get("success") and summary.get("world_size") == WORLD and report is not None
               and report["critpath"])
    records.append(rec)

    smi = "cpu"
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
    records.append({"nvidia_smi": smi, "ok": ok})
    for r in records:
        print(json.dumps(r, default=str), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for r in records:
                f.write(json.dumps(r, default=str) + "\n")
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
