#!/usr/bin/env python3
"""The supervising launcher across four cards: ``launch exact_cifar10
--checkpoint-dir D --supervise --num-processes 4`` under NCCL, with a rank
killed, and with a rank dying past ``--max-restarts``.

Run from the root of the repository on a machine with four CUDA cards (one
process: it starts the supervising launcher, which starts the ranks)::

    python3 scripts/torch_supervisor_cards.py [--out FILE]

(``--device cpu --preset small`` runs the same scenarios on four Gloo
ranks with ResNet-18.) Preset ``full`` is ``exact_cifar10``'s ResNet-50,
at a global batch of 240 so that it splits over 4 ranks and over 3. The
workers run under deterministic algorithms (a ``sitecustomize`` on their
``PYTHONPATH``). It prints one JSON line a scenario, then one with the
card's name and power limit:

- ``kill``: rank 2 SIGKILLs itself before its fifth step (in epoch 1 of
  2, 3 steps an epoch). At a world above one the supervisor restarts the
  whole generation: the survivors are sent SIGTERM, and SIGKILL after
  ``--term-grace``. The record says how each survivor ended (it raised out
  of NCCL by itself, left on SIGTERM, or hung until SIGKILL), the time from
  the death to the new generation's first step, and the final checkpoint
  against an unkilled four-card run's: bit for bit, or the largest
  difference relative to ``max(1, max|unkilled|)`` of its leaf, held to
  ``TOL``;
- ``shrink``: rank 3 exits in every life before its fifth step, with
  ``--max-restarts 1`` and 3 epochs: after its restart it dies again, the
  world shrinks to 3 ranks as ``plan_mesh`` says, and the survivors resume
  from the four-rank checkpoint through the resharder (``resharded``) and
  finish.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TOL = 1e-5
WORLD = 4
EPOCHS, STEPS = 2, 3
GLOBAL_BATCH = {"full": 240, "small": 24}
SITECUSTOMIZE = """import os
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch
torch.use_deterministic_algorithms(True, warn_only=True)
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
"""


def checkpoint_leaves(path):
    """Every tensor of the payload files of the checkpoint at ``path``, by
    file and key path."""
    import torch

    leaves = {}

    def walk(key, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{key}/{k}", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{key}/{i}", v)
        elif torch.is_tensor(x):
            leaves[key] = x

    for name in sorted(os.listdir(path)):
        if name.endswith(".pt"):
            walk(name, torch.load(os.path.join(path, name), weights_only=True, map_location="cpu"))
    return leaves


def run_supervised(root, name, args, faults, extra=()):
    """One ``launch --supervise`` in a subprocess: its summary, the run's
    events, its wall time and its checkpoint directory."""
    from network_distributed_pytorch_tpu_torch.resilience import ChaosPlan

    run_dir = os.path.join(root, name)
    os.makedirs(run_dir)
    argv = [
        sys.executable, "-m", "network_distributed_pytorch_tpu_torch.launch", "exact_cifar10",
        "--preset", args.preset, "--device", args.device, "--global-batch", str(GLOBAL_BATCH[args.preset]),
        "--epochs", str(args.epochs), "--max-steps-per-epoch", str(STEPS),
        "--checkpoint-dir", os.path.join(run_dir, "ckpt"), "--supervise", "--num-processes", str(WORLD),
        "--restart-backoff", "0.05", "--term-grace", str(args.term_grace), "--json", "--log-every", "0",
        "--event-log", os.path.join(run_dir, "events.jsonl"), "--worker-log-dir", os.path.join(run_dir, "logs"),
        *extra,
    ]
    if faults:
        ChaosPlan(faults).save(os.path.join(run_dir, "plan.json"))
        argv += ["--chaos-plan", os.path.join(run_dir, "plan.json")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([args.site, REPO, os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=run_dir, env=env, capture_output=True, text=True, timeout=args.timeout)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    summary = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    events = []
    if os.path.exists(os.path.join(run_dir, "events.jsonl")):
        with open(os.path.join(run_dir, "events.jsonl")) as f:
            for line in f:
                try:
                    events.append(json.loads(line))
                except ValueError:
                    pass
    if summary is None:
        tails = {}
        for log in sorted(os.listdir(os.path.join(run_dir, "logs"))) if os.path.isdir(os.path.join(run_dir, "logs")) else []:
            with open(os.path.join(run_dir, "logs", log)) as f:
                tails[log] = f.read()[-1500:]
        summary = {"success": False, "returncode": proc.returncode, "stderr": proc.stderr[-2000:], "logs": tails}
    return summary, events, wall, os.path.join(run_dir, "ckpt")


def recovery(summary, events):
    """Each restart's time from the death the supervisor saw to the first
    step the new generation finished (on the host's monotonic clock), ms."""
    steps = [e["ts_mono"] for e in events if e.get("event") == "step" and "ts_mono" in e]
    out = []
    for died, respawned in summary.get("restart_times", []):
        after = [t for t in steps if t > respawned]
        out.append((min(after) - died) * 1e3 if after else None)
    return out


def survivors(events):
    """How the ranks that did not cause a generation restart ended."""
    out = []
    for e in events:
        if e.get("event") != "failure":
            continue
        msg = e.get("message", "")
        if e.get("kind") == "worker_exit" and "after a peer's death" in msg:
            out.append({"rank": e.get("rank"), "ended": "raised", "message": msg})
        elif e.get("kind") == "worker_term":
            hard = "(hard exit)" in msg or msg.startswith("hard ")
            out.append({"rank": e.get("rank"), "ended": "hung until SIGKILL" if hard else "left on SIGTERM", "message": msg})
    return out


def compare(got_dir, want_dir):
    import torch

    from network_distributed_pytorch_tpu_torch.utils.checkpoint import latest_step_path

    got, want = checkpoint_leaves(latest_step_path(got_dir)), checkpoint_leaves(latest_step_path(want_dir))
    worst, leaf, differ = 0.0, None, 0
    for k, w in want.items():
        g = got.get(k)
        if g is None or g.shape != w.shape:
            return {"missing_or_reshaped": k}
        if not torch.equal(g, w):
            differ += 1
            if w.is_floating_point():
                d = (g.double() - w.double()).abs().max().item() / max(1.0, w.double().abs().max().item())
                if d > worst:
                    worst, leaf = d, k
            else:
                worst, leaf = float("inf"), k
    return {"leaves": len(want), "leaves_differing": differ, "bitwise": differ == 0, "max_rel_diff": worst,
            "max_rel_diff_leaf": leaf, "within_tol": worst <= TOL, "tol": TOL}


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--preset", choices=["full", "small"], default="full")
    p.add_argument("--term-grace", type=float, default=10.0)
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--out", default=None, help="also write the records here, one JSON line each")
    args = p.parse_args()
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
            raise SystemExit(f"needs {WORLD} CUDA cards")
    from network_distributed_pytorch_tpu_torch.resilience import FaultSpec

    records = []
    root = tempfile.mkdtemp(prefix="supervisor_cards_")
    args.site = os.path.join(root, "site")
    os.makedirs(args.site)
    with open(os.path.join(args.site, "sitecustomize.py"), "w") as f:
        f.write(SITECUSTOMIZE)
    ok = True

    args.epochs = EPOCHS
    clean, clean_events, clean_wall, clean_ckpt = run_supervised(root, "unkilled", args, [])
    killed, events, wall, ckpt = run_supervised(
        root, "kill", args, [FaultSpec(kind="proc_kill", step=STEPS + 1, rank=2)]
    )
    rec = {
        "scenario": "kill", "world": WORLD, "preset": args.preset, "global_batch": GLOBAL_BATCH[args.preset],
        "epochs": EPOCHS, "steps_per_epoch": STEPS, "unkilled": clean, "killed": killed,
        "unkilled_wall_s": clean_wall, "killed_wall_s": wall, "time_lost_s": wall - clean_wall,
        "death_to_first_step_ms": recovery(killed, events), "survivors": survivors(events),
        "resumed": [e.get("message") for e in events if e.get("kind") == "resumed"],
    }
    if clean.get("success") and killed.get("success"):
        rec["final_checkpoint"] = compare(ckpt, clean_ckpt)
    ok &= bool(killed.get("success") and killed.get("total_restarts") == 1 and rec.get("final_checkpoint", {}).get("within_tol"))
    records.append(rec)

    args.epochs = EPOCHS + 1
    shrunk, events, wall, _ = run_supervised(
        root, "shrink", args, [FaultSpec(kind="proc_exit", step=STEPS + 1, rank=3, incarnation=None)],
        extra=("--max-restarts", "1"),
    )
    rec = {
        "scenario": "shrink", "world": WORLD, "preset": args.preset, "global_batch": GLOBAL_BATCH[args.preset],
        "epochs": args.epochs, "steps_per_epoch": STEPS, "max_restarts": 1, "summary": shrunk, "wall_s": wall,
        "death_to_first_step_ms": recovery(shrunk, events), "survivors": survivors(events),
        "reshapes": [e for e in events if e.get("event") == "reshape"],
        "resharded": [e.get("message") for e in events if e.get("kind") == "resharded"],
    }
    ok &= bool(shrunk.get("success") and shrunk.get("world_size") == 3 and shrunk.get("degraded") and rec["resharded"])
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
