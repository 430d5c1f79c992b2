#!/usr/bin/env python3
"""Collective windows of ``main_path_live``'s worker, with and without the native loader.

Run from the root of the repository on a machine with a CUDA card::

    python3 scripts/torch_live_deadline_bisect.py [--pairs 5] [--out F]
    python3 scripts/torch_live_deadline_bisect.py --device cpu --preset small --pairs 1

Each launch is ``chip_smoke.py``'s ``main_path_live`` launch (``launch
exact_cifar10 --supervise --adaptive-comm --run-dir D --metrics-port 0``,
2 epochs of ``LIVE_STEPS`` steps in ``LIVE_CHUNKS`` fenced chunks, the
worker under deterministic algorithms), through ``chip_smoke.live_launcher``.
The arms alternate, ``native`` (the default: the CIFAR batches from the
native loader's worker thread) and ``numpy`` (``NDP_TPU_NO_NATIVE=1``: the
numpy gather on the training thread), the first of each pair swapped on
every other pair.

A probe in the worker's ``sitecustomize`` registers a fence hook ahead of
the collective watchdog. At every fence point it reads the host's clock,
the training thread's CPU time and its voluntary and involuntary context
switches (``/proc/thread-self/status``, where the kernel counts them) and
the process's thread count.
A sampler thread takes the training thread's Python stack 20 ms and 45 ms
into any window still open, and a ``gc`` callback keeps every collection
of 1 ms or more. A window is one chunk's, from its launch fence to the next
fence point: the interval the watchdog holds against its deadline.

One JSON line a launch: the final rung, the policy decisions, the
deadline expiries, the step times, the window count, its p50, p99 and
maximum, the windows of 20 ms or more (step, chunk, wall and CPU ms,
context switches, stacks, collections inside) and the thread counts.
Then one summary line per arm and the card's name and power limit as
``nvidia-smi`` gives them. Exit 1 if a launch failed.
"""

import argparse
import contextlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SLOW_MS = 20.0

# appended to the workers' sitecustomize; runs only where FENCE_PROBE_LOG is set
PROBE = '''

def _fence_probe():
    import gc
    import threading
    import time

    path = os.environ.get("FENCE_PROBE_LOG")
    if not path:
        return
    from network_distributed_pytorch_tpu_torch.parallel import comm

    fences, stacks, collections = [], [], []
    cond = threading.Condition()
    open_window = {"seq": None, "t": None, "tid": None}

    def status():
        out = {}
        with open("/proc/thread-self/status") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key in ("voluntary_ctxt_switches", "nonvoluntary_ctxt_switches"):
                    out[key[:3]] = int(value)
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("Threads:"):
                    out["threads"] = int(line.split()[1])
        return out

    def hook(info):
        now = time.monotonic()
        fences.append({"phase": info.get("phase"), "tag": info.get("tag"), "chunk": info.get("chunk"),
                       "n_chunks": info.get("n_chunks"), "t": now, "cpu": time.thread_time(), **status()})
        with cond:
            if info.get("phase") == "launch":
                open_window.update(seq=len(fences) - 1, t=now, tid=threading.get_ident())
            else:
                open_window.update(seq=None, t=None)
            cond.notify_all()

    def sampler():
        while True:
            with cond:
                while open_window["seq"] is None:
                    cond.wait()
                seq, t0, tid = open_window["seq"], open_window["t"], open_window["tid"]
            for at in (0.020, 0.045):
                with cond:
                    cond.wait_for(lambda: open_window["seq"] != seq, timeout=max(0.0, t0 + at - time.monotonic()))
                    if open_window["seq"] != seq:
                        break
                frame = sys._current_frames().get(tid)
                stack = []
                while frame is not None and len(stack) < 14:
                    stack.append(f"{frame.f_code.co_filename.rsplit('/', 2)[-1]}:{frame.f_lineno} {frame.f_code.co_name}")
                    frame = frame.f_back
                stacks.append({"seq": seq, "at_ms": 1e3 * (time.monotonic() - t0), "stack": stack})
            with cond:
                cond.wait_for(lambda: open_window["seq"] != seq)

    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.monotonic()
        elif "t" in started:
            dur = time.monotonic() - started.pop("t")
            if dur >= 1e-3:
                collections.append({"t": time.monotonic() - dur, "ms": 1e3 * dur, "generation": info["generation"]})

    def dump():
        if fences:
            with open(f"{path}.{os.getpid()}.json", "w") as f:
                json.dump({"fences": fences, "stacks": stacks, "collections": collections}, f)

    comm.add_fence_hook(hook)
    gc.callbacks.append(on_gc)
    threading.Thread(target=sampler, name="fence-probe", daemon=True).start()
    atexit.register(dump)


_fence_probe()
'''


def emit(obj) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def windows_of(probe):
    """Each chunk's window, from its launch fence to the next fence point,
    with the step it belongs to (the retires before it)."""
    fences, out, retires = probe["fences"], [], 0
    for seq, (a, b) in enumerate(zip(fences, fences[1:])):
        if a["phase"] != "launch":
            retires += 1
            continue
        wall = 1e3 * (b["t"] - a["t"])
        w = {
            "seq": seq, "step": retires, "tag": a["tag"], "chunk": a["chunk"], "wall_ms": wall,
            "cpu_ms": 1e3 * (b["cpu"] - a["cpu"]), "threads": a.get("threads"),
            # None where the kernel's status file has no such counter
            **{f"{k}_switches": b[c] - a[c] if c in a and c in b else None
               for k, c in (("voluntary", "vol"), ("involuntary", "non"))},
        }
        if wall >= SLOW_MS:
            w["stacks"] = [s for s in probe["stacks"] if s["seq"] == seq]
            w["collections"] = [c for c in probe["collections"] if a["t"] <= c["t"] <= b["t"]]
        out.append(w)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--preset", choices=["full", "small"], default="full")
    parser.add_argument("--pairs", type=int, default=5)
    parser.add_argument("--out", default=None, help="also write every line as a JSON list here")
    args = parser.parse_args(argv)

    import torch

    from network_distributed_pytorch_tpu_torch.observe import runlog

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("no CUDA device: pass --device cpu for a rehearsal\n")
        return 1
    smoke = _chip_smoke()
    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    root, launch_live = smoke.live_launcher(dev, args.preset, site_extra=PROBE)
    arms = {"native": {}, "numpy": {"NDP_TPU_NO_NATIVE": "1"}}
    lines, by_arm, ok = [], {}, True
    try:
        for pair in range(args.pairs):
            for arm in ("native", "numpy") if pair % 2 == 0 else ("numpy", "native"):
                name = f"{arm}_{pair}"
                probe_log = os.path.join(root, f"{name}.fence")
                try:
                    run = launch_live(name, plane=True, env={**arms[arm], "FENCE_PROBE_LOG": probe_log})
                except SystemExit:  # chip_smoke.fail: the launch did not finish
                    ok = False
                    emit({"launch": name, "arm": arm, "failed": True})
                    continue
                probes = [os.path.join(root, f) for f in os.listdir(root) if f.startswith(f"{name}.fence.")]
                windows = []
                for p in probes:
                    with open(p) as f:
                        windows += windows_of(json.load(f))
                shard = smoke.read_records(runlog.shard_path(run["run_dir"], 0))
                walls = sorted(w["wall_ms"] for w in windows)
                record = {
                    "launch": name, "arm": arm, "pair": pair,
                    "final_rung": run["worker"]["final_rung"],
                    "policy": [r.get("trigger") for r in shard if r.get("event") == "policy"],
                    "deadline_expiries": [
                        {k: r.get(k) for k in ("label", "message", "step")}
                        for r in shard if r.get("event") == "failure" and r.get("kind") == "comm_deadline"
                    ],
                    "step_ms": [1e3 * r["step_time_s"] for r in shard if r.get("event") == "step"],
                    "windows": len(walls),
                    "window_ms_p50": statistics.median(walls) if walls else None,
                    "window_ms_p99": walls[min(len(walls) - 1, int(0.99 * len(walls)))] if walls else None,
                    "window_ms_max": walls[-1] if walls else None,
                    "slow_windows": [w for w in windows if w["wall_ms"] >= SLOW_MS],
                    "threads": sorted({w["threads"] for w in windows if w["threads"] is not None}),
                    "launch_wall_s": run["wall_s"],
                }
                by_arm.setdefault(arm, []).append(record)
                lines.append(record)
                emit(record)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    smi = (
        subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        if args.device == "cuda" else "cpu"
    )
    for arm, records in by_arm.items():
        summary = {
            "summary": arm, "launches": len(records), "nvidia_smi": smi,
            "launches_with_expiry": sum(bool(r["deadline_expiries"]) for r in records),
            "launches_off_baseline": sum(r["final_rung"] != "baseline" for r in records),
            "window_ms_max": [r["window_ms_max"] for r in records],
            "window_ms_p50": [r["window_ms_p50"] for r in records],
            "slow_windows": sum(len(r["slow_windows"]) for r in records),
            "step_ms_p50": [statistics.median(r["step_ms"][2:]) for r in records if len(r["step_ms"]) > 2],
        }
        lines.append(summary)
        emit(summary)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
