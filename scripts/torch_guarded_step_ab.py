#!/usr/bin/env python3
"""The guarded step's cost on the flagship: ResNet-152 PowerSGD (batch 512,
rank 4, the xla pipeline) stepping through ``resilience.GuardedStep``
(two retries: a snapshot of the state before every step) and through the
plain step, in turns, from one state.

Run from the root of the repository on a machine with a CUDA card::

    python3 scripts/torch_guarded_step_ab.py [--root DIR]

``--root`` imports the port from another checkout (unpack it with ``git
archive <commit> | tar -x -C _parent``), so two versions are compared in
one call: ``for r in _parent . . _parent; do python3
scripts/torch_guarded_step_ab.py --root $r; done``. Prints one JSON line:
each side's step times after a warm-up turn (host clock, synchronised),
their p50s, and the p50 of the snapshot's ``take`` alone, with the card's
name and power limit.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

TURNS = 16


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from network_distributed_pytorch_tpu_torch.data.cifar10 import load_cifar10_or_synthetic
    from network_distributed_pytorch_tpu_torch.experiments import powersgd_cifar10
    from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )
    from network_distributed_pytorch_tpu_torch.resilience import GuardedStep, guards

    if not os.path.abspath(guards.__file__).startswith(root):
        raise SystemExit(f"imported {guards.__file__}, not the port under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    images, labels, _ = load_cifar10_or_synthetic(train=True)
    group = initialize_distributed(DistributedConfig(), dev)
    try:
        cfg = powersgd_cifar10.default_config()
        cfg.compress_impl = "xla"
        _, step, state = powersgd_cifar10.build(cfg, "full", dev, group)
        batch = next(iter(accumulated_batches([images, labels], cfg, 1)(0)))
        batch = tuple(torch.from_numpy(a).to(dev) for a in batch)
        guarded = GuardedStep(step, retries=2, backoff_seconds=0.0)
        plain_ms, guarded_ms, take_ms = [], [], []
        for turn in range(TURNS):
            for fn, times in ((step, plain_ms), (guarded, guarded_ms)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = fn(state, batch)
                float(loss)
                torch.cuda.synchronize()
                if turn:  # the first turn allocates the snapshot's buffers
                    times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            guarded.snapshot.take(state)
            torch.cuda.synchronize()
            if turn:
                take_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        shutdown_distributed()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({
        "root": args.root, "plain_p50_ms": statistics.median(plain_ms), "guarded_p50_ms": statistics.median(guarded_ms),
        "take_p50_ms": statistics.median(take_ms), "plain_ms": plain_ms, "guarded_ms": guarded_ms, "nvidia_smi": smi,
    }), flush=True)


if __name__ == "__main__":
    main()
