#!/usr/bin/env python3
"""Step time of the port's main path, ``compress_impl="xla"`` against
``"pallas"``, in turns on one card.

Run from the root of the repository on a machine with a CUDA card::

    python3 scripts/torch_compress_ab.py [--steps 8] [--order xla,pallas,pallas,xla]

Each run in ``--order`` builds the full preset (ResNet-152, ImageNet stem,
width 64, global batch 512, PowerSGD rank 4) from the same seed, joins a
one-rank NCCL group, and takes ``--steps`` steps on the same batches (at
most 8, one epoch of the 4096-image synthetic set). It
prints one JSON line per run: the step's device time (CUDA events around
the step, as ``train_loop`` takes it), the host's time inside the reducer
(``reduce_ef``, enqueue only: no synchronisation), and their medians over
the steps after the first two. Then one line with the host time of one
wrapper call per fused kernel at the largest main-path group, and the
card's name and power limit from ``nvidia-smi``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

WARMUP_STEPS = 2


def emit(obj) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def run(impl, steps, dev):
    import torch

    from network_distributed_pytorch_tpu_torch.data.cifar10 import load_cifar10_or_synthetic
    from network_distributed_pytorch_tpu_torch.experiments import powersgd_cifar10
    from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )

    cfg = powersgd_cifar10.default_config()
    cfg.compress_impl = impl
    group = initialize_distributed(DistributedConfig(), dev)
    try:
        model, step, state = powersgd_cifar10.build(cfg, "full", dev, group)
        reduce_ef = step.reducer.reduce_ef
        reducer_s = []

        def timed_reduce_ef(*args):
            t0 = time.perf_counter()
            out = reduce_ef(*args)
            reducer_s.append(time.perf_counter() - t0)
            return out

        step.reducer.reduce_ef = timed_reduce_ef
        images, labels, _ = load_cifar10_or_synthetic(train=True)
        device_ms = []
        for batch in accumulated_batches([images, labels], cfg, steps)(0):
            batch = tuple(torch.from_numpy(a).to(dev) for a in batch)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, loss = step(state, batch)
            end.record()
            loss.item()
            device_ms.append(start.elapsed_time(end))
        del model, step, state
    finally:
        shutdown_distributed()
    return {
        "compress_impl": impl, "steps": len(device_ms), "step_device_ms": device_ms,
        "reducer_host_ms": [t * 1e3 for t in reducer_s],
        "step_device_ms_p50": statistics.median(device_ms[WARMUP_STEPS:]),
        "reducer_host_ms_p50": statistics.median(reducer_s[WARMUP_STEPS:]) * 1e3,
    }


def wrapper_host_us(dev, reps=200):
    """Host time of one call of each fused wrapper at (3, 4608, 512, 4),
    enqueue only, averaged over ``reps`` calls after a warm-up."""
    import torch

    from network_distributed_pytorch_tpu_torch.ops import powersgd as ps

    gen = torch.Generator().manual_seed(0)
    g, n, m, r = 3, 4608, 512, 4
    grads, resid = (torch.randn((g, n, m), generator=gen).to(dev) for _ in range(2))
    q = torch.randn((g, m, r), generator=gen).to(dev)
    mat, p = ps.fused_ef_compress(grads, q, resid)
    phat, qn = ps.fused_orthogonalize_project(p, mat)
    calls = {
        "ef_compress": lambda: ps.fused_ef_compress(grads, q, resid),
        "compress": lambda: ps.fused_ef_compress(mat, q),
        "orthogonalize_project": lambda: ps.fused_orthogonalize_project(p, mat),
        "decompress_residual": lambda: ps.fused_decompress_residual(phat, qn, mat),
        "torch.bmm": lambda: torch.bmm(mat, q),
    }
    out = {}
    for name, fn in calls.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    return out


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--order", default="xla,pallas,pallas,xla")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("torch_compress_ab: needs a CUDA device\n")
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from network_distributed_pytorch_tpu_torch.ops import _build

    _build.build_all()  # nvcc before the first run, not inside its first step
    dev = torch.device("cuda", 0)
    for impl in args.order.split(","):
        emit(run(impl, args.steps, dev))
    emit({"wrapper_host_us_per_call": wrapper_host_us(dev)})
    sys.stdout.write(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout)


if __name__ == "__main__":
    main()
