#!/usr/bin/env python3
"""Step time of the flagship under each host data plane, in turns on one card.

Run from the root of the repository on a machine with a CUDA card::

    python3 scripts/torch_data_plane_ab.py [--steps 6] [--turns 2] [--out F]
    python3 scripts/torch_data_plane_ab.py --device cpu --preset small --steps 3 --turns 1

The flagship (``powersgd_cifar10`` full: ResNet-152, batch 512, PowerSGD
rank 4 on the xla pipeline, K1) is built once from its seed through a
one-rank group. Each variant runs ``train_loop`` for ``--steps`` steps from
that initial state through ``chip_smoke.data_plane_run``, the runner of
the smoke's ``main_path_data_plane``, under its deterministic algorithms.
The variants:

- ``numpy_p0``: ``iterate_batches`` (a numpy gather on the training
  thread), ``prefetch=0`` (a synchronous copy from pageable memory);
- ``native_p2``: the native loader (``accumulated_batches``), ``prefetch=2``
  (pinned slots, a side stream): the default path;
- ``numpy_p2``: the numpy gather with ``prefetch=2``;
- ``native_p0``: the native loader with ``prefetch=0``;
- ``native1_p2``: the native loader with one gather thread
  (``native.loader._N_THREADS = 1``), ``prefetch=2``;
- ``listed_p2``: the native loader's epoch gathered into a list before the
  loop (no worker thread while it steps), ``prefetch=2``.

All variants run ``--turns`` times, in the order given by ``--variants``
and then reversed on every other turn. One JSON line a run: each step's
host time and device time (CUDA events around the step, as ``train_loop``
takes them), their medians over the steps after the first two, the
``data_load`` and ``data_load/stage`` span medians, and the parameters'
checksum; then one summary line with each variant's medians over its
turns, whether every run ended on the same state bit for bit, and
the card's name and power limit as ``nvidia-smi`` gives them.
"""

import argparse
import contextlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WARMUP_STEPS = 2
VARIANTS = ("numpy_p0", "native_p2", "numpy_p2", "native_p0", "native1_p2", "listed_p2")


def emit(obj) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run(smoke, flagship, variant, steps, dev, images, labels):
    """One variant's run through ``chip_smoke.data_plane_run``, from the
    flagship's initial state: its JSON record and its final tensors."""
    source, prefetch = variant.split("_p")
    step, initial, snapshot, cfg = flagship
    tensors, logger, sink, _ = smoke.data_plane_run(
        step, initial, snapshot, cfg, dev, images, labels, source, int(prefetch), steps, run_name=variant
    )
    timed = logger.records[WARMUP_STEPS:]
    spans = smoke.span_p50s(sink.records, ("data_load", "data_load/stage"))
    record = {
        "variant": variant, "steps": steps,
        "step_host_ms": [r.step_time_s * 1e3 for r in logger.records],
        "step_device_ms": [r.device_time_ms for r in logger.records],
        "step_host_ms_p50": statistics.median(r.step_time_s * 1e3 for r in timed),
        "step_device_ms_p50": (
            statistics.median(r.device_time_ms for r in timed) if dev.type == "cuda" else None
        ),
        "data_load_ms_p50": spans["data_load"], "stage_ms_p50": spans["data_load/stage"],
        "params_checksum": float(sum(v.double().sum() for k, v in tensors.items() if k.startswith("params."))),
    }
    return record, tensors


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--preset", choices=["full", "small"], default="full")
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--out", default=None, help="also write every line as a JSON list here")
    args = parser.parse_args(argv)

    import torch

    from network_distributed_pytorch_tpu_torch.data.cifar10 import load_cifar10_or_synthetic
    from network_distributed_pytorch_tpu_torch.experiments import powersgd_cifar10
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )
    from network_distributed_pytorch_tpu_torch.resilience.guards import StateSnapshot

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("no CUDA device: pass --device cpu for a rehearsal\n")
        return 1
    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    variants = [v for v in args.variants.split(",") if v]
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        parser.error(f"unknown variants {sorted(unknown)}")
    images, labels, _ = load_cifar10_or_synthetic(train=True)
    smoke = _chip_smoke()
    cfg = powersgd_cifar10.default_config()
    cfg.compress_impl = "xla"
    if args.preset == "small":
        cfg.global_batch_size = 16
    lines, by_variant, first = [], {}, None
    same = True
    group = initialize_distributed(DistributedConfig(), dev)
    try:
        # one build; each run starts from its initial state, put back by the
        # guarded step's snapshot (which restores a step bit for bit)
        _, step, initial = powersgd_cifar10.build(cfg, args.preset, dev, group)
        snapshot = StateSnapshot()
        snapshot.take(initial)
        for turn in range(args.turns):
            for variant in variants if turn % 2 == 0 else variants[::-1]:
                record, tensors = run(smoke, (step, initial, snapshot, cfg), variant, args.steps, dev, images, labels)
                record["turn"] = turn
                if first is None:
                    first = tensors
                else:
                    same = same and not smoke.bitwise_equal(tensors, first)
                by_variant.setdefault(variant, []).append(record)
                lines.append(record)
                emit(record)
    finally:
        shutdown_distributed()
    smi = (
        subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        if args.device == "cuda" else "cpu"
    )
    summary = {
        "summary": True, "nvidia_smi": smi, "turns": args.turns, "params_bitwise_equal": same,
        "step_device_ms_p50": {
            v: statistics.median(r["step_device_ms_p50"] for r in rs) if args.device == "cuda" else None
            for v, rs in by_variant.items()
        },
        "step_host_ms_p50": {v: statistics.median(r["step_host_ms_p50"] for r in rs) for v, rs in by_variant.items()},
        "data_load_ms_p50": {v: statistics.median(r["data_load_ms_p50"] for r in rs) for v, rs in by_variant.items()},
    }
    lines.append(summary)
    emit(summary)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0 if same else 1


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
