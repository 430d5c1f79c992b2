"""Launcher CLI of the port.

Usage, one process per rank (torchrun sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; without them the run is one rank)::

    python -m network_distributed_pytorch_tpu_torch.launch powersgd_cifar10 --preset full
    torchrun --nproc-per-node 4 -m network_distributed_pytorch_tpu_torch.launch powersgd_cifar10

The last line of standard output is the run summary as JSON.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from .experiments import powersgd_cifar10
from .utils.config import ExperimentConfig

EXPERIMENTS = {"powersgd_cifar10": powersgd_cifar10}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("experiment", choices=sorted(EXPERIMENTS))
    p.add_argument("--preset", choices=["small", "full"], default="small")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--global-batch", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--momentum", type=float, default=None)
    p.add_argument("--reducer-rank", type=int, default=None)
    p.add_argument("--max-steps-per-epoch", type=int, default=None)
    p.add_argument("--seed", type=int, default=714)
    p.add_argument("--data-dir", type=str, default="./data")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def config_from_args(args) -> ExperimentConfig:
    world = int(os.environ.get("WORLD_SIZE", 1))
    cfg = powersgd_cifar10.default_config()
    cfg.seed = args.seed
    cfg.process_id = int(os.environ.get("RANK", 0))
    cfg.num_processes = world
    cfg.coordinator_address = "env://" if world > 1 else None
    for attr, value in (
        ("training_epochs", args.epochs),
        ("global_batch_size", args.global_batch),
        ("learning_rate", args.lr),
        ("momentum", args.momentum),
        ("reducer_rank", args.reducer_rank),
    ):
        if value is not None:
            setattr(cfg, attr, value)
    return cfg


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    cfg = config_from_args(args)
    device = args.device
    if device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    result = EXPERIMENTS[args.experiment].run(
        cfg,
        preset=args.preset,
        data_dir=args.data_dir,
        device=device,
        max_steps_per_epoch=args.max_steps_per_epoch,
    )
    sys.stdout.write(json.dumps(result) + "\n")
    return result


if __name__ == "__main__":
    main()
