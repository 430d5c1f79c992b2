"""Launcher CLI of the port.

Usage, one process per rank (torchrun sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; without them the run is one rank)::

    python -m network_distributed_pytorch_tpu_torch.launch powersgd_cifar10 --preset full
    python -m network_distributed_pytorch_tpu_torch.launch powersgd_cifar10 --preset full --compress-impl pallas
    python -m network_distributed_pytorch_tpu_torch.launch powersgd_imdb --preset full
    torchrun --nproc-per-node 4 -m network_distributed_pytorch_tpu_torch.launch powersgd_cifar10

The last line of standard output is the run summary as JSON.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from .experiments import powersgd_cifar10, powersgd_imdb
from .utils.config import ATTN_IMPLS, COMPRESS_IMPLS, ORTHOGONALIZE_IMPLS, ExperimentConfig

EXPERIMENTS = {"powersgd_cifar10": powersgd_cifar10, "powersgd_imdb": powersgd_imdb}
# the default --data-dir; for powersgd_imdb it means synthetic data, as in
# the JAX package's launcher
DEFAULT_DATA_DIR = "./data"


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
    p.add_argument("--data-dir", type=str, default=DEFAULT_DATA_DIR)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument(
        "--compress-impl", choices=list(COMPRESS_IMPLS), default=None,
        help="PowerSGD compress pipeline (powersgd_cifar10): 'pallas' runs the fused"
             " CUDA kernels (EF add + P=MQ; Gram-Schmidt + Q=M^T P; decompress +"
             " residual), one launch each per shape group",
    )
    p.add_argument(
        "--orthogonalize-impl", choices=list(ORTHOGONALIZE_IMPLS), default=None,
        help="Gram-Schmidt of the 'xla' pipeline (powersgd_cifar10): 'auto' the CUDA"
             " kernel on the card and its plain version on the CPU, 'cuda' the"
             " kernel only, 'eager' the plain version",
    )
    p.add_argument(
        "--attn-impl", choices=list(ATTN_IMPLS), default=None,
        help="DistilBERT attention (powersgd_imdb): 'flash' the CUDA flash-attention"
             " kernel on the card and its plain version on the CPU, 'einsum' plain"
             " PyTorch; 'auto' (the default) is 'flash'",
    )
    return p


def config_from_args(args) -> ExperimentConfig:
    world = int(os.environ.get("WORLD_SIZE", 1))
    cfg = EXPERIMENTS[args.experiment].default_config()
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
        ("compress_impl", args.compress_impl),
        ("orthogonalize_impl", args.orthogonalize_impl),
        ("attn_impl", args.attn_impl),
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
    data_dir = args.data_dir
    if args.experiment == "powersgd_imdb" and data_dir == DEFAULT_DATA_DIR:
        data_dir = None
    result = EXPERIMENTS[args.experiment].run(
        cfg,
        preset=args.preset,
        data_dir=data_dir,
        device=device,
        max_steps_per_epoch=args.max_steps_per_epoch,
    )
    sys.stdout.write(json.dumps(result) + "\n")
    return result


if __name__ == "__main__":
    main()
