"""Launcher CLI of the port.

Usage, one process per rank (torchrun sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; without them the run is one rank)::

    python -m network_distributed_pytorch_tpu_torch.launch powersgd_cifar10 --preset full
    python -m network_distributed_pytorch_tpu_torch.launch powersgd_cifar10 --preset full --compress-impl pallas
    python -m network_distributed_pytorch_tpu_torch.launch powersgd_imdb --preset full
    python -m network_distributed_pytorch_tpu_torch.launch exact_cifar10 --preset full --bucket-bytes 26214400
    python -m network_distributed_pytorch_tpu_torch.launch imdb_baseline --preset full
    python -m network_distributed_pytorch_tpu_torch.launch bare_init
    torchrun --nproc-per-node 4 -m network_distributed_pytorch_tpu_torch.launch powersgd_cifar10

The last line of standard output is the run summary as JSON.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from .experiments import bare_init, exact_cifar10, imdb_baseline, powersgd_cifar10, powersgd_imdb
from .utils.config import ATTN_IMPLS, COMM_STRATEGIES, COMPRESS_IMPLS, ORTHOGONALIZE_IMPLS, ExperimentConfig

EXPERIMENTS = {
    "bare_init": bare_init,
    "exact_cifar10": exact_cifar10,
    "imdb_baseline": imdb_baseline,
    "powersgd_cifar10": powersgd_cifar10,
    "powersgd_imdb": powersgd_imdb,
}
# the default --data-dir; for the IMDb experiments it means synthetic data,
# as in the JAX package's launcher
DEFAULT_DATA_DIR = "./data"
# the experiments that take each flag, as in the JAX package's launcher;
# anywhere else the flag is refused, not ignored
_CHUNKS_OK = ("exact_cifar10", "powersgd_cifar10")
_BUCKETS_OK = ("exact_cifar10",)


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
        "--comm-chunks", type=int, default=None,
        help="split each packed reduction payload into K collectives (cifar experiments)",
    )
    p.add_argument(
        "--comm-strategy", choices=list(COMM_STRATEGIES), default=None,
        help="chunk reduction: 'interleave' (an all-reduce per chunk, bitwise the"
             " monolithic result on two ranks) or 'ring' (the explicit ring of"
             " point-to-point sends, reassociated: about 1 ulp) (cifar experiments)",
    )
    p.add_argument(
        "--bucket-bytes", type=int, default=None,
        help="exact_cifar10: pack the gradients into buckets of about B bytes in"
             " backward order, one reduction each (torch DDP's buckets)",
    )
    p.add_argument(
        "--strategy", choices=list(exact_cifar10.STRATEGIES), default="ddp",
        help="exact_cifar10: replicated DDP ('fsdp' is not ported yet and is refused)",
    )
    p.add_argument(
        "--attn-impl", choices=list(ATTN_IMPLS), default=None,
        help="DistilBERT attention (IMDb experiments): 'flash' the CUDA flash-attention"
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
        ("comm_chunks", args.comm_chunks),
        ("comm_strategy", args.comm_strategy),
        ("bucket_bytes", args.bucket_bytes),
    ):
        if value is not None:
            setattr(cfg, attr, value)
    return cfg


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    cfg = config_from_args(args)
    exp = args.experiment
    # refuse a flag the experiment does not take before any rendezvous
    for flag, value, ok in (
        ("--comm-chunks", args.comm_chunks, _CHUNKS_OK),
        ("--comm-strategy", args.comm_strategy, _CHUNKS_OK),
        ("--bucket-bytes", args.bucket_bytes, _BUCKETS_OK),
        ("--strategy", None if args.strategy == "ddp" else args.strategy, ("exact_cifar10",)),
    ):
        if value is not None and exp not in ok:
            raise ValueError(f"{flag} is not supported by {exp!r} (supported: {', '.join(ok)})")
    device = args.device
    if device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    kwargs = {"device": device}
    if exp != "bare_init":
        data_dir = args.data_dir
        if exp in ("powersgd_imdb", "imdb_baseline") and data_dir == DEFAULT_DATA_DIR:
            data_dir = None
        kwargs.update(preset=args.preset, data_dir=data_dir, max_steps_per_epoch=args.max_steps_per_epoch)
    if exp == "exact_cifar10":
        kwargs["strategy"] = args.strategy
    result = EXPERIMENTS[exp].run(cfg, **kwargs)
    sys.stdout.write(json.dumps(result) + "\n")
    return result


if __name__ == "__main__":
    main()
