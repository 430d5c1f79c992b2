"""Launcher CLI of the port.

Usage, one process per rank (torchrun sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; without them the run is one rank)::

    python -m network_distributed_pytorch_tpu_torch.launch powersgd_cifar10 --preset full
    python -m network_distributed_pytorch_tpu_torch.launch powersgd_cifar10 --preset full --compress-impl pallas
    python -m network_distributed_pytorch_tpu_torch.launch powersgd_imdb --preset full
    python -m network_distributed_pytorch_tpu_torch.launch exact_cifar10 --preset full --bucket-bytes 26214400
    python -m network_distributed_pytorch_tpu_torch.launch imdb_baseline --preset full
    python -m network_distributed_pytorch_tpu_torch.launch gpt_lm --preset full --dtype bfloat16
    python -m network_distributed_pytorch_tpu_torch.launch gpt_lm --preset full --remat --scan-layers
    python -m network_distributed_pytorch_tpu_torch.launch powersgd_cifar10 --preset full --dtype bfloat16 --json
    python -m network_distributed_pytorch_tpu_torch.launch powersgd_imdb --accum-steps 2 --max-grad-norm 1.0
    python -m network_distributed_pytorch_tpu_torch.launch gpt_generate --preset full --max-new-tokens 128
    python -m network_distributed_pytorch_tpu_torch.launch diloco_cifar10 --preset full --diloco-reducer powersgd
    python -m network_distributed_pytorch_tpu_torch.launch diloco_cifar10 --preset full --fragments 4
    python -m network_distributed_pytorch_tpu_torch.launch bandwidth_study --preset full
    python -m network_distributed_pytorch_tpu_torch.launch serve_gpt --preset full --slots 8 --requests 32
    python -m network_distributed_pytorch_tpu_torch.launch serve_gpt --preset full --engine paged --spec-k 4
    python -m network_distributed_pytorch_tpu_torch.launch exact_cifar10 --preset full --checkpoint-dir ckpt
    python -m network_distributed_pytorch_tpu_torch.launch serve_gpt --preset full --checkpoint-dir ckpt
    python -m network_distributed_pytorch_tpu_torch.launch bare_init
    torchrun --nproc-per-node 4 -m network_distributed_pytorch_tpu_torch.launch powersgd_cifar10
    torchrun --nproc-per-node 4 -m network_distributed_pytorch_tpu_torch.launch gpt_tp --model-shards 2 --tp-reducer powersgd
    torchrun --nproc-per-node 4 -m network_distributed_pytorch_tpu_torch.launch gpt_sp --preset full
    torchrun --nproc-per-node 4 -m network_distributed_pytorch_tpu_torch.launch gpt_pp --data-shards 2 --checkpoint-dir ckpt
    torchrun --nproc-per-node 4 -m network_distributed_pytorch_tpu_torch.launch gpt_moe --experts-per-device 2 --moe-top-k 2

With ``--json`` the last line of standard output is the run summary as
JSON; ``main`` returns it either way. A worker of
``exact_cifar10 --checkpoint-dir`` that is sent SIGTERM commits an
emergency checkpoint at the next step and exits with code 75
(``resilience.PREEMPT_EXIT_CODE``); run again, it resumes there. Code 44
(``CKPT_UNWRITABLE_EXIT_CODE``) means the directory refused the save.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from .experiments import (
    bandwidth_study,
    bare_init,
    diloco_cifar10,
    exact_cifar10,
    gpt_generate,
    gpt_lm,
    gpt_moe,
    gpt_pp,
    gpt_sp,
    gpt_tp,
    imdb_baseline,
    powersgd_cifar10,
    powersgd_imdb,
    serve_gpt,
)
from .utils.config import (
    ATTN_IMPLS,
    COMM_STRATEGIES,
    COMPRESS_IMPLS,
    COMPUTE_DTYPES,
    ORTHOGONALIZE_IMPLS,
    ExperimentConfig,
)

EXPERIMENTS = {
    "bandwidth_study": bandwidth_study,
    "bare_init": bare_init,
    "diloco_cifar10": diloco_cifar10,
    "exact_cifar10": exact_cifar10,
    "gpt_generate": gpt_generate,
    "gpt_lm": gpt_lm,
    "gpt_moe": gpt_moe,
    "gpt_pp": gpt_pp,
    "gpt_sp": gpt_sp,
    "gpt_tp": gpt_tp,
    "imdb_baseline": imdb_baseline,
    "powersgd_cifar10": powersgd_cifar10,
    "powersgd_imdb": powersgd_imdb,
    "serve_gpt": serve_gpt,
}
# the default --data-dir; for the IMDb experiments it means synthetic data,
# as in the JAX package's launcher
DEFAULT_DATA_DIR = "./data"
# the experiments that take each flag, as in the JAX package's launcher;
# anywhere else the flag is refused, not ignored
_CHUNKS_OK = ("exact_cifar10", "powersgd_cifar10")
_BUCKETS_OK = ("exact_cifar10",)
_GENERATE_OK = ("gpt_generate",)
_SERVE_OK = ("serve_gpt",)
_DILOCO_OK = ("diloco_cifar10",)
_CHECKPOINT_OK = ("exact_cifar10", "serve_gpt", "gpt_pp", "gpt_sp")
# the model-parallel GPT entries' own flags, as the JAX launcher gives them
_TP_OK, _PP_OK, _MOE_OK = ("gpt_tp",), ("gpt_pp",), ("gpt_moe",)
# the JAX launcher's: gradient accumulation and clipping, rematerialisation
# and the stacked layer layout
_ACCUM_OK = ("exact_cifar10", "powersgd_cifar10", "powersgd_imdb", "imdb_baseline")
_REMAT_OK = ("gpt_lm", "powersgd_imdb")
_SCAN_OK = ("gpt_lm",)
# the experiments that build a telemetry registry from the config, and
# those whose training loop takes the trace, the audit and the probes
_PROBES_OK = ("exact_cifar10", "powersgd_cifar10")
_EVENT_LOG_OK = _PROBES_OK + ("bandwidth_study", "bare_init", "diloco_cifar10", "serve_gpt")
# the experiments whose epochs of steps --max-steps-per-epoch caps
_STEPS_OK = (
    "diloco_cifar10", "exact_cifar10", "gpt_lm", "gpt_moe", "gpt_pp", "gpt_sp", "gpt_tp", "imdb_baseline",
    "powersgd_cifar10", "powersgd_imdb",
)
# the JAX launcher's gpt_generate defaults
DEFAULT_MAX_NEW_TOKENS, DEFAULT_TEMPERATURE = 64, 0.0
# serve_gpt's defaults where a flag is not given, as in the JAX launcher
SERVE_DEFAULTS = {
    "slots": 4, "requests": 16, "request_rate": 64.0, "engine": "slot", "block_len": 16, "spec_k": 0,
    "max_wall_s": 120.0,
}


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
        "--accum-steps", type=int, default=None,
        help="gradient-accumulation microbatches per step (cifar and imdb experiments)",
    )
    p.add_argument(
        "--max-grad-norm", type=float, default=None,
        help="clip the reduced update to this global norm (cifar/imdb experiments)",
    )
    p.add_argument("--log-every", type=int, default=10, help="log the mean loss every N steps (0: never)")
    p.add_argument(
        "--event-log", type=str, default=None,
        help="append structured JSONL telemetry (steps, wire ledger, compile"
             " audits) to this path; read it back with scripts/report.py",
    )
    p.add_argument(
        "--trace-dir", type=str, default=None,
        help="capture a torch.profiler trace of the training loop under this directory (trace.json)",
    )
    p.add_argument(
        "--audit-wire", action="store_true", default=None,
        help="force the wire audit, the ledger against the first step's issued collectives (default:"
             " on whenever --event-log is set)",
    )
    p.add_argument(
        "--health-every", type=int, default=None,
        help="emit a TrainHealthEvent (grad norm, EF memory norm, PowerSGD"
             " relative compression error) and a MemoryEvent every N steps via the separately"
             " dispatched health probe (cifar experiments; 0/unset = never, zero overhead)",
    )
    p.add_argument("--json", action="store_true", help="print the summary as JSON")
    p.add_argument(
        "--remat", action="store_true",
        help="rematerialize transformer blocks in the backward pass (gpt_lm, powersgd_imdb)",
    )
    p.add_argument(
        "--scan-layers", action="store_true",
        help="gpt_lm only: the blocks' parameters stacked (n_layers, ...) under h_scan.block, the JAX"
             " package's scanned layout, applied layer by layer; same math",
    )
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
        help="exact_cifar10: replicated DDP, or 'fsdp': parameters, gradients and momenta sharded over the"
             " ranks (ZeRO-3); fsdp refuses --checkpoint-dir and --comm-strategy ring",
    )
    p.add_argument(
        "--attn-impl", choices=list(ATTN_IMPLS), default=None,
        help="transformer attention (gpt_lm and the IMDb experiments): 'flash' the CUDA"
             " flash-attention kernel on the card and its plain version on the CPU,"
             " 'einsum' plain PyTorch; 'auto' (the default) is 'flash'",
    )
    p.add_argument(
        "--dtype", choices=list(COMPUTE_DTYPES), default=None,
        help="compute dtype of the models: 'bfloat16' runs matmuls, convolutions, attention and"
             " activations in bf16 at flax's cast points with fp32 parameters, gradients and wire;"
             " bandwidth_study refuses it",
    )
    p.add_argument(
        "--sync-every", type=int, default=None,
        help="diloco_cifar10 only: local steps per outer sync round (default 8)",
    )
    p.add_argument(
        "--fragments", type=int, default=None,
        help="diloco_cifar10 only: >1 switches to streaming DiLoCo (one fragment synced a round)",
    )
    p.add_argument(
        "--diloco-reducer", choices=list(diloco_cifar10.REDUCERS), default=None,
        help="diloco_cifar10 only: the reducer of the outer parameter delta (default exact);"
             " --lr names the inner learning rate there",
    )
    p.add_argument(
        "--max-new-tokens", type=int, default=None,
        help=f"gpt_generate: tokens to generate; serve_gpt: each request's decode budget cap"
             f" (uniform in [2, this]) (default {DEFAULT_MAX_NEW_TOKENS})",
    )
    p.add_argument(
        "--temperature", type=float, default=None,
        help=f"gpt_generate only: 0 is greedy (default {DEFAULT_TEMPERATURE})",
    )
    # --- serve_gpt (the serving/ continuous-batching engines) -------------
    p.add_argument("--slots", type=int, default=None, help="serve_gpt only: the engine's batch slots (default 4)")
    p.add_argument(
        "--requests", type=int, default=None, help="serve_gpt only: requests in the Poisson workload (default 16)"
    )
    p.add_argument(
        "--request-rate", type=float, default=None, help="serve_gpt only: Poisson arrivals a second (default 64)"
    )
    p.add_argument(
        "--spool-dir", type=str, default=None,
        help="serve_gpt only: a shared file-spool request queue (the fleet mode: ranks share only the spool)",
    )
    p.add_argument(
        "--engine", choices=["slot", "paged"], default=None,
        help="serve_gpt only: 'slot' (a dense cache a slot) or 'paged' (a block pool with copy-on-write"
             " prefix sharing) (default slot)",
    )
    p.add_argument("--block-len", type=int, default=None, help="serve_gpt only (--engine paged): tokens a KV block (default 16)")
    p.add_argument(
        "--n-blocks", type=int, default=None,
        help="serve_gpt only (--engine paged): blocks in the pool (default: the dense cache's bytes,"
             " slots * max_len / block_len + 1)",
    )
    p.add_argument(
        "--no-prefix-sharing", action="store_true",
        help="serve_gpt only (--engine paged): no copy-on-write prompt-prefix sharing",
    )
    p.add_argument(
        "--spec-k", type=int, default=None,
        help="serve_gpt only (--engine paged): speculative decoding, K steps a round (default off)",
    )
    p.add_argument(
        "--max-wall-s", type=float, default=None, help="serve_gpt only: the run's wall-clock limit (default 120)"
    )
    p.add_argument(
        "--checkpoint-dir", type=str, default=None,
        help="exact_cifar10: train through the checkpointed loop (a committed checkpoint an epoch, resume"
             " on entry, SIGTERM -> emergency checkpoint and exit 75); serve_gpt: hot-load the parameters"
             " of the newest committed training checkpoint; gpt_pp, gpt_sp: save the carry every epoch and"
             " resume the newest",
    )
    # --- the model-parallel GPT entries -----------------------------------
    p.add_argument(
        "--model-shards", type=int, default=None,
        help="gpt_tp only: tensor-parallel shards, mesh ('data', 'model') (default 4)",
    )
    p.add_argument(
        "--tp-reducer", choices=list(gpt_tp.REDUCERS), default=None,
        help="gpt_tp only: data-axis gradient reduction when ranks > --model-shards (default exact)",
    )
    p.add_argument(
        "--vocab-parallel", action="store_true",
        help="gpt_tp only: shard the tied token table over vocabulary rows and compute the CE without"
             " full-vocabulary logits",
    )
    p.add_argument(
        "--data-shards", type=int, default=None,
        help="gpt_pp only: data parallelism over the pipeline, mesh ('data', 'pipe') (default 1)",
    )
    p.add_argument(
        "--pp-reducer", choices=list(gpt_pp.REDUCERS), default=None,
        help="gpt_pp only: cross-shard gradient reduction when --data-shards > 1 (default exact)",
    )
    p.add_argument(
        "--experts-per-device", type=int, default=None,
        help="gpt_moe only: local experts a rank (total = ranks x this) (default 1)",
    )
    p.add_argument(
        "--moe-reducer", choices=list(gpt_moe.REDUCERS), default=None,
        help="gpt_moe only: reduction of the replicated (non-expert) parameters (default exact)",
    )
    p.add_argument(
        "--moe-top-k", type=int, default=None, help="gpt_moe only: experts a token (1 Switch, 2 GShard) (default 1)"
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
        ("compute_dtype", args.dtype),
        ("comm_chunks", args.comm_chunks),
        ("comm_strategy", args.comm_strategy),
        ("bucket_bytes", args.bucket_bytes),
        ("accum_steps", args.accum_steps),
        ("max_grad_norm", args.max_grad_norm),
        ("log_every", args.log_every),
        ("event_log", args.event_log),
        ("trace_dir", args.trace_dir),
        ("audit_wire", args.audit_wire),
        ("health_every", args.health_every),
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
        ("--max-new-tokens", args.max_new_tokens, _GENERATE_OK + _SERVE_OK),
        ("--temperature", args.temperature, _GENERATE_OK),
        ("--sync-every", args.sync_every, _DILOCO_OK),
        ("--fragments", args.fragments, _DILOCO_OK),
        ("--diloco-reducer", args.diloco_reducer, _DILOCO_OK),
        ("--max-steps-per-epoch", args.max_steps_per_epoch, _STEPS_OK),
        ("--dtype", args.dtype, tuple(n for n in EXPERIMENTS if n not in ("bare_init", "bandwidth_study"))),
        *(
            (flag, getattr(args, flag[2:].replace("-", "_")), _SERVE_OK)
            for flag in (
                "--slots", "--requests", "--request-rate", "--spool-dir", "--engine", "--block-len", "--n-blocks",
                "--spec-k", "--max-wall-s",
            )
        ),
        ("--checkpoint-dir", args.checkpoint_dir, _CHECKPOINT_OK),
        ("--no-prefix-sharing", args.no_prefix_sharing or None, _SERVE_OK),
        ("--model-shards", args.model_shards, _TP_OK),
        ("--tp-reducer", args.tp_reducer, _TP_OK),
        ("--vocab-parallel", args.vocab_parallel or None, _TP_OK),
        ("--data-shards", args.data_shards, _PP_OK),
        ("--pp-reducer", args.pp_reducer, _PP_OK),
        ("--experts-per-device", args.experts_per_device, _MOE_OK),
        ("--moe-reducer", args.moe_reducer, _MOE_OK),
        ("--moe-top-k", args.moe_top_k, _MOE_OK),
        ("--accum-steps", args.accum_steps if cfg.accum_steps > 1 else None, _ACCUM_OK),
        ("--max-grad-norm", args.max_grad_norm, _ACCUM_OK),
        ("--remat", args.remat or None, _REMAT_OK),
        ("--scan-layers", args.scan_layers or None, _SCAN_OK),
        ("--event-log", args.event_log, _EVENT_LOG_OK),
        ("--trace-dir", args.trace_dir, _PROBES_OK),
        ("--audit-wire", args.audit_wire, _PROBES_OK),
        ("--health-every", args.health_every, _PROBES_OK),
    ):
        if value is not None and exp not in ok:
            raise ValueError(f"{flag} is not supported by {exp!r} (supported: {', '.join(ok)})")
    device = args.device
    if device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    kwargs = {"device": device}
    if exp == "gpt_generate":
        kwargs.update(
            preset=args.preset,
            max_new_tokens=DEFAULT_MAX_NEW_TOKENS if args.max_new_tokens is None else args.max_new_tokens,
            temperature=DEFAULT_TEMPERATURE if args.temperature is None else args.temperature,
        )
    elif exp == "serve_gpt":
        kwargs.update(
            preset=args.preset,
            max_new_tokens=DEFAULT_MAX_NEW_TOKENS if args.max_new_tokens is None else args.max_new_tokens,
            spool_dir=args.spool_dir, n_blocks=args.n_blocks, prefix_sharing=not args.no_prefix_sharing,
            checkpoint_dir=args.checkpoint_dir,
        )
        for name, default in SERVE_DEFAULTS.items():
            value = getattr(args, name)
            kwargs[name] = default if value is None else value
    elif exp in ("gpt_lm", "gpt_moe", "gpt_pp", "gpt_sp", "gpt_tp"):
        kwargs.update(preset=args.preset, max_steps_per_epoch=args.max_steps_per_epoch)
        if exp == "gpt_lm":
            kwargs.update(remat=args.remat, scan_layers=args.scan_layers)
        for name, value in {
            "gpt_tp": (("model_shards", args.model_shards), ("reducer", args.tp_reducer),
                       ("vocab_parallel", args.vocab_parallel or None)),
            "gpt_pp": (("data_shards", args.data_shards), ("reducer", args.pp_reducer),
                       ("checkpoint_dir", args.checkpoint_dir)),
            "gpt_sp": (("checkpoint_dir", args.checkpoint_dir),),
            "gpt_moe": (("experts_per_device", args.experts_per_device), ("reducer", args.moe_reducer),
                        ("top_k", args.moe_top_k)),
        }.get(exp, ()):
            if value is not None:
                kwargs[name] = value
    elif exp == "bandwidth_study":
        kwargs.update(preset=args.preset, global_batch=cfg.global_batch_size)
    elif exp != "bare_init":
        data_dir = args.data_dir
        if exp in ("powersgd_imdb", "imdb_baseline") and data_dir == DEFAULT_DATA_DIR:
            data_dir = None
        kwargs.update(preset=args.preset, data_dir=data_dir, max_steps_per_epoch=args.max_steps_per_epoch)
    if exp == "powersgd_imdb":
        kwargs.update(remat=args.remat)
    if exp == "exact_cifar10":
        kwargs.update(strategy=args.strategy, checkpoint_dir=args.checkpoint_dir)
    if exp == "diloco_cifar10":
        for name, value in (
            ("sync_every", args.sync_every), ("fragments", args.fragments), ("reducer", args.diloco_reducer),
            # --lr names the INNER rate here (see diloco_cifar10.run)
            ("inner_learning_rate", args.lr),
        ):
            if value is not None:
                kwargs[name] = value
    result = EXPERIMENTS[exp].run(cfg, **kwargs)
    if args.json:
        sys.stdout.write(json.dumps(result) + "\n")
    return result


if __name__ == "__main__":
    main()
