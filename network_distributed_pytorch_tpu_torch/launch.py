"""Launcher CLI of the port.

Usage, one process per rank (torchrun sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; mpirun's ``OMPI_COMM_WORLD_RANK`` and
``OMPI_COMM_WORLD_SIZE`` stand in for the first two where torchrun's are
absent; without them the run is one rank)::

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
    python -m network_distributed_pytorch_tpu_torch.launch exact_cifar10 --preset full --checkpoint-dir ckpt --chaos-plan plan.json
    python -m network_distributed_pytorch_tpu_torch.launch exact_cifar10 --preset full --checkpoint-dir ckpt --supervise --num-processes 4
    python -m network_distributed_pytorch_tpu_torch.launch exact_cifar10 --preset full --adaptive-comm --chaos-plan plan.json
    python -m network_distributed_pytorch_tpu_torch.launch exact_cifar10 --adaptive-comm --comm-fabric 10GbE --plan plan_doc.json
    python -m network_distributed_pytorch_tpu_torch.launch exact_cifar10 --preset full --supervise --run-dir run1 --metrics-port 0 --adaptive-comm

With ``--json`` the last line of standard output is the run summary as
JSON; ``main`` returns it either way. A worker of
``exact_cifar10 --checkpoint-dir`` that is sent SIGTERM commits an
emergency checkpoint at the next step and exits with code 75
(``resilience.PREEMPT_EXIT_CODE``); run again, it resumes there. Code 44
(``CKPT_UNWRITABLE_EXIT_CODE``) means the directory refused the save, and
code 43 (``resilience.CHAOS_EXIT_CODE``) is a ``proc_exit`` fault of a
``--chaos-plan``.

``--supervise`` makes this process the supervising parent
(``resilience.supervisor.Supervisor``): it spawns ``--num-processes``
copies of the same command, one per rank, with ``--process-id``,
``--num-processes`` and, at a world above one, a fresh ``--coordinator``
rendezvous of each generation rewritten, restarts a dead or hung rank from
the newest committed checkpoint (at a world above one, the whole
generation), and shrinks the world when a rank has spent
``--max-restarts``. It exits 3 when the run fails. The parent creates no
CUDA context; each worker takes ``cuda:<LOCAL_RANK>``, else
``cuda:<OMPI_COMM_WORLD_LOCAL_RANK>``, else the card its fleet grant names,
else ``cuda:<process id>`` (:func:`worker_cuda_device`).

``fleet`` runs the fleet control plane (``resilience.scheduler.main``):
job manifests, a JSON list given with ``--submit``, are gang-scheduled over
``--devices`` chips from the job spool at ``--spool-dir``; ``main``
returns ``{"fleet_rc": 0}`` when no job is left unfinished, else
``{"fleet_rc": 1}``, and the command exits with that code::

    python -m network_distributed_pytorch_tpu_torch.launch fleet --spool-dir jobs --devices 4 --submit jobs.json --run-dir fleet1 --out summary.json

``--run-dir D`` gives the run a directory (``observe.runlog``): the
parent's manifest ``run.json`` and its log ``events_supervisor.jsonl``,
and each rank's ``events_rank<R>.jsonl``, led by a ``run_start`` marker;
``observe.runlog.merge_run(D)`` merges them onto the parent's clock. With
``--supervise``, ``--metrics-port P`` runs the live plane in the parent
(``observe.live``): ``http://127.0.0.1:<port>/metrics`` (the bound port in
``D/metrics_port``), the detectors' alerts in the parent's log and in
``D/alerts.jsonl``, which an ``--adaptive-comm`` worker reads after every
step to nudge its fallback controller; ``--alert-restart-after N`` kills a
rank after N critical alerts of it.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Tuple

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
from .utils.bandwidth import FABRICS_BYTES_PER_S
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
# the experiments that train through resilient_train_loop: the chaos plan's
# and the heartbeat's
_CHAOS_OK = ("exact_cifar10",)
# the adaptive loop's (exact_cifar10's DDP) and the planner's
_ADAPTIVE_OK = ("exact_cifar10",)
_PLAN_OK = ("exact_cifar10", "powersgd_cifar10")
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
    # the rank, the world and the rendezvous; without them torchrun's RANK,
    # WORLD_SIZE and MASTER_ADDR/MASTER_PORT (env://), else mpirun's
    # OMPI_COMM_WORLD_RANK/SIZE, or a world of one (env_rank_and_world)
    p.add_argument(
        "--process-id", type=int, default=None,
        help="rank of this process (default: $RANK, else $OMPI_COMM_WORLD_RANK, else 0)",
    )
    p.add_argument(
        "--num-processes", type=int, default=None,
        help="world size in processes (default: $WORLD_SIZE, else $OMPI_COMM_WORLD_SIZE, else 1)",
    )
    p.add_argument(
        "--coordinator", type=str, default=None,
        help="the process group's init method, e.g. tcp://host:port or file:///path (default: env:// in a world"
             " above one)",
    )
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
        "--run-dir", type=str, default=None,
        help="run-level observability directory: the supervising parent writes the run manifest (observe.runlog)"
             " and its own event log there, each worker appends events_rank<R>.jsonl; merge with"
             " observe.runlog.merge_run (use a FRESH directory per run)",
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
    p.add_argument(
        "--chaos-plan", type=str, default=None,
        help="exact_cifar10 --checkpoint-dir: a JSON fault schedule (resilience.chaos.ChaosPlan) injected into the"
             " checkpointed loop, with two step retries and the batch guard; forwarded to workers under --supervise;"
             " with --adaptive-comm it drives the comm faults in process (no --checkpoint-dir)",
    )
    p.add_argument(
        "--adaptive-comm", action="store_true",
        help="exact_cifar10 (ddp) only: deadline watchdogs around every chunk collective and the fallback ladder"
             " of reducers (resilience.controller) walked at epoch boundaries",
    )
    p.add_argument(
        "--comm-fabric", type=str, default=None, choices=tuple(FABRICS_BYTES_PER_S),
        help="--adaptive-comm: the fabric whose modelled line rate (utils.bandwidth) budgets the collective"
             " deadlines (default NVLink4(H100)); --plan: the fabric whose best pick is applied",
    )
    p.add_argument(
        "--plan", type=str, default=None,
        help="a per-fabric plan file of scripts/torch_plan.py: apply its best comm knobs for --comm-fabric (flags given"
             " on the command line win), and under --adaptive-comm walk the fallback ladder in its order",
    )
    # --- the supervised launch (resilience.supervisor) ---------------------
    # these configure the PARENT only and are stripped from the workers'
    # command lines (_SUPERVISOR_FLAGS below)
    p.add_argument(
        "--supervise", action="store_true",
        help="run as the supervising parent: spawn --num-processes copies of this command (one per rank), restart"
             " crashed or hung ranks with a bounded backoff (the whole generation in a world above one), and"
             " shrink the world when a rank is gone for good",
    )
    p.add_argument("--max-restarts", type=int, default=3, help="supervise: restarts per rank before it is declared dead")
    p.add_argument(
        "--restart-backoff", type=float, default=0.25, help="supervise: base seconds of the bounded exponential backoff"
    )
    p.add_argument(
        "--heartbeat-dir", type=str, default=None,
        help="supervise: the shared heartbeat directory for hang detection (exact_cifar10 --checkpoint-dir workers"
             " beat it after every step)",
    )
    p.add_argument(
        "--heartbeat-timeout", type=float, default=None,
        help="supervise: seconds without a beat before a rank is killed and restarted",
    )
    p.add_argument(
        "--term-grace", type=float, default=5.0,
        help="supervise: seconds between SIGTERM and SIGKILL on every kill the supervisor makes (the window a"
             " worker's PreemptionGuard has to commit an emergency checkpoint)",
    )
    p.add_argument(
        "--min-world-size", type=int, default=1,
        help="supervise: the smallest world a degraded restart may shrink to (the quorum planner's floor)",
    )
    p.add_argument(
        "--mesh-shape", type=str, default=None,
        help="supervise: the world's mesh shape as DATAxFSDPxTENSOR (e.g. 2x1x2; the product must equal"
             " --num-processes); degraded restarts then go through the quorum planner, and workers read the shape"
             " from RESILIENCE_MESH",
    )
    p.add_argument(
        "--correlation-window", type=float, default=2.0,
        help="supervise: hard deaths of >= 2 distinct ranks within this many seconds are one correlated incident"
             " (a zone outage), replanned as a whole",
    )
    p.add_argument(
        "--no-degraded", action="store_true",
        help="supervise: declare the run dead instead of shrinking the world when a rank exhausts its restarts",
    )
    p.add_argument(
        "--worker-log-dir", type=str, default=None, help="supervise: each rank's output, one file a life"
    )
    p.add_argument(
        "--metrics-port", type=int, default=None,
        help="supervise + --run-dir: serve the live telemetry plane's Prometheus-text /metrics endpoint on this"
             " port of 127.0.0.1 (0 = ephemeral; the bound port is advertised in <run-dir>/metrics_port). Unset ="
             " live plane off",
    )
    p.add_argument(
        "--alert-restart-after", type=int, default=0,
        help="supervise live plane: restart a rank after this many sustained CRITICAL alerts attributed to it"
             " (the NaN-precursor path; restarts spend the ordinary restart budget, and at a world above one"
             " restart the whole generation; 0 = log-only)",
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


def env_rank_and_world() -> Tuple[int, int]:
    """The rank and the world from the environment: torchrun's ``RANK`` and
    ``WORLD_SIZE``, else mpirun's ``OMPI_COMM_WORLD_RANK`` and
    ``OMPI_COMM_WORLD_SIZE`` (the JAX launcher's defaults of
    ``--process-id`` and ``--num-processes``), else 0 and 1; each variable
    on its own."""
    env = os.environ
    rank = env.get("RANK", env.get("OMPI_COMM_WORLD_RANK", "0"))
    world = env.get("WORLD_SIZE", env.get("OMPI_COMM_WORLD_SIZE", "1"))
    return int(rank), int(world)


def config_from_args(args) -> ExperimentConfig:
    env_rank, env_world = env_rank_and_world()
    world = args.num_processes if args.num_processes is not None else env_world
    cfg = EXPERIMENTS[args.experiment].default_config()
    cfg.seed = args.seed
    cfg.process_id = args.process_id if args.process_id is not None else env_rank
    cfg.num_processes = world
    cfg.coordinator_address = args.coordinator if args.coordinator is not None else ("env://" if world > 1 else None)
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
        ("chaos_plan", args.chaos_plan),
        ("comm_fabric", args.comm_fabric),
    ):
        if value is not None:
            setattr(cfg, attr, value)
    cfg.adaptive_comm = args.adaptive_comm
    return cfg


def apply_plan(cfg: ExperimentConfig, args) -> None:
    """Apply the best comm knobs of a plan file (``scripts/torch_plan.py``
    writes one) for the launch's fabric onto ``cfg`` (the JAX launcher's
    ``apply_plan``): knobs
    given on the command line win over the plan, and the plan over the
    defaults. A plan whose best pick runs another reducer family than the
    experiment only warns; one with no entry for the fabric (a TPU fabric,
    say, which the port's table lacks) leaves the knobs as they are."""
    from .observe import costmodel

    with open(args.plan, "r", encoding="utf-8") as fh:
        plan = json.load(fh)
    fabric = args.comm_fabric or cfg.comm_fabric
    slot = (plan.get("fabrics") or {}).get(fabric)
    cfg.plan_path = args.plan
    if not isinstance(slot, dict):
        sys.stderr.write(f"# launch: plan {args.plan} has no fabric {fabric!r}; knobs unchanged\n")
        return
    best = costmodel.canonical_config((slot.get("best") or {}).get("config"))
    if args.comm_chunks is None and best["comm_chunks"]:
        cfg.comm_chunks = best["comm_chunks"]
    if args.comm_strategy is None:
        cfg.comm_strategy = best["comm_strategy"]
    if args.bucket_bytes is None and best["bucket_bytes"]:
        cfg.bucket_bytes = best["bucket_bytes"]
    if args.reducer_rank is None and best["reducer_rank"]:
        cfg.reducer_rank = best["reducer_rank"]
    exp_reducer = "powersgd" if "powersgd" in args.experiment else "exact"
    if best["reducer"] != exp_reducer:
        sys.stderr.write(
            f"# launch: plan's best pick for {fabric} uses the {best['reducer']!r} reducer but {args.experiment!r}"
            f" runs {exp_reducer!r} — comm knobs applied, reducer unchanged\n"
        )


# supervisor-parent-only flags, stripped from the workers' command lines
# (True: the flag takes a value), the JAX launcher's; --coordinator is
# rewritten for each generation. --run-dir is not among them: a worker
# writes its shard there
_SUPERVISOR_FLAGS = {
    "--supervise": False,
    "--max-restarts": True,
    "--restart-backoff": True,
    "--heartbeat-timeout": True,
    "--term-grace": True,
    "--min-world-size": True,
    "--mesh-shape": True,
    "--correlation-window": True,
    "--no-degraded": False,
    "--worker-log-dir": True,
    "--metrics-port": True,
    "--alert-restart-after": True,
    # re-appended per worker with the supervisor's own numbering
    "--process-id": True,
    "--num-processes": True,
    "--coordinator": True,
}


def parse_mesh_shape(spec: str) -> dict:
    """``DATAxFSDPxTENSOR`` (or the two-axis shorthand ``DATAxTENSOR``)
    into a mesh-axes dict for ``SupervisorConfig``."""
    try:
        degrees = [int(p) for p in spec.lower().replace("×", "x").split("x")]
    except ValueError:
        degrees = []
    if len(degrees) == 2:
        data, fsdp, tensor = degrees[0], 1, degrees[1]
    elif len(degrees) == 3:
        data, fsdp, tensor = degrees
    else:
        raise ValueError(
            f"--mesh-shape must look like DATAxFSDPxTENSOR (e.g. 2x1x2) or DATAxTENSOR (e.g. 2x2), got {spec!r}"
        )
    return {"data": data, "fsdp": fsdp, "tensor": tensor}


def worker_argv_base(argv) -> list:
    """The launch argv with the supervisor-only flags (and any explicit
    rank, world size or rendezvous) removed: what every worker's command
    line starts from."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        flag = a.split("=", 1)[0]
        if flag in _SUPERVISOR_FLAGS:
            skip = _SUPERVISOR_FLAGS[flag] and "=" not in a
            continue
        out.append(a)
    return out


def _supervise(args, argv) -> dict:
    """Run as the supervising parent: every worker is this same command
    with ``--process-id``, ``--num-processes`` and (in a world above one)
    the generation's ``--coordinator`` rewritten. Creates no CUDA
    context."""
    from .observe import MarkerEvent, telemetry_for_run
    from .observe import runlog
    from .resilience.supervisor import Supervisor, SupervisorConfig

    base = worker_argv_base(argv)
    supervisor = None

    def argv_for_rank(rank: int, world: int, incarnation: int) -> list:
        out = [
            sys.executable, "-m", "network_distributed_pytorch_tpu_torch.launch", *base,
            "--process-id", str(rank), "--num-processes", str(world),
        ]
        if supervisor.coordinator is not None:
            out += ["--coordinator", supervisor.coordinator]
        return out

    # with a run dir, the parent's own events go to the supervisor's log
    # there, so the merged timeline holds the failure domain
    event_log = args.event_log
    if args.run_dir and not event_log:
        event_log = os.path.join(args.run_dir, runlog.SUPERVISOR_LOG)
    world = args.num_processes if args.num_processes is not None else 1
    telemetry = telemetry_for_run(event_log=event_log)
    with telemetry:
        supervisor = Supervisor(
            argv_for_rank,
            world_size=world,
            config=SupervisorConfig(
                max_restarts=args.max_restarts,
                backoff_base_s=args.restart_backoff,
                heartbeat_dir=args.heartbeat_dir,
                heartbeat_timeout_s=args.heartbeat_timeout,
                term_grace_s=args.term_grace,
                allow_degraded=not args.no_degraded,
                min_world_size=args.min_world_size,
                seed=args.seed,
                metrics_port=args.metrics_port,
                alert_restart_after=args.alert_restart_after,
                mesh_axes=parse_mesh_shape(args.mesh_shape) if args.mesh_shape else None,
                correlation_window_s=args.correlation_window,
            ),
            telemetry=telemetry,
            log_dir=args.worker_log_dir,
            run_dir=args.run_dir,
        )
        if args.run_dir:
            telemetry.emit(MarkerEvent(kind="run_start", run_id=supervisor.run_id or "", world_size=world))
        result = supervisor.run()
    summary = {
        "supervised": True,
        "experiment": args.experiment,
        "success": result.success,
        "world_size": result.world_size,
        "total_restarts": result.total_restarts,
        "degraded": result.degraded,
        "reason": result.reason,
        "final_mesh": result.final_mesh,
        "exit_codes": {str(k): v for k, v in result.exit_codes.items()},
        # each restart's (death seen, respawned) on the parent's monotonic clock
        "restart_times": supervisor.restart_times,
    }
    if args.run_dir:
        summary["run_dir"] = args.run_dir
        summary["run_id"] = supervisor.run_id
    if args.json:
        sys.stdout.write(json.dumps(summary) + "\n")
    if not result.success:
        raise SystemExit(3)
    return summary


def worker_cuda_device(process_id, world: int, device_count=None) -> str:
    """The card a worker takes, as ``"cuda:<index>"``:

    - ``LOCAL_RANK`` where it is set (torchrun; a fleet job's manifest may
      set it to put several logical chips on one card);
    - else ``OMPI_COMM_WORLD_LOCAL_RANK`` (mpirun's rank on its host);
    - else the card the fleet granted (``RESILIENCE_DEVICE_RANKS``): a
      supervised job's workers get the job's whole list, one card a rank,
      indexed by the process id; a serving autoscaler's worker gets its
      own lease, a list of one card;
    - else the process id (0 without one): one host, a card a rank.

    A grant of any other shape raises ``ValueError``, and a card at or
    above ``device_count`` (default ``torch.cuda.device_count()``) raises
    ``RuntimeError``: a worker never folds onto another card or falls back
    to the CPU."""
    from .resilience.supervisor import ENV_DEVICE_RANKS, device_ranks_from_env

    local, source = os.environ.get("LOCAL_RANK"), "LOCAL_RANK"
    if local is None:
        local, source = os.environ.get("OMPI_COMM_WORLD_LOCAL_RANK"), "OMPI_COMM_WORLD_LOCAL_RANK"
    granted = None if local is not None else device_ranks_from_env()
    if local is not None:
        index = int(local)
    elif granted is None:
        index, source = process_id or 0, "the process id"
    elif len(granted) == 1:
        index, source = granted[0], f"{ENV_DEVICE_RANKS}={granted}"
    elif len(granted) == world and process_id is not None and 0 <= process_id < world:
        index, source = granted[process_id], f"{ENV_DEVICE_RANKS}={granted} at process id {process_id}"
    else:
        raise ValueError(
            f"{ENV_DEVICE_RANKS}={granted} is neither one card nor one card a rank of a world of {world}"
            f" (process id {process_id})"
        )
    if device_count is None:
        import torch

        device_count = torch.cuda.device_count()
    if not 0 <= index < device_count:
        raise RuntimeError(f"{source} names card {index}, but this machine has {device_count} card(s)")
    return f"cuda:{index}"


def main(argv=None) -> dict:
    raw = argv if argv is not None else sys.argv[1:]
    if raw and raw[0] == "fleet":
        # the fleet control plane over a chip inventory: the scheduler owns
        # the command line, so it is taken before the experiment parser
        from .resilience import scheduler

        return {"fleet_rc": scheduler.main(raw[1:])}
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    if args.metrics_port is not None and not (args.supervise and args.run_dir):
        raise ValueError("--metrics-port requires --supervise and --run-dir")
    if args.alert_restart_after and not args.supervise:
        raise ValueError("--alert-restart-after requires --supervise")
    if args.mesh_shape and not args.supervise:
        raise ValueError("--mesh-shape requires --supervise")
    if args.chaos_plan is not None and args.experiment not in _CHAOS_OK:
        raise ValueError(f"--chaos-plan is not supported by {args.experiment!r} (supported: {', '.join(_CHAOS_OK)})")
    if args.supervise:
        return _supervise(args, argv if argv is not None else sys.argv[1:])
    cfg = config_from_args(args)
    exp = args.experiment
    # refuse a flag the experiment does not take before any rendezvous
    if args.plan is not None:
        if exp not in _PLAN_OK:
            raise ValueError(f"--plan is not supported by {exp!r} (supported: {', '.join(_PLAN_OK)})")
        apply_plan(cfg, args)
    if args.comm_fabric is not None and not args.adaptive_comm and args.plan is None:
        raise ValueError("--comm-fabric requires --adaptive-comm or --plan")
    for flag, value, ok in (
        ("--adaptive-comm", args.adaptive_comm or None, _ADAPTIVE_OK),
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
        ("--heartbeat-dir", args.heartbeat_dir, _CHAOS_OK),
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
        ("--run-dir", args.run_dir, _EVENT_LOG_OK),
        ("--event-log", args.event_log, _EVENT_LOG_OK),
        ("--trace-dir", args.trace_dir, _PROBES_OK),
        ("--audit-wire", args.audit_wire, _PROBES_OK),
        ("--health-every", args.health_every, _PROBES_OK),
    ):
        if value is not None and exp not in ok:
            raise ValueError(f"{flag} is not supported by {exp!r} (supported: {', '.join(ok)})")
    if args.run_dir:
        # a worker rank of a run-dir launch: its shard in the run dir, and
        # the run env present so that telemetry_for_run leads the shard
        # with the run_start marker (a supervised worker inherits the
        # parent's env; setdefault keeps the parent's run id)
        from .observe import runlog

        os.environ.setdefault(runlog.ENV_RUN_DIR, args.run_dir)
        os.environ.setdefault(runlog.ENV_RUN_ID, runlog.default_run_id(args.run_dir))
        os.environ.setdefault("RESILIENCE_RANK", str(cfg.process_id))
        os.environ.setdefault("RESILIENCE_WORLD", str(cfg.num_processes))
        if not cfg.event_log:
            cfg.event_log = runlog.shard_path(args.run_dir, cfg.process_id)
    device = args.device
    if device == "cuda":
        device = worker_cuda_device(cfg.process_id, cfg.num_processes)
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
        kwargs.update(strategy=args.strategy, checkpoint_dir=args.checkpoint_dir, heartbeat_dir=args.heartbeat_dir)
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
    # `launch fleet` exits with the scheduler's code (1 while a job is left
    # unfinished); an experiment's failures raise
    sys.exit(main().get("fleet_rc", 0))
