"""Experiment configuration: the JAX package's ``ExperimentConfig``, with the
same field names and defaults, so a run of either package is described by
the same words.

Every field is ported. ``comm_fabric`` names a row of the port's own
fabric table (``utils.bandwidth.FABRICS_BYTES_PER_S``), NVLink 4 by
default, where the JAX package defaults to its TPU interconnect.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .bandwidth import FABRICS_BYTES_PER_S

ORTHOGONALIZE_IMPLS = ("auto", "eager", "cuda")
COMPRESS_IMPLS = ("xla", "pallas")
ATTN_IMPLS = ("auto", "einsum", "flash")
COMM_STRATEGIES = ("interleave", "ring")
# compute_dtype: the models' matmul dtype; parameters and gradients stay fp32
COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclass
class ExperimentConfig:
    # rendezvous
    seed: int = 714
    process_id: int = 0
    num_processes: int = 1
    coordinator_address: Optional[str] = None  # init_method, e.g. "tcp://host:port"
    timeout_seconds: int = 600

    # optimization
    learning_rate: float = 0.001
    momentum: float = 0.9
    nesterov: bool = False  # declared but unused, as in the reference
    training_epochs: int = 100
    global_batch_size: int = 256

    # compression
    reducer_rank: int = 4
    reuse_query: bool = True

    # "bfloat16": the models' matrix products, convolutions, attention and
    # activations in bf16 at the JAX package's cast points, with fp32
    # parameters (models/layers.py); bandwidth_study refuses it
    compute_dtype: str = "float32"
    log_every: int = 10
    accum_steps: int = 1  # gradient accumulation microbatches per step
    max_grad_norm: Optional[float] = None  # global-norm clipping of the reduced update
    # each packed payload as K collectives (None: one)
    comm_chunks: Optional[int] = None
    # "interleave": an all-reduce per chunk; "ring": the explicit ring of
    # point-to-point sends per chunk (reassociated, about 1 ulp)
    comm_strategy: str = "interleave"
    # the exact reducer's DDP buckets of about this many bytes, in backward
    # order (None: one packed payload)
    bucket_bytes: Optional[int] = None

    # kernel implementation, by the JAX package's names: compress_impl "xla"
    # is the plain PyTorch compress pipeline, "pallas" the fused CUDA
    # kernels of ops/powersgd.py (their plain versions on CPU tensors);
    # orthogonalize_impl "auto" | "cuda" run the CUDA Gram-Schmidt kernel on
    # CUDA tensors and its plain version on CPU tensors, "eager" always the
    # plain version; attn_impl (None = the model's "auto") picks DistilBERT's
    # attention: "flash" the CUDA flash-attention kernel on CUDA tensors and
    # its plain version on CPU tensors, "einsum" plain PyTorch
    compress_impl: str = "xla"
    orthogonalize_impl: str = "auto"
    attn_impl: Optional[str] = None

    # observability: the JSONL run log (observe.telemetry_from_config), a
    # torch.profiler trace of the training loop, the wire ledger's audit
    # against the first step's collectives (None: on with an event log) and
    # the memory and health probe every N steps (0: off)
    event_log: Optional[str] = None
    trace_dir: Optional[str] = None
    audit_wire: Optional[bool] = None
    health_every: int = 0
    # a resilience.chaos.ChaosPlan JSON file (exact_cifar10 --checkpoint-dir,
    # or --adaptive-comm, where it drives the comm faults)
    chaos_plan: Optional[str] = None
    # exact_cifar10's adaptive loop (deadline watchdogs and the fallback
    # ladder), the fabric that budgets its deadlines, and a scripts/torch_plan.py
    # plan file (the launcher's --plan)
    adaptive_comm: bool = False
    comm_fabric: str = "NVLink4(H100)"
    plan_path: Optional[str] = None

    def __post_init__(self) -> None:
        if self.compress_impl not in COMPRESS_IMPLS:
            raise ValueError(
                f"compress_impl must be one of {COMPRESS_IMPLS}, got {self.compress_impl!r}"
            )
        if self.orthogonalize_impl not in ORTHOGONALIZE_IMPLS:
            raise ValueError(
                f"orthogonalize_impl must be one of {ORTHOGONALIZE_IMPLS},"
                f" got {self.orthogonalize_impl!r}"
            )
        if self.attn_impl is not None and self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {self.compute_dtype!r}")
        if self.comm_strategy not in COMM_STRATEGIES:
            raise ValueError(
                f"comm_strategy must be one of {COMM_STRATEGIES}, got {self.comm_strategy!r}"
            )
        for name in ("comm_chunks", "bucket_bytes"):
            value = getattr(self, name)
            if value is not None and value < 1:
                raise ValueError(f"{name} must be None or >= 1, got {value}")
        if self.comm_fabric not in FABRICS_BYTES_PER_S:
            raise ValueError(f"comm_fabric must be one of {tuple(FABRICS_BYTES_PER_S)}, got {self.comm_fabric!r}")
