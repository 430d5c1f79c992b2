"""Experiment configuration: the JAX package's ``ExperimentConfig``, with the
same field names and defaults, so a run of either package is described by
the same words.

Fields whose feature the port does not have yet keep their slot and their
default; setting one to anything else raises ``NotImplementedError`` rather
than being ignored (see ``ROADMAP.md`` for what is still to be ported).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

ORTHOGONALIZE_IMPLS = ("auto", "eager", "cuda")


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

    compute_dtype: str = "float32"
    log_every: int = 10
    accum_steps: int = 1  # gradient accumulation microbatches per step
    max_grad_norm: Optional[float] = None  # global-norm clipping of the reduced update
    comm_chunks: Optional[int] = None
    comm_strategy: str = "interleave"
    bucket_bytes: Optional[int] = None

    # kernel implementation: compress_impl "xla" is the plain PyTorch
    # compress pipeline (the fused kernels are the next slice);
    # orthogonalize_impl "auto" | "cuda" run the CUDA Gram-Schmidt kernel on
    # CUDA tensors and its plain version on CPU tensors, "eager" always the
    # plain version
    compress_impl: str = "xla"
    orthogonalize_impl: str = "auto"
    attn_impl: Optional[str] = None

    # observability, resilience and planning: not ported yet
    event_log: Optional[str] = None
    trace_dir: Optional[str] = None
    audit_wire: Optional[bool] = None
    health_every: int = 0
    chaos_plan: Optional[str] = None
    adaptive_comm: bool = False
    comm_fabric: str = "ICI(v5e)"
    plan_path: Optional[str] = None

    def __post_init__(self) -> None:
        if self.compress_impl == "pallas":
            raise NotImplementedError(
                "compress_impl='pallas' (the fused PowerSGD kernels) is not ported yet"
            )
        if self.compress_impl != "xla":
            raise ValueError(f"unknown compress_impl {self.compress_impl!r}")
        if self.orthogonalize_impl not in ORTHOGONALIZE_IMPLS:
            raise ValueError(
                f"orthogonalize_impl must be one of {ORTHOGONALIZE_IMPLS},"
                f" got {self.orthogonalize_impl!r}"
            )
        defaults = {f.name: f.default for f in fields(self)}
        for name in _NOT_PORTED:
            if getattr(self, name) != defaults[name]:
                raise NotImplementedError(f"ExperimentConfig.{name} is not ported yet")


_NOT_PORTED = (
    "compute_dtype", "comm_chunks", "comm_strategy", "bucket_bytes", "attn_impl", "event_log",
    "trace_dir", "audit_wire", "health_every", "chaos_plan", "adaptive_comm",
    "comm_fabric", "plan_path",
)
