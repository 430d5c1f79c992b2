"""Benchmark scaffolds, the JAX package's ``utils/benchmarks.py`` for the
port: the analytic FLOPs of a GPT training step, and one way to build that
step and time it."""

from __future__ import annotations

import statistics
import time
from typing import Dict


def gpt_analytic_train_flops(n_params: float, n_layers: int, dim: int, seq_len: int, batch: int) -> float:
    """Training-step FLOPs by the PaLM appendix's accounting (the basis of
    published MFU): ``6 N`` a token for the parameter products (forward
    ``2 N``, backward ``4 N``) and ``12 L d s`` for attention's two
    products, forward and backward. Embedding lookups are gathers; the
    tied head is a product already inside ``N``."""
    return (6.0 * n_params + 12.0 * n_layers * dim * seq_len) * batch * seq_len


def time_gpt_train_step(
    *,
    small: bool = False,
    seq_len: int = 1024,
    batch: int = 8,
    vocab: int = 50257,
    attn_impl: str = "auto",
    scan_layers: bool = False,
    reps: int = 10,
    learning_rate: float = 1e-3,
    device="cuda",
) -> Dict:
    """The step time and tokens a second of one exact-DDP GPT training step
    of the port (``GPTLM`` in bf16, ``ExactReducer``, ``"sgd"``, one
    process) on ``device``: GPT-2 small's shape, or the test tier's
    ``gpt_tiny`` with ``small``. One warm-up step (it builds the kernels),
    then three bursts of ``reps`` steps, each timed by CUDA events on a
    card (the host clock on the CPU); the step time is the median burst."""
    import torch

    from ..models.gpt import gpt_small, gpt_tiny, next_token_loss
    from ..parallel.mesh import resolve_device
    from ..parallel.reducers import ExactReducer
    from ..parallel.trainer import make_train_step

    device = resolve_device(device)
    make = gpt_tiny if small else gpt_small
    model = make(
        dtype=torch.bfloat16, device=device, vocab_size=vocab, max_position_embeddings=seq_len, dropout=0.0,
        attn_impl=attn_impl, scan_layers=scan_layers,
    )

    def loss(m, b):
        x, y = b
        return next_token_loss(m(x, deterministic=True), y)

    step = make_train_step(loss, ExactReducer(), model, learning_rate, momentum=0.9, algorithm="sgd")
    state = step.init_state()
    toks = (torch.arange(seq_len + 1, dtype=torch.int32)[None, :] % vocab).expand(batch, seq_len + 1)
    batch_xy = (toks[:, :-1].contiguous().to(device), toks[:, 1:].contiguous().to(device))
    n_params = float(sum(p.numel() for p in model.parameters()))
    cfg = model.config
    state, l = step(state, batch_xy)  # warm-up
    l.item()
    on_cuda = device.type == "cuda"
    bursts = []
    for _ in range(3):
        if on_cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        for _ in range(reps):
            state, l = step(state, batch_xy)
        if on_cuda:
            end.record()
            end.synchronize()
            bursts.append(start.elapsed_time(end) / 1e3 / reps)
        else:
            l.item()
            bursts.append((time.perf_counter() - t0) / reps)
    dt = statistics.median(bursts)
    return {
        "model": "gpt_tiny" if small else "gpt2_small_124M",
        "seq_len": seq_len,
        "batch": batch,
        "attn_impl": attn_impl,
        "scan_layers": scan_layers,
        "device": torch.cuda.get_device_name(device) if on_cuda else "cpu",
        "step_time_ms": round(1000.0 * dt, 3),
        "step_time_ms_bursts": [round(1000.0 * b, 3) for b in sorted(bursts)],
        "tokens_per_sec": round(batch * seq_len / dt, 1),
        "n_params": n_params,
        "flops_per_step": gpt_analytic_train_flops(n_params, cfg.n_layers, cfg.dim, seq_len, batch),
        "flops_method": "analytic_6N+12Lds (PaLM appendix)",
    }
