"""GPT LM pretraining with compressed data parallelism, the JAX package's
``experiments/gpt_lm.py``: a GPT decoder trained data-parallel with
PowerSGD (``reducer="powersgd"``: rank ``config.reducer_rank``,
``matricize="last"``, error-feedback SGD with momentum) or exact all-reduce
(``"exact"``: SGD with momentum) on a synthetic next-token corpus of cyclic
sequences, the same ids as the JAX package's from the same seed.

Preset ``full`` is GPT-2 small at vocabulary 1024 (dim 768, 12 layers, 12
heads, FFN 3072; 86,628,864 parameters at ``seq_len`` 1024); ``small`` is
``gpt_tiny`` at vocabulary 64. ``max_position_embeddings`` is ``seq_len``.
Weights come from the seed (or ``pretrained_state_dict``). The model runs
without dropout (``deterministic=True``, as the JAX package's loss calls
it), so attention is the flash-attention kernel (K5, causal) on the card
and its plain version on the CPU, in ``config.compute_dtype``; parameters,
gradients and the reducer stay fp32. ``remat`` recomputes each block in
the backward (the flash forward runs twice a step); ``scan_layers`` keeps
the blocks' parameters stacked ``(n_layers, ...)`` under ``h_scan.block``,
the JAX package's scanned layout, and the reducer compresses each stacked
leaf as the JAX run does, one matrix ``(n_layers * in, out)``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.gpt import gpt_small, gpt_tiny, next_token_loss
from ..parallel.mesh import resolve_device
from ..parallel.reducers import ExactReducer, PowerSGDReducer, embedding_leaves, layer_stacked_leaves
from ..parallel.trainer import make_train_step
from ..utils.config import ExperimentConfig
from .common import compute_dtype, process_group, require_defaults, summarize, train_loop

REDUCERS = ("powersgd", "exact")


def default_config() -> ExperimentConfig:
    return ExperimentConfig(training_epochs=1, global_batch_size=32, learning_rate=0.1, reducer_rank=4)


def preset_vocab(preset: str) -> int:
    if preset not in ("small", "full"):
        raise ValueError(f"unknown preset {preset!r}")
    return 64 if preset == "small" else 1024


def synthetic_lm_batches(
    vocab: int, batch: int, seq_len: int, steps: int, seed: int
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Deterministic cyclic sequences (the next token is fully predictable)
    with a random start per row, already shifted into ``(inputs, labels)``
    int32 arrays: the JAX package's, id for id."""
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        start = rng.randint(0, vocab, (batch, 1))
        toks = ((start + np.arange(seq_len + 1)[None, :]) % vocab).astype(np.int32)
        yield toks[:, :-1], toks[:, 1:]


def build_model(
    preset: str, seq_len: int, dtype=torch.float32, device="cuda", seed: int = 0, attn_impl="auto",
    remat: bool = False, scan_layers: bool = False,
):
    make = gpt_tiny if preset == "small" else gpt_small
    return make(
        dtype=dtype, device=device, seed=seed, vocab_size=preset_vocab(preset),
        max_position_embeddings=seq_len, attn_impl=attn_impl, remat=remat, scan_layers=scan_layers,
    )


def lm_loss():
    """The trainer's loss for ``(inputs, labels)`` batches, dropout off."""

    def loss_fn(model, batch):
        x, y = batch
        return next_token_loss(model(x, deterministic=True), y)

    return loss_fn


def build(
    config: ExperimentConfig, preset: str, seq_len: int, reducer: str, device, group, pretrained_state_dict=None,
    remat: bool = False, scan_layers: bool = False,
):
    """The model, the training step and its initial state. PowerSGD runs
    the JAX package's default pipeline (the Gram-Schmidt kernel on the
    card), one collective per payload; other pipeline fields are refused.
    ``pretrained_state_dict`` is in the model's layout (under
    ``scan_layers``, ``models.gpt.stack_gpt_layer_params`` of an unrolled
    one)."""
    if reducer not in REDUCERS:
        raise ValueError(f"reducer must be one of {REDUCERS}, got {reducer!r}")
    require_defaults(
        config, ("compress_impl", "orthogonalize_impl", "comm_chunks", "comm_strategy", "bucket_bytes"), "gpt_lm"
    )
    model = build_model(
        preset, seq_len, compute_dtype(config), device, seed=config.seed, attn_impl=config.attn_impl or "auto",
        remat=remat, scan_layers=scan_layers,
    )
    if pretrained_state_dict is not None:
        model.load_state_dict(pretrained_state_dict)
    if reducer == "powersgd":
        red = PowerSGDReducer(
            random_seed=config.seed,
            compression_rank=config.reducer_rank,
            reuse_query=config.reuse_query,
            matricize="last",  # the JAX package's matrices: output features last
            features_last=embedding_leaves(model),  # wte, wpe as flax stores them
            layer_stacked=layer_stacked_leaves(model),  # h_scan.block.* under scan_layers
        )
    else:
        red = ExactReducer()
    step = make_train_step(
        lm_loss(),
        red,
        model,
        learning_rate=config.learning_rate,
        momentum=config.momentum,
        algorithm="ef_momentum" if reducer == "powersgd" else "sgd",
        group=group,
        accum_steps=config.accum_steps,
        max_grad_norm=config.max_grad_norm,
    )
    return model, step, step.init_state()


def run(
    config: Optional[ExperimentConfig] = None,
    preset: str = "small",
    reducer: str = "powersgd",
    seq_len: int = 64,
    steps_per_epoch: int = 20,
    max_steps_per_epoch: Optional[int] = None,
    remat: bool = False,
    scan_layers: bool = False,
    device="cuda",
    pretrained_state_dict=None,
) -> Dict:
    """Train and return the run summary, with ``final_perplexity``. Joins
    the default process group (creating one, of ``config.num_processes``
    ranks, if none exists), and leaves it as it found it."""
    config = config or default_config()
    device = resolve_device(device)
    if max_steps_per_epoch is not None:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    vocab = preset_vocab(preset)
    with process_group(config, device) as group:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        model, step, state = build(
            config, preset, seq_len, reducer, device, group, pretrained_state_dict, remat, scan_layers
        )

        def batches(epoch):
            return synthetic_lm_batches(vocab, config.global_batch_size, seq_len, steps_per_epoch, config.seed + epoch)

        state, logger = train_loop(
            step, state, batches, config.training_epochs, device,
            rank=rank, world_size=world, log_every=config.log_every,
        )
        params = list(model.parameters())
        extra = {
            "reducer": reducer,
            "vocab": vocab,
            "seq_len": seq_len,
            "preset": preset,
            "compute_dtype": config.compute_dtype,
            "remat": remat,
            "scan_layers": scan_layers,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "num_devices": world,
            "global_batch": config.global_batch_size,
            "tokens_per_step": config.global_batch_size * seq_len,
            "reducer_rank": config.reducer_rank if reducer == "powersgd" else None,
            "parameters": sum(p.numel() for p in params),
            "bits_per_step": step.bits_per_step,
            "shape_groups": step.reducer.n_shape_groups(params) if reducer == "powersgd" else None,
            "losses": [r.loss for r in logger.records],
            "step_time_s": [r.step_time_s for r in logger.records],
            "device_time_ms": [r.device_time_ms for r in logger.records],
        }
        return summarize("gpt_lm", logger, extra, perplexity=True)

