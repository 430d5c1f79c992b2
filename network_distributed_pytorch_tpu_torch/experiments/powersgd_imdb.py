"""PowerSGD-compressed data-parallel fine-tuning of DistilBERT on IMDb, the
reference's ``ddp_powersgd_distillBERT_IMDb`` and the JAX package's
``experiments/powersgd_imdb.py``.

Preset ``full`` is the reference configuration: ``distilbert_base``
(vocab 30522, dim 768, 6 layers, 12 heads, FFN 3072; 66,955,010
parameters), 16 sequences per worker at ``max_len`` 256, PowerSGD rank 16
with ``matricize="last"``, error-feedback SGD with lr 5e-5 and momentum 0.9.
Preset ``small`` is ``distilbert_tiny`` at ``max_len`` <= 64. Without IMDb
on disk the data is the deterministic synthetic stand-in; weights come from
the seed. Dropout is off in training, as in the JAX package's loss
(``deterministic=True``), so attention runs flash attention (K5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..data.imdb import prepare_imdb
from ..models.distilbert import distilbert_base, distilbert_tiny
from ..parallel.mesh import resolve_device
from ..parallel.reducers import PowerSGDReducer, embedding_leaves
from ..parallel.trainer import make_train_step
from ..utils.config import ExperimentConfig
from ..utils.losses import cross_entropy_loss
from .common import accumulated_batches, process_group, require_defaults, summarize, train_loop

PER_WORKER_BATCH = 16


def default_config() -> ExperimentConfig:
    return ExperimentConfig(
        training_epochs=5,
        learning_rate=5e-5,
        reducer_rank=16,
        global_batch_size=0,  # 16 per worker, set by run()
    )


def build_model(preset: str, device="cuda", seed: int = 0, attn_impl: str = "auto"):
    if preset == "full":
        return distilbert_base(num_labels=2, device=device, seed=seed, attn_impl=attn_impl)
    if preset == "small":
        return distilbert_tiny(num_labels=2, device=device, seed=seed, attn_impl=attn_impl)
    raise ValueError(f"unknown preset {preset!r}")


def sequence_classifier_loss():
    """The trainer's loss for ``(input_ids, attention_mask, labels)``
    batches: cross-entropy of the logits, with dropout off as in the JAX
    package's loss (the trainer puts the model in train mode)."""

    def loss_fn(model, batch):
        input_ids, attention_mask, labels = batch
        return cross_entropy_loss(model(input_ids, attention_mask, deterministic=True), labels)

    return loss_fn


def build(config: ExperimentConfig, preset: str, device, group):
    """The model, the training step and its initial state. The reducer is
    the JAX package's: its default pipeline (``compress_impl="xla"``, the
    Gram-Schmidt kernel on the card) and one collective per payload; other
    values are refused."""
    require_defaults(
        config,
        ("compress_impl", "orthogonalize_impl", "comm_chunks", "comm_strategy", "bucket_bytes"),
        "powersgd_imdb",
    )
    model = build_model(preset, device, seed=config.seed, attn_impl=config.attn_impl or "auto")
    reducer = PowerSGDReducer(
        random_seed=config.seed,
        compression_rank=config.reducer_rank,
        reuse_query=config.reuse_query,
        matricize="last",  # the JAX package's matrices: output features last
        features_last=embedding_leaves(model),
    )
    step = make_train_step(
        sequence_classifier_loss(),
        reducer,
        model,
        learning_rate=config.learning_rate,
        momentum=config.momentum,
        algorithm="ef_momentum",
        group=group,
        accum_steps=config.accum_steps,
        max_grad_norm=config.max_grad_norm,
    )
    return model, step, step.init_state()


def run(
    config: Optional[ExperimentConfig] = None,
    preset: str = "small",
    data_dir: Optional[str] = None,
    device="cuda",
    max_steps_per_epoch: Optional[int] = None,
    max_len: int = 256,
) -> Dict:
    """Train and return the run summary. ``data_dir`` is the ``aclImdb``
    root (None: synthetic). Joins the default process group (creating one,
    of ``config.num_processes`` ranks, if none exists), and leaves it as it
    found it."""
    config = config or default_config()
    device = resolve_device(device)
    with process_group(config, device) as group:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        if not config.global_batch_size:
            config = dataclasses.replace(config, global_batch_size=PER_WORKER_BATCH * world)
        model, step, state = build(config, preset, device, group)
        if preset == "small":
            max_len = min(max_len, model.config.max_position_embeddings)
        train_split, _, is_real = prepare_imdb(
            data_dir=data_dir, max_len=max_len, vocab_size=model.config.vocab_size, seed=config.seed
        )
        arrays = [train_split["input_ids"], train_split["attention_mask"], train_split["labels"]]
        batches = accumulated_batches(arrays, config, max_steps_per_epoch)
        state, logger = train_loop(
            step, state, batches, config.training_epochs, device,
            rank=rank, world_size=world, log_every=config.log_every,
        )
        params = list(model.parameters())
        extra = {
            "preset": preset,
            "real_data": is_real,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "num_devices": world,
            "reducer_rank": config.reducer_rank,
            "global_batch": config.global_batch_size,
            "max_len": max_len,
            "bits_per_step": step.bits_per_step,
            "shape_groups": step.reducer.n_shape_groups(params),
            "losses": [r.loss for r in logger.records],
            "step_time_s": [r.step_time_s for r in logger.records],
            "device_time_ms": [r.device_time_ms for r in logger.records],
        }
        return summarize("powersgd_imdb", logger, extra)
