"""Single-node fine-tuning of DistilBERT on IMDb, the reference's
``IMDb_distillBERT_example.py`` and the JAX package's
``experiments/imdb_baseline.py``: the accuracy and loss yardstick that the
compressed distributed run must match. One process, no group and no
collective: the exact reducer is the identity and nothing goes on the wire
but the gradient's bits, which are counted as the reference counts them.

``optimizer_name="sgd_nesterov"`` is the reference's SGD with Nesterov
momentum 0.9 at lr 5e-5 for 5 epochs; ``"adamw"`` its other baseline,
AdamW at lr 5e-5 for 3 epochs, with optax's ``adamw`` defaults (weight
decay 1e-4 on every parameter, eps 1e-8) through ``algorithm="optax"``.
Preset ``full`` is ``distilbert_base`` at batch 16 and ``max_len`` 256;
``small`` is ``distilbert_tiny`` at ``max_len`` <= 64. Dropout is off in
training (``deterministic=True``), so on the card attention runs the flash
attention kernel (K5), on bf16 q, k, v under ``compute_dtype="bfloat16"``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..data.imdb import prepare_imdb
from ..parallel.mesh import resolve_device
from ..parallel.reducers import ExactReducer
from ..parallel.trainer import make_train_step
from ..utils.config import ExperimentConfig
from .common import (
    accumulated_batches,
    compute_dtype,
    evaluate_text_classifier,
    require_defaults,
    summarize,
    train_loop,
)
from .powersgd_imdb import PER_WORKER_BATCH, build_model, sequence_classifier_loss

OPTIMIZERS = {"sgd_nesterov": 5, "adamw": 3}  # name: the reference's epochs
# optax.adamw's defaults
ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


def _epochs(optimizer_name: str) -> int:
    if optimizer_name not in OPTIMIZERS:
        raise ValueError(f"optimizer_name must be one of {tuple(OPTIMIZERS)}, got {optimizer_name!r}")
    return OPTIMIZERS[optimizer_name]


def default_config(optimizer_name: str = "sgd_nesterov") -> ExperimentConfig:
    return ExperimentConfig(
        training_epochs=_epochs(optimizer_name), learning_rate=5e-5, global_batch_size=PER_WORKER_BATCH
    )


def adamw(learning_rate: float):
    """The factory of ``optax.adamw(learning_rate)``'s counterpart. optax
    adds ``wd * p`` to the update where torch scales ``p`` by
    ``1 - lr * wd`` first: equal in exact arithmetic, not bit for bit."""

    def make(params):
        return torch.optim.AdamW(
            params, lr=learning_rate, betas=ADAMW_BETAS, eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY
        )

    return make


def build(
    config: ExperimentConfig, preset: str, device, optimizer_name: str = "sgd_nesterov", pretrained_state_dict=None
):
    """The model (from ``pretrained_state_dict`` where one is given, e.g.
    from ``models.import_weights``, else from the seed), the training step
    (no group) and its initial state."""
    _epochs(optimizer_name)
    require_defaults(
        config,
        ("compress_impl", "orthogonalize_impl", "comm_chunks", "comm_strategy", "bucket_bytes"),
        "imdb_baseline",
    )
    model = build_model(
        preset, device, seed=config.seed, attn_impl=config.attn_impl or "auto", dtype=compute_dtype(config)
    )
    if pretrained_state_dict is not None:
        model.load_state_dict(pretrained_state_dict)
    step = make_train_step(
        sequence_classifier_loss(),
        ExactReducer(),
        model,
        learning_rate=config.learning_rate,
        momentum=config.momentum,
        algorithm="optax" if optimizer_name == "adamw" else "sgd_nesterov",
        group=None,
        accum_steps=config.accum_steps,
        max_grad_norm=config.max_grad_norm,
        optimizer=adamw(config.learning_rate) if optimizer_name == "adamw" else None,
    )
    return model, step, step.init_state()


def run(
    config: Optional[ExperimentConfig] = None,
    preset: str = "small",
    data_dir: Optional[str] = None,
    device="cuda",
    max_steps_per_epoch: Optional[int] = None,
    max_len: int = 256,
    optimizer_name: str = "sgd_nesterov",
    eval_after: bool = False,
    pretrained_state_dict=None,
) -> Dict:
    """Train on one process and return the run summary. ``data_dir`` is the
    ``aclImdb`` root (None: synthetic). ``eval_after`` adds
    ``eval_accuracy`` on the validation split."""
    config = config or default_config(optimizer_name)
    if config.num_processes != 1:
        raise ValueError("imdb_baseline is the single-node baseline: it runs on one process")
    device = resolve_device(device)
    model, step, state = build(config, preset, device, optimizer_name, pretrained_state_dict)
    if preset == "small":
        max_len = min(max_len, model.config.max_position_embeddings)
    train_split, val_split, is_real = prepare_imdb(
        data_dir=data_dir, max_len=max_len, vocab_size=model.config.vocab_size, seed=config.seed
    )
    arrays = [train_split["input_ids"], train_split["attention_mask"], train_split["labels"]]
    batches = accumulated_batches(arrays, config, max_steps_per_epoch)
    state, logger = train_loop(step, state, batches, config.training_epochs, device, log_every=config.log_every)
    extra = {
        "preset": preset,
        "real_data": is_real,
        "optimizer": optimizer_name,
        "compute_dtype": config.compute_dtype,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "num_devices": 1,
        "global_batch": config.global_batch_size,
        "max_len": max_len,
        "bits_per_step": step.bits_per_step,
        "losses": [r.loss for r in logger.records],
        "step_time_s": [r.step_time_s for r in logger.records],
        "device_time_ms": [r.device_time_ms for r in logger.records],
    }
    if eval_after:
        extra["eval_accuracy"] = evaluate_text_classifier(model, val_split)
    return summarize("imdb_baseline", logger, extra)
