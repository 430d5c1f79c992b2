"""GPT tensor-parallel pretraining, the JAX package's
``experiments/gpt_tp.py``: the decoder trained with Megatron TP over a
``model`` mesh axis (``models.gpt.tp_gpt_forward``: head-sharded attention
and the column -> row MLP, two all-reduces a block), composed with data
parallelism over a ``data`` axis, optionally PowerSGD-compressed.

Each model rank reduces ITS shards' gradients across the data replicas:
PowerSGD with error feedback (memories a data worker; warm-start Q a model
rank), or the exact mean. The replicated leaves (LayerNorms, positions,
the token table unless ``vocab_parallel``) get the same gradient on every
model rank (the TP block's ``copy_to_axis`` sums their cotangents over the
model axis) and are reduced EXACTLY over ``data``, as in the JAX entry.
With one data shard there is no reduction at all, and PowerSGD is refused.

Presets: ``small`` dim 32, 2 layers, 8 heads (so it shards up to 8 ranks),
vocabulary 64; ``full`` GPT-2 small's widths (dim 768, 12 layers, 12 heads)
at vocabulary 1024; FFN ``2 * dim``; ``max_position_embeddings`` is
``seq_len``. Weights are the port ``GPTLM``'s from the seed (or
``pretrained_state_dict``), cut into this rank's shards.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..models.gpt import (
    GPTConfig,
    GPTLM,
    gpt_tp_param_specs,
    next_token_loss,
    tp_gpt_forward,
    tp_shard,
    vocab_parallel_next_token_loss,
)
from ..parallel.comm import all_reduce_mean
from ..parallel.mesh import make_mesh, resolve_device
from ..parallel.reducers import ExactReducer, PowerSGDReducer
from ..parallel.trainer import ef_momentum_update, sgd_momentum_update
from ..utils.config import ExperimentConfig
from .common import Carry, carry_loop, compute_dtype, process_group, summarize
from .gpt_lm import synthetic_lm_batches

REDUCERS = ("exact", "powersgd")


def default_config() -> ExperimentConfig:
    return ExperimentConfig(training_epochs=1, global_batch_size=16, learning_rate=0.1)


def tp_config(preset: str, seq_len: int, dtype) -> GPTConfig:
    if preset not in ("small", "full"):
        raise ValueError(f"unknown preset {preset!r}")
    small = preset == "small"
    dim = 32 if small else 768
    return GPTConfig(
        vocab_size=64 if small else 1024, max_position_embeddings=seq_len, dim=dim, n_layers=2 if small else 12,
        n_heads=8 if small else 12, hidden_dim=2 * dim, dropout=0.0, dtype=dtype,
    )


def make_reducer(config: ExperimentConfig, reducer: str, sharded):
    """The data axis' reducer of the model-sharded leaves ``sharded`` (names,
    in the order it is given them): PowerSGD at ``config.reducer_rank``
    with the JAX package's matrices, or the exact mean."""
    if reducer != "powersgd":
        return ExactReducer()
    return PowerSGDReducer(
        random_seed=config.seed, compression_rank=config.reducer_rank, matricize="last",
        # the token table as flax stores it, (num, dim)
        features_last=[i for i, k in enumerate(sharded) if k == "wte.weight"],
    )


def run(
    config: Optional[ExperimentConfig] = None,
    preset: str = "small",
    model_shards: int = 4,
    reducer: str = "exact",
    vocab_parallel: bool = False,
    seq_len: int = 32,
    steps_per_epoch: int = 15,
    max_steps_per_epoch: Optional[int] = None,
    device="cuda",
    pretrained_state_dict=None,
) -> Dict:
    """``model_shards`` ranks hold each layer's head and feature shards;
    the world over ``model_shards`` forms the data axis. ``reducer`` in
    {"exact", "powersgd"} reduces over the data axis only."""
    config = config or default_config()
    device = resolve_device(device)
    if reducer not in REDUCERS:
        raise ValueError(f"reducer must be one of {REDUCERS}, got {reducer!r}")
    if max_steps_per_epoch is not None:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    cfg = tp_config(preset, seq_len, compute_dtype(config))
    with process_group(config, device) as world:
        n_world = dist.get_world_size(world)
        if n_world % model_shards:
            raise ValueError(f"model_shards={model_shards} must divide the device count ({n_world})")
        n_data, n_model = n_world // model_shards, model_shards
        if cfg.n_heads % n_model:
            raise ValueError(
                f"model_shards={n_model} must divide n_heads={cfg.n_heads} (attention is head-sharded);"
                " pick a divisor of the head count"
            )
        if vocab_parallel and cfg.vocab_size % n_model:
            raise ValueError(f"vocab_parallel needs model_shards={n_model} to divide vocab_size={cfg.vocab_size}")
        if reducer == "powersgd" and n_data <= 1:
            raise ValueError(
                "reducer='powersgd' needs a data axis (n_devices > model_shards): with one data shard there is"
                " no cross-shard collective to compress"
            )
        mesh = make_mesh((n_data, n_model), ("data", "model"))
        model_group, data_group = mesh.group("model"), mesh.group("data")
        m_idx, d_idx = mesh.axis_index("model"), mesh.axis_index("data")
        full = GPTLM(cfg, device="cpu", seed=config.seed)
        if pretrained_state_dict is not None:
            full.load_state_dict(pretrained_state_dict)
        specs = gpt_tp_param_specs(cfg, vocab_parallel)
        params = {
            k: v.detach().to(device).contiguous()
            for k, v in tp_shard(dict(full.named_parameters()), specs, m_idx, n_model).items()
        }
        del full
        sharded = [k for k in params if specs[k] is not None]
        replicated = [k for k in params if specs[k] is None]
        run_reduction = n_data > 1
        red = make_reducer(config, reducer, sharded)
        exact = ExactReducer()
        carry = Carry(
            params,
            {k: torch.zeros_like(v) for k, v in params.items()},
            # EF memories for the compressed (model-sharded) leaves, this data worker's
            {k: torch.zeros_like(params[k]) for k in sharded} if run_reduction else {},
            red.init([params[k] for k in sharded]) if run_reduction else {},
        )
        lr, mu = config.learning_rate, config.momentum
        update_rule = ef_momentum_update if reducer == "powersgd" else sgd_momentum_update

        def step(carry: Carry, x, y):
            leaves = {k: v.detach().requires_grad_(True) for k, v in carry.params.items()}
            logits = tp_gpt_forward(cfg, leaves, x, model_group, vocab_parallel)
            if vocab_parallel:
                loss = vocab_parallel_next_token_loss(logits, y, model_group)
            else:
                loss = next_token_loss(logits, y)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            names = list(carry.params)
            if not run_reduction:
                delta = [grads[k] for k in names]
            else:
                loss = all_reduce_mean(loss.detach().reshape(1), data_group)[0]
                send = [grads[k] + carry.memories[k] for k in sharded]
                carry.reducer_state, d_sh, new_mem, _ = red.reduce(carry.reducer_state, send, data_group)
                _, d_rep, _, _ = exact.reduce({}, [grads[k] for k in replicated], data_group)
                carry.memories = dict(zip(sharded, new_mem))
                by_name = {**dict(zip(sharded, d_sh)), **dict(zip(replicated, d_rep))}
                delta = [by_name[k] for k in names]
            with torch.no_grad():
                (update_rule if run_reduction else sgd_momentum_update)(
                    [carry.params[k] for k in names], [carry.momenta[k] for k in names], delta, lr, mu
                )
            return carry, loss.detach()

        def local(batch):
            b = batch[0].shape[0] // n_data
            return tuple(a[d_idx * b : (d_idx + 1) * b] for a in batch)

        def batches(epoch):
            return synthetic_lm_batches(
                cfg.vocab_size, config.global_batch_size, seq_len, steps_per_epoch, config.seed + epoch
            )

        carry, logger, audit = carry_loop(
            step, carry, batches, config.training_epochs, local, device,
            rank=config.process_id, log_every=config.log_every,
        )
        extra = {
            "model_shards": n_model,
            "data_shards": n_data,
            "reducer": reducer,
            "vocab_parallel": vocab_parallel,
            "vocab": cfg.vocab_size,
            "seq_len": seq_len,
            "hlo_collectives": audit["by_kind"] if audit else {},
            "collective_bytes": audit["bytes_by_kind"] if audit else {},
            "bits_per_step": logger.bits_per_step,
            "preset": preset,
            "compute_dtype": config.compute_dtype,
            "losses": [r.loss for r in logger.records],
            "device_time_ms": [r.device_time_ms for r in logger.records],
        }
        return summarize("gpt_tp", logger, extra, perplexity=True)
