"""GPT sequence-parallel (long-context) pretraining, the JAX package's
``experiments/gpt_sp.py``: the sequence is sharded over a ``seq`` mesh axis
of every rank, and attention runs an exact distributed schedule, ring
(k and v blocks rotating round the ranks) or Ulysses (head <-> sequence
all-to-all), from ``parallel/sequence.py``, so each rank holds
``seq_len / N`` tokens of every sequence while the math stays the
single-device model's.

Each rank's loss is the mean over its tokens; the objective is the mean of
the ranks' losses (shards are equal), so a rank back-propagates its loss
over ``N`` through the schedule's collectives, and one all-reduce sums the
parameters' gradients over the axis: the full-sequence gradient, which the
JAX package gets from ``shard_map``'s implicit psum on the replicated
parameters. Then SGD with momentum, as there. Bits on the wire are the
schedule's activation collectives, that all-reduce and the loss's.

Presets: ``small`` is ``gpt_tiny`` at vocabulary 64, ``full`` GPT-2 small
(dim 768, 12 layers, 12 heads) at vocabulary 1024; ``max_position_embeddings``
is ``seq_len``. Ulysses needs the head count divisible by the shards: where
the preset's is not, only the head count changes (to the shard count), as
in the JAX entry.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..models.gpt import SEQ_IMPLS, gpt_small, gpt_tiny, next_token_loss
from ..parallel.comm import all_reduce_mean, all_reduce_sum
from ..parallel.mesh import make_mesh, resolve_device
from ..parallel.trainer import sgd_momentum_update
from ..utils.config import ExperimentConfig
from .common import Carry, carry_loop, compute_dtype, process_group, summarize
from .gpt_lm import preset_vocab, synthetic_lm_batches


def default_config() -> ExperimentConfig:
    return ExperimentConfig(training_epochs=1, global_batch_size=8, learning_rate=0.1)


def build_model(preset: str, seq_len: int, n_shards: int, seq_impl: str, dtype, device, seed: int, group):
    """The preset's model with ``seq_axis=group``."""
    make = gpt_tiny if preset == "small" else gpt_small
    overrides = dict(vocab_size=preset_vocab(preset), max_position_embeddings=seq_len, dropout=0.0, dtype=dtype)
    if seq_impl == "ulysses":
        meta = make(device="meta", **overrides).config
        if meta.n_heads % n_shards:
            if meta.dim % n_shards:
                raise ValueError(
                    f"ulysses on {n_shards} shards needs n_heads (or dim) divisible by the shard count;"
                    f" the preset has n_heads={meta.n_heads}, dim={meta.dim}"
                )
            overrides["n_heads"] = n_shards
    return make(device=device, seed=seed, seq_axis=group, seq_impl=seq_impl, **overrides)


def run(
    config: Optional[ExperimentConfig] = None,
    preset: str = "small",
    seq_impl: str = "ring",
    seq_len: int = 256,
    steps_per_epoch: int = 15,
    max_steps_per_epoch: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    device="cuda",
    pretrained_state_dict=None,
) -> Dict:
    """Train and return the run summary (the JAX entry's keys). Joins the
    default process group (one of ``config.num_processes`` ranks if none
    exists); every rank is one shard of the ``seq`` axis."""
    config = config or default_config()
    device = resolve_device(device)
    if seq_impl not in SEQ_IMPLS:
        raise ValueError(f"seq_impl must be one of {SEQ_IMPLS}, got {seq_impl!r}")
    if max_steps_per_epoch is not None:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    vocab = preset_vocab(preset)
    with process_group(config, device) as world:
        n = dist.get_world_size(world)
        if seq_len % n:
            raise ValueError(f"seq_len={seq_len} does not split over {n} sequence shards")
        mesh = make_mesh((n,), ("seq",))
        group, idx = mesh.group("seq"), mesh.axis_index("seq")
        model = build_model(preset, seq_len, n, seq_impl, compute_dtype(config), device, config.seed, group)
        if pretrained_state_dict is not None:
            model.load_state_dict(pretrained_state_dict)
        params = dict(model.named_parameters())
        carry = Carry(params, {k: torch.zeros_like(v) for k, v in params.items()}, {}, {})
        lr, mu, t_loc = config.learning_rate, config.momentum, seq_len // n

        def step(carry: Carry, x, y):
            loss = next_token_loss(model(x), y)
            grads = torch.autograd.grad(loss / n, list(carry.params.values()))
            flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
            grads = [g.view_as(p) for g, p in zip(flat.split([p.numel() for p in carry.params.values()]), grads)]
            with torch.no_grad():
                sgd_momentum_update(list(carry.params.values()), list(carry.momenta.values()), grads, lr, mu)
            return carry, all_reduce_mean(loss.detach().reshape(1), group)[0]

        def local(batch):
            return tuple(a[:, idx * t_loc : (idx + 1) * t_loc] for a in batch)

        def batches(epoch):
            return synthetic_lm_batches(vocab, config.global_batch_size, seq_len, steps_per_epoch, config.seed + epoch)

        carry, logger, audit = carry_loop(
            step, carry, batches, config.training_epochs, local, device,
            rank=config.process_id, log_every=config.log_every, checkpoint_dir=checkpoint_dir, group=world,
        )
        extra = {
            "seq_impl": seq_impl,
            "n_seq_shards": n,
            "seq_len": seq_len,
            "tokens_per_device": t_loc,
            "vocab": vocab,
            "hlo_collectives": audit["by_kind"] if audit else {},
            "collective_bytes": audit["bytes_by_kind"] if audit else {},
            "bits_per_step": logger.bits_per_step,
            "preset": preset,
            "compute_dtype": config.compute_dtype,
            "n_heads": model.config.n_heads,
            "losses": [r.loss for r in logger.records],
            "device_time_ms": [r.device_time_ms for r in logger.records],
        }
        return summarize("gpt_sp", logger, extra, perplexity=True)
