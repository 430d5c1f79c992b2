"""GPT pipeline-parallel pretraining, the JAX package's
``experiments/gpt_pp.py``: the decoder's blocks split into stages over a
``pipe`` mesh axis and trained with the 1F1B schedule
(``models.gpt.make_gpt_pipeline_train_fn``), the whole model
differentiated: embeddings, blocks, final LayerNorm and the tied head.

``data_shards > 1`` composes data parallelism: a ``("data", "pipe")``
mesh, the batch sharded over ``data``, and each group of gradients
(embedding, this rank's stage, final) reduced over ``data`` by its own
reducer, exact (the mean) or PowerSGD with error feedback; PowerSGD
without a data axis is refused. Stages run without dropout, as the JAX
stages do (a config with dropout is refused there).

Presets: ``small`` is ``gpt_tiny`` at vocabulary 64 with one block a
stage; ``full`` GPT-2 small's widths (dim 768, 12 heads) at vocabulary
1024 with ``12 // stages`` blocks a stage (at least one), so 12 layers on
1, 2, 3, 4, 6 or 12 stages. The blocks attend with the flash-attention
kernel (K5, causal) on the card and its plain version on the CPU, as
``GPTLM`` does.

Bits on the wire: the activations each stage sends right and the
gradients it sends left (recorded on the sending rank: the summary is this
rank's), the pipe all-reduces of the loss and of the embedding and final
gradients, and the data axis' reductions.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..models.gpt import gpt_small, gpt_tiny, make_gpt_pipeline_train_fn, split_gpt_params
from ..parallel.comm import all_reduce_mean
from ..parallel.mesh import make_mesh, resolve_device
from ..parallel.reducers import ExactReducer, PowerSGDReducer
from ..parallel.trainer import ef_momentum_update, sgd_momentum_update
from ..utils.config import ExperimentConfig
from .common import Carry, carry_loop, compute_dtype, process_group, summarize
from .gpt_lm import preset_vocab, synthetic_lm_batches

REDUCERS = ("exact", "powersgd")
GROUPS = ("embed", "stage", "final")


def default_config() -> ExperimentConfig:
    return ExperimentConfig(training_epochs=1, global_batch_size=16, learning_rate=0.1)


def reducer_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A gradient as the JAX package's reducer sees it: a stacked Linear
    weight ``(L, out, in)`` as its ``(L, in, out)`` kernel, every other
    leaf as it is; with features last throughout (the reducer's
    ``features_last``), a stage leaf's matrix is the JAX one."""
    return t.transpose(-1, -2) if t.dim() == 3 and name.endswith(".weight") else t


def make_reducer(config: ExperimentConfig, reducer: str, n_leaves: int):
    """The data axis' reducer of one gradient group of ``n_leaves`` leaves,
    each given in :func:`reducer_layout`: PowerSGD at
    ``config.reducer_rank`` with features last throughout, or the exact
    mean."""
    if reducer != "powersgd":
        return ExactReducer()
    return PowerSGDReducer(
        random_seed=config.seed, compression_rank=config.reducer_rank, matricize="last",
        features_last=range(n_leaves),
    )


def run(
    config: Optional[ExperimentConfig] = None,
    preset: str = "small",
    seq_len: int = 32,
    steps_per_epoch: int = 15,
    num_microbatches: int = 4,
    max_steps_per_epoch: Optional[int] = None,
    data_shards: int = 1,
    reducer: str = "exact",
    checkpoint_dir: Optional[str] = None,
    device="cuda",
    pretrained_state_dict=None,
) -> Dict:
    """Train and return the run summary (the JAX entry's keys). The world
    over ``data_shards`` is the number of stages."""
    config = config or default_config()
    device = resolve_device(device)
    if reducer not in REDUCERS:
        raise ValueError(f"reducer must be one of {REDUCERS}, got {reducer!r}")
    if max_steps_per_epoch is not None:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    vocab = preset_vocab(preset)
    with process_group(config, device) as world:
        n_world = dist.get_world_size(world)
        if n_world % data_shards:
            raise ValueError(f"data_shards={data_shards} must divide the device count ({n_world})")
        n_data, n_stages = data_shards, n_world // data_shards
        if reducer == "powersgd" and n_data <= 1:
            raise ValueError(
                "reducer='powersgd' needs data_shards > 1: with a single data shard there is no cross-shard"
                " collective to compress"
            )
        if n_data > 1:
            mesh = make_mesh((n_data, n_stages), ("data", "pipe"))
            data_group, d_idx = mesh.group("data"), mesh.axis_index("data")
        else:
            mesh = make_mesh((n_stages,), ("pipe",))
            data_group, d_idx = None, 0
        pipe_group, s_idx = mesh.group("pipe"), mesh.axis_index("pipe")
        layers_per_stage = 1 if preset == "small" else max(1, 12 // n_stages)
        make = gpt_tiny if preset == "small" else gpt_small
        # dropout=0.0: the stages run deterministically (make_gpt_stage_fn)
        full = make(
            dtype=compute_dtype(config), device="cpu", seed=config.seed, vocab_size=vocab,
            max_position_embeddings=seq_len, n_layers=n_stages * layers_per_stage, dropout=0.0,
        )
        if pretrained_state_dict is not None:
            full.load_state_dict(pretrained_state_dict)
        cfg = full.config
        embed, stages, final = split_gpt_params({k: v.detach() for k, v in full.named_parameters()}, n_stages)
        del full
        groups = {"embed": embed, "stage": stages[s_idx], "final": final}
        params = {f"{g}/{k}": v.to(device).contiguous() for g in GROUPS for k, v in groups[g].items()}
        names: Dict[str, List[str]] = {g: [k for k in params if k.startswith(g + "/")] for g in GROUPS}
        reducers = {g: make_reducer(config, reducer, len(names[g])) for g in GROUPS}
        run_reduction = n_data > 1
        carry = Carry(
            params,
            {k: torch.zeros_like(v) for k, v in params.items()},
            {k: torch.zeros_like(v) for k, v in params.items()} if run_reduction else {},
            [reducers[g].init([reducer_layout(k, params[k]) for k in names[g]]) for g in GROUPS]
            if run_reduction
            else {},
        )
        train = make_gpt_pipeline_train_fn(cfg, layers_per_stage, num_microbatches, pipe_group)
        lr, mu = config.learning_rate, config.momentum
        update_rule = ef_momentum_update if reducer == "powersgd" else sgd_momentum_update

        def split(tree, g):
            return {k.split("/", 1)[1]: tree[k] for k in names[g]}

        def step(carry: Carry, x, y):
            p = carry.params
            loss, (ge, gs, gf) = train(split(p, "embed"), split(p, "stage"), split(p, "final"), x, y)
            grads = {**{f"embed/{k}": v for k, v in ge.items()}, **{f"stage/{k}": v for k, v in gs.items()},
                     **{f"final/{k}": v for k, v in gf.items()}}
            order = list(p)
            if not run_reduction:
                delta = [grads[k] for k in order]
            else:
                loss = all_reduce_mean(loss.detach().reshape(1), data_group)[0]
                out = {}
                for i, g in enumerate(GROUPS):
                    # Algorithm 2: send = g + e (the exact reducer's memories stay zero)
                    send = [reducer_layout(k, grads[k] + carry.memories[k]) for k in names[g]]
                    carry.reducer_state[i], d, m, _ = reducers[g].reduce(carry.reducer_state[i], send, data_group)
                    for k, dk, mk in zip(names[g], d, m):
                        out[k] = reducer_layout(k, dk)
                        carry.memories[k] = reducer_layout(k, mk)
                delta = [out[k] for k in order]
            with torch.no_grad():
                (update_rule if run_reduction else sgd_momentum_update)(
                    [p[k] for k in order], [carry.momenta[k] for k in order], delta, lr, mu
                )
            return carry, loss.detach()

        def local(batch):
            b = batch[0].shape[0] // n_data
            return tuple(a[d_idx * b : (d_idx + 1) * b] for a in batch)

        def batches(epoch):
            return synthetic_lm_batches(vocab, config.global_batch_size, seq_len, steps_per_epoch, config.seed + epoch)

        carry, logger, audit = carry_loop(
            step, carry, batches, config.training_epochs, local, device,
            rank=config.process_id, log_every=config.log_every, checkpoint_dir=checkpoint_dir, group=world,
        )
        extra = {
            "n_stages": n_stages,
            "data_shards": n_data,
            "reducer": reducer,
            "layers_per_stage": layers_per_stage,
            "num_microbatches": num_microbatches,
            "vocab": vocab,
            "seq_len": seq_len,
            "hlo_collectives": audit["by_kind"] if audit else {},
            "collective_bytes": audit["bytes_by_kind"] if audit else {},
            "bits_per_step": logger.bits_per_step,
            "preset": preset,
            "compute_dtype": config.compute_dtype,
            "losses": [r.loss for r in logger.records],
            "device_time_ms": [r.device_time_ms for r in logger.records],
        }
        return summarize("gpt_pp", logger, extra, perplexity=True)
