"""GPT with routed mixture-of-experts MLPs, expert-parallel: the JAX
package's ``experiments/gpt_moe.py``. Each block's MLP is a Switch (top-1)
or GShard (top-k) MoE (``parallel.moe.switch_moe``) whose experts are
sharded over an ``expert`` mesh axis of every rank; the same ranks shard
the token batch, and each block's tokens travel to their experts and back
by two all-to-alls.

Attention, LayerNorms, embeddings and routers are replicated: their
gradients are this rank's own and are reduced over the axis by a pluggable
reducer, exact (the mean) or PowerSGD with error feedback (at any axis
size, one rank included: the reducer's collectives still run, and on the
card its Gram-Schmidt kernel, K1). Each rank's experts get complete
gradients locally: the all-to-all's backward delivers every rank's routed
tokens' gradients, summed over the ranks' local-mean losses, so they are
divided by the axis size to the global mean's (JAX entry
``gpt_moe.py:225-231``). The loss is next-token cross-entropy plus
``aux_coef`` times the Switch load-balancing loss.

Presets: ``small`` dim 32, 2 layers, 4 heads, vocabulary 64; ``full`` GPT-2
small's widths (dim 768, 12 layers, 12 heads) at vocabulary 1024; each
expert's hidden width ``2 * dim``. Capacity per (expert, source rank) is
``capacity_factor * top_k * local_tokens / n_experts`` (at least 1). The
blocks attend with the model's ``CausalSelfAttention``: the flash kernel
(K5, causal) on the card and its plain version on the CPU.

Weights come from the seed: the base from a dense ``GPTLM`` without its
MLP leaves, routers and experts LeCun-normal (an expert's fan-in is its
input width, the stacked expert axis being a batch axis), expert biases
zero. ``pretrained`` gives ``(base, routers, experts)`` dicts instead
(``models.import_weights.moe_params_from_jax``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.func import functional_call

from ..models.gpt import CausalSelfAttention, GPTConfig, GPTLM, gpt_position_ids, next_token_loss
from ..parallel.comm import all_reduce_mean
from ..parallel.mesh import make_mesh, resolve_device
from ..parallel.moe import switch_moe
from ..parallel.reducers import ExactReducer, PowerSGDReducer
from ..parallel.trainer import ef_momentum_update, sgd_momentum_update
from ..utils.config import ExperimentConfig
from .common import Carry, carry_loop, compute_dtype, process_group, summarize
from .gpt_lm import synthetic_lm_batches

AXIS = "expert"
REDUCERS = ("exact", "powersgd")
Params = Dict[str, torch.Tensor]
_LN_EPS = 1e-5


def default_config() -> ExperimentConfig:
    return ExperimentConfig(training_epochs=1, global_batch_size=16, learning_rate=0.1)


def moe_config(preset: str, seq_len: int, dtype) -> GPTConfig:
    if preset not in ("small", "full"):
        raise ValueError(f"unknown preset {preset!r}")
    small = preset == "small"
    dim = 32 if small else 768
    return GPTConfig(
        vocab_size=64 if small else 1024, max_position_embeddings=seq_len, dim=dim, n_layers=2 if small else 12,
        n_heads=4 if small else 12, hidden_dim=2 * dim, dropout=0.0, dtype=dtype,
    )


def expert_mlp(p: Params, t: torch.Tensor) -> torch.Tensor:
    """Every local expert's MLP at once: ``t`` ``(E_local, slots, D)``,
    stacked weights ``w_up`` ``(E_local, D, H)``, ``w_down`` ``(E_local, H,
    D)`` and biases; tanh-GELU between."""
    h = F.gelu(torch.baddbmm(p["b_up"][:, None, :], t, p["w_up"]), approximate="tanh")
    return torch.baddbmm(p["b_down"][:, None, :], h, p["w_down"])


def _layer(params: Params, prefix: str) -> Params:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def moe_gpt_forward(
    cfg: GPTConfig, params: Params, experts: Params, routers: Params, input_ids: torch.Tensor,
    capacity: int, group, top_k: int = 1, attn: Optional[CausalSelfAttention] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decoder with MoE MLPs: ``params`` a ``GPTLM`` dict without the
    MLP leaves (replicated), ``experts`` this rank's stacked expert MLPs
    (``h.{i}.w_up`` ...), ``routers`` a ``(dim, E)`` kernel a block
    (``h.{i}``). Returns ``(logits, mean aux loss, mean dropped
    fraction)`` over the blocks."""
    dt = cfg.dtype
    attn = attn if attn is not None else attention_template(cfg)

    def ln(name, x):
        return F.layer_norm(x.float(), (cfg.dim,), params[f"{name}.weight"], params[f"{name}.bias"], _LN_EPS).to(dt)

    x = F.embedding(input_ids, params["wte.weight"].to(dt))
    x = x + F.embedding(gpt_position_ids(cfg, input_ids), params["wpe.weight"].to(dt))
    aux = dropped = 0.0
    for i in range(cfg.n_layers):
        x = x + functional_call(attn, _layer(params, f"h.{i}.attn."), (ln(f"h.{i}.ln_1", x), True))
        h = ln(f"h.{i}.ln_2", x)
        moe = switch_moe(
            h.reshape(-1, cfg.dim), routers[f"h.{i}"], _layer(experts, f"h.{i}."), expert_mlp, group,
            capacity=capacity, top_k=top_k,
        )
        x = x + moe.out.reshape(x.shape)
        aux = aux + moe.aux_loss
        dropped = dropped + moe.dropped_fraction
    x = ln("ln_f", x)
    logits = F.linear(x, params["wte.weight"].to(dt)).float()
    return logits, aux / cfg.n_layers, dropped / cfg.n_layers


def attention_template(cfg: GPTConfig) -> CausalSelfAttention:
    """The model's attention with no storage, applied with each block's
    parameters."""
    with torch.device("meta"):
        return CausalSelfAttention(cfg)


def init_moe_params(cfg: GPTConfig, n_experts: int, seed: int) -> Tuple[Params, Params, Params]:
    """``(base, routers, experts)`` for all ``n_experts``, on the CPU from
    ``seed``."""
    full = GPTLM(cfg, device="cpu", seed=seed)
    base = {k: v.detach() for k, v in full.named_parameters() if ".mlp_" not in k}
    gen = torch.Generator().manual_seed(seed + 1)

    def lecun(shape, fan_in):
        return torch.randn(shape, generator=gen) / math.sqrt(fan_in)

    d, h = cfg.dim, cfg.hidden_dim
    routers, experts = {}, {}
    for i in range(cfg.n_layers):
        routers[f"h.{i}"] = lecun((d, n_experts), d)
        experts[f"h.{i}.w_up"] = lecun((n_experts, d, h), d)
        experts[f"h.{i}.b_up"] = torch.zeros((n_experts, h))
        experts[f"h.{i}.w_down"] = lecun((n_experts, h, d), h)
        experts[f"h.{i}.b_down"] = torch.zeros((n_experts, d))
    return base, routers, experts


def local_experts(experts: Params, index: int, n: int) -> Params:
    """Rank ``index`` of ``n``'s rows of the stacked experts."""
    return {k: v.chunk(n, dim=0)[index] for k, v in experts.items()}


def make_reducer(config: ExperimentConfig, reducer: str, base_names):
    """The reducer of the replicated parameters ``base_names`` (the carry's
    names, in the order it is given them): PowerSGD at
    ``config.reducer_rank`` with the JAX package's matrices, or the exact
    mean."""
    if reducer != "powersgd":
        return ExactReducer()
    return PowerSGDReducer(
        random_seed=config.seed, compression_rank=config.reducer_rank, matricize="last",
        # the embedding tables and the (dim, E) routers keep features last
        features_last=[
            i for i, k in enumerate(base_names) if k.startswith("router/") or k in ("base/wte.weight", "base/wpe.weight")
        ],
    )


def run(
    config: Optional[ExperimentConfig] = None,
    preset: str = "small",
    experts_per_device: int = 1,
    reducer: str = "exact",
    top_k: int = 1,
    aux_coef: float = 0.01,
    capacity_factor: float = 2.0,
    seq_len: int = 32,
    steps_per_epoch: int = 15,
    max_steps_per_epoch: Optional[int] = None,
    device="cuda",
    pretrained: Optional[Tuple[Params, Params, Params]] = None,
) -> Dict:
    """Train and return the run summary (the JAX entry's keys, with the
    final model's pure cross-entropy, aux loss and dropped fraction over a
    fresh batch). ``pretrained`` is ``(base, routers, experts)`` with THIS
    rank's experts."""
    config = config or default_config()
    device = resolve_device(device)
    if reducer not in REDUCERS:
        raise ValueError(f"reducer must be one of {REDUCERS}, got {reducer!r}")
    if max_steps_per_epoch is not None:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    cfg = moe_config(preset, seq_len, compute_dtype(config))
    with process_group(config, device) as world:
        n_dev = dist.get_world_size(world)
        if config.global_batch_size % n_dev:
            raise ValueError(f"global batch {config.global_batch_size} does not split over {n_dev} ranks")
        mesh = make_mesh((n_dev,), (AXIS,))
        group, idx = mesh.group(AXIS), mesh.axis_index(AXIS)
        n_experts = n_dev * experts_per_device
        if pretrained is None:
            base, routers, experts = init_moe_params(cfg, n_experts, config.seed)
            experts = local_experts(experts, idx, n_dev)
        else:
            base, routers, experts = pretrained
        local_tokens = config.global_batch_size // n_dev * seq_len
        # GShard sizing: top_k assignments a token share the buffers
        capacity = max(1, int(capacity_factor * top_k * local_tokens / n_experts))
        params = {
            **{f"base/{k}": v for k, v in base.items()},
            **{f"router/{k}": v for k, v in routers.items()},
            **{f"expert/{k}": v for k, v in experts.items()},
        }
        params = {k: v.to(device).contiguous() for k, v in params.items()}
        base_names = [k for k in params if not k.startswith("expert/")]
        expert_names = [k for k in params if k.startswith("expert/")]
        red = make_reducer(config, reducer, base_names)
        carry = Carry(
            params,
            {k: torch.zeros_like(v) for k, v in params.items()},
            {k: torch.zeros_like(params[k]) for k in base_names},
            red.init([params[k] for k in base_names]),
        )
        attn = attention_template(cfg)
        lr, mu = config.learning_rate, config.momentum
        update_rule = ef_momentum_update if reducer == "powersgd" else sgd_momentum_update

        def forward(p, x):
            return moe_gpt_forward(
                cfg, _layer(p, "base/"), _layer(p, "expert/"), _layer(p, "router/"), x, capacity, group, top_k, attn
            )

        def step(carry: Carry, x, y):
            leaves = {k: v.detach().requires_grad_(True) for k, v in carry.params.items()}
            logits, aux, _ = forward(leaves, x)
            loss = next_token_loss(logits, y) + aux_coef * aux
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            loss = all_reduce_mean(loss.detach().reshape(1), group)[0]
            # the all-to-all's backward summed every rank's local-mean gradient
            exp_g = [grads[k] / n_dev for k in expert_names]
            send = [grads[k] + carry.memories[k] for k in base_names]
            carry.reducer_state, delta, new_mem, _ = red.reduce(carry.reducer_state, send, group)
            carry.memories = dict(zip(base_names, new_mem))
            with torch.no_grad():
                p, v = carry.params, carry.momenta
                update_rule([p[k] for k in base_names], [v[k] for k in base_names], delta, lr, mu)
                sgd_momentum_update([p[k] for k in expert_names], [v[k] for k in expert_names], exp_g, lr, mu)
            return carry, loss

        def local(batch):
            b = batch[0].shape[0] // n_dev
            return tuple(a[idx * b : (idx + 1) * b] for a in batch)

        def batches(epoch):
            return synthetic_lm_batches(
                cfg.vocab_size, config.global_batch_size, seq_len, steps_per_epoch, config.seed + epoch
            )

        carry, logger, audit = carry_loop(
            step, carry, batches, config.training_epochs, local, device,
            rank=config.process_id, log_every=config.log_every,
        )
        # routing and pure-CE diagnostics on the final parameters, over a
        # real batch of the next epoch's stream
        dx, dy = (torch.from_numpy(a).to(device) for a in local(next(iter(batches(config.training_epochs)))))
        with torch.no_grad():
            logits, aux, dropped = forward(carry.params, dx)
            diag = torch.stack([next_token_loss(logits, dy), aux, dropped]).float()
            ce, aux_final, dropped_final = all_reduce_mean(diag, group).tolist()
        extra = {
            "n_experts": n_experts,
            "experts_per_device": experts_per_device,
            "top_k": top_k,
            "capacity": capacity,
            "final_ce": ce,
            "final_perplexity": math.exp(ce),
            "final_aux_loss": aux_final,
            "final_dropped_fraction": dropped_final,
            "reducer": reducer,
            "shape_groups": red.n_shape_groups([params[k] for k in base_names]) if reducer == "powersgd" else None,
            "dispatch_bytes_per_layer": local_tokens * n_experts * capacity * 4,
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
        return summarize("gpt_moe", logger, extra, perplexity=False)
