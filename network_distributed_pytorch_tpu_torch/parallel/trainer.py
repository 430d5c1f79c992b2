"""L4: the training step.

The update rules of the JAX package's ``parallel/trainer.py``, by the same
names:

- ``"ef_momentum"``: error-feedback SGD with momentum, PowerSGD Algorithm 2:
  ``send <- g + e``, compress / all-reduce / decompress (``e`` updated),
  ``m <- mu m + delta; p <- p - lr (delta + m)``;
- ``"sgd"``: exact DDP, reduce the gradients, then torch-style SGD with
  momentum (``v <- mu v + g; p <- p - lr v``);
- ``"sgd_nesterov"``: torch SGD with Nesterov momentum
  (``v <- mu v + g; p <- p - lr (g + mu v)``), the reference's single-node
  IMDb baseline;
- ``"sgd_plain"``: SGD without momentum (``p <- p - lr g``);
- ``"optax"``: a ``torch.optim.Optimizer`` applied to the reduced gradient
  (the JAX package's name, where an optax transformation takes its place):
  ``optimizer=`` is a factory from the parameters to the optimizer, and the
  step writes the reduced, clipped gradient into ``.grad`` and calls
  ``step()``.

Gradients are synced by hand through the reducer, never by
``torch.nn.parallel.DistributedDataParallel``: the hand-rolled sync is what
makes the compression pluggable. BatchNorm running stats stay per rank and
unsynced, as torch DDP keeps them. Momenta and error memories start at zero
(the reference's first-step ``momentum = delta.clone()`` is the same thing).

Parameters and momenta are updated IN PLACE: the model's own ``Parameter``
tensors are the training state, so a step allocates no second copy of the
weights.

A step carries its wire ledger (``ledger``, the itemisation of
``bits_per_step``), the reducer's comm settings (``comm_config``) and the
health probe (``health_fn``, :func:`make_health_fn`), as the JAX package's
compiled step does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..observe.ledger import step_ledger
from .comm import all_reduce_mean, world_size
from .reducers import sq_norm

# The one collective outside the reducer: the scalar loss is all-reduced
# for reporting (f32 = 32 bits), counted in bits_per_step.
LOSS_SYNC_BITS = 32
# the mesh axis the data-parallel collectives ride, by the JAX package's name
DATA_AXIS = "data"

# (model, batch) -> scalar loss; the forward runs in train mode, so it also
# updates the model's BatchNorm running stats
LossFn = Callable[[nn.Module, Any], torch.Tensor]
# "optax": the parameters -> the optimizer that updates them
OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]

ALGORITHMS = ("ef_momentum", "sgd", "sgd_nesterov", "sgd_plain", "optax")
# the algorithms whose update keeps a momentum buffer per parameter
_WITH_MOMENTA = ("ef_momentum", "sgd", "sgd_nesterov")


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]  # the model's own Parameters, by name
    momenta: Dict[str, torch.Tensor]  # empty for "sgd_plain" and "optax"
    memories: Dict[str, torch.Tensor]  # error feedback, this rank's own
    reducer_state: Any
    model_state: Dict[str, torch.Tensor]  # the model's buffers (BN stats), this rank's own
    optimizer: Optional[torch.optim.Optimizer] = None  # "optax" only; holds its own state


def sgd_momentum_update(params, momenta, delta, lr: float, mu: float) -> None:
    """``v <- mu v + delta; p <- p - lr v``, in place."""
    for p, m, d in zip(params, momenta, delta):
        m.mul_(mu).add_(d)
        p.sub_(lr * m)


def sgd_nesterov_update(params, momenta, delta, lr: float, mu: float) -> None:
    """torch SGD with Nesterov momentum: ``v <- mu v + delta;
    p <- p - lr (delta + mu v)``, in place."""
    for p, m, d in zip(params, momenta, delta):
        m.mul_(mu).add_(d)
        p.sub_(lr * (d + mu * m))


def ef_momentum_update(params, momenta, delta, lr: float, mu: float) -> None:
    """PowerSGD Algorithm 2 lines 12-13: ``m <- mu m + delta;
    p <- p - lr (delta + m)``, in place."""
    for p, m, d in zip(params, momenta, delta):
        m.mul_(mu).add_(d)
        p.sub_(lr * (d + m))


def clip_by_global_norm(delta: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """``clip_grad_norm_`` semantics on the reduced update (identical on
    every rank, so no collective)."""
    norm = torch.sqrt(sum(torch.sum(torch.square(d.float())) for d in delta))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [(d * scale).to(d.dtype) for d in delta]


class TrainStep:
    """One training step, ``step(state, batch) -> (state, loss)``.

    ``group`` is the process group the reducer's collectives run over
    (``None``: one process, no collectives). With ``accum_steps > 1`` each
    batch tensor carries a leading ``accum_steps`` axis and the gradient is
    the mean over the microbatches; the reducer still runs once per step.
    ``optimizer`` is given with ``algorithm="optax"`` and only then."""

    def __init__(
        self,
        loss_fn: LossFn,
        reducer,
        model: nn.Module,
        learning_rate: float,
        momentum: float = 0.9,
        algorithm: str = "ef_momentum",
        group=None,
        accum_steps: int = 1,
        max_grad_norm: Optional[float] = None,
        optimizer: Optional[OptimizerFactory] = None,
    ):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS}, got {algorithm!r}")
        if (algorithm == "optax") != (optimizer is not None):
            raise ValueError("an optimizer factory goes with algorithm='optax' and only with it")
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.loss_fn = loss_fn
        self.reducer = reducer
        self.model = model
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.algorithm = algorithm
        self.group = group
        self.accum_steps = accum_steps
        self.max_grad_norm = max_grad_norm
        self.optimizer = optimizer
        params = [p for _, p in model.named_parameters()]
        # a gather-based compressor's payload grows with the world size
        self.bits_per_step = reducer.bits_per_step(params, world_size(group)) + (
            LOSS_SYNC_BITS if group is not None else 0
        )
        # the single-process step (no group) has no loss collective: the
        # ledger leaves it out by the same rule
        self.ledger = step_ledger(
            reducer, params, axis=DATA_AXIS if group is not None else "", n_workers=world_size(group),
            expected_bits=self.bits_per_step, include_loss_sync=group is not None,
        )
        self.comm_config = reducer_comm_config(reducer)
        self.health_fn = make_health_fn(loss_fn, reducer, model, group, accum_steps)

    def init_state(self) -> TrainState:
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            momenta = (
                {k: torch.zeros_like(p) for k, p in params.items()}
                if self.algorithm in _WITH_MOMENTA else {}
            )
            memories = {k: torch.zeros_like(p) for k, p in params.items()}
        return TrainState(
            params=params,
            momenta=momenta,
            memories=memories,
            reducer_state=self.reducer.init(list(params.values())),
            model_state=dict(self.model.named_buffers()),
            optimizer=self.optimizer(list(params.values())) if self.optimizer is not None else None,
        )

    def _grads(self, state: TrainState, batch) -> torch.Tensor:
        params = list(state.params.values())
        for p in params:
            p.grad = None
        self.model.train()
        if self.accum_steps == 1:
            loss = self.loss_fn(self.model, batch)
            loss.backward()
            return loss.detach()
        loss_sum = torch.zeros((), device=params[0].device)
        for k in range(self.accum_steps):
            loss = self.loss_fn(self.model, tuple(a[k] for a in batch))
            loss.backward()  # .grad accumulates the microbatch sum
            loss_sum += loss.detach()
        with torch.no_grad():
            for p in params:
                p.grad.div_(self.accum_steps)
        return loss_sum / self.accum_steps

    def __call__(self, state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        loss = self._grads(state, batch)
        names = list(state.params)
        params = [state.params[k] for k in names]
        grads = [p.grad for p in params]
        with torch.no_grad():
            if self.algorithm == "ef_momentum":
                mems = [state.memories[k] for k in names]
                reducer_state, delta, new_mems, _ = self.reducer.reduce_ef(
                    state.reducer_state, grads, mems, self.group
                )
            else:
                reducer_state, delta, new_mems, _ = self.reducer.reduce(
                    state.reducer_state, grads, self.group
                )
            if self.max_grad_norm is not None:
                delta = clip_by_global_norm(delta, self.max_grad_norm)
            if self.algorithm == "optax":
                for p, d in zip(params, delta):
                    p.grad = d
                state.optimizer.step()
            elif self.algorithm == "sgd_plain":
                for p, d in zip(params, delta):
                    p.sub_(self.learning_rate * d)
            else:
                momenta = [state.momenta[k] for k in names]
                update = {
                    "ef_momentum": ef_momentum_update,
                    "sgd": sgd_momentum_update,
                    "sgd_nesterov": sgd_nesterov_update,
                }[self.algorithm]
                update(params, momenta, delta, self.learning_rate, self.momentum)
            state.memories = dict(zip(names, new_mems))
            for p in params:
                p.grad = None
            state.reducer_state = reducer_state
            loss = all_reduce_mean(loss.clone(), self.group)
        return state, loss


def reducer_comm_config(reducer) -> Dict:
    """The comm settings a reducer was built with, read back from it:
    ``reducer`` (its class's name, lower case), ``reducer_rank``,
    ``comm_chunks``, ``comm_strategy`` and ``bucket_bytes`` where it has
    them, for ``CompileEvent.comm_config``."""
    cfg: Dict = {"reducer": type(reducer).__name__.lower()}
    for attr, key in (
        ("compression_rank", "reducer_rank"),
        ("comm_chunks", "comm_chunks"),
        ("comm_strategy", "comm_strategy"),
        ("bucket_bytes", "bucket_bytes"),
    ):
        v = getattr(reducer, attr, None)
        if v is not None:
            cfg[key] = v
    return cfg


def make_health_fn(
    loss_fn: LossFn, reducer, model: nn.Module, group=None, accum_steps: int = 1
) -> Callable[[TrainState, Any], Dict]:
    """The training-health probe behind ``TrainHealthEvent``, the JAX
    package's function of the same name: ``health(state, batch)`` returns
    ``{grad_norm, ef_memory_norm, powersgd_rel_error, loss}`` on the host
    and, where the reducer has diagnostics (``diagnose``), ``fidelity``: a
    group's ``{rel_error, cosine_sim, ef_norm, quantized_share}``, its keys
    the reducer's ``fidelity_group_tags``.

    It costs one more forward and backward on the batch (the step's own
    gradient is gone by then), one collective-free diagnostic round of the
    reducer (its ``diagnose``, the round of ``compression_error`` and
    ``fidelity_stats``: ``reduce(state, send, None)``, which on the card
    launches the pipeline's kernels at the step's shape groups) and ONE
    all-reduce of every scalar stacked into one tensor over ``group``,
    fetched to the host once. With ``accum_steps > 1`` it samples
    microbatch 0.

    The probe reads the state and never writes it: the gradient comes from
    ``torch.autograd.grad`` (no ``.grad`` is left set), the model's buffers
    (BatchNorm's running statistics, which a forward in train mode
    updates in place) are copied before and written back after, the
    random generators are forked (``torch.random.fork_rng``), and the
    reducer's round works on a copy of its generator and drops its new
    Q."""

    def health(state: TrainState, batch) -> Dict:
        if accum_steps > 1:
            batch = tuple(a[0] for a in batch)
        names = list(state.params)
        params = [state.params[k] for k in names]
        device = params[0].device
        buffers = list(model.buffers())
        was_training = model.training
        with torch.no_grad():
            saved = [b.clone() for b in buffers]
        try:
            with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
                model.train()
                with torch.enable_grad():
                    loss = loss_fn(model, batch)
                    grads = torch.autograd.grad(loss, params)
        finally:
            with torch.no_grad():
                for b, s in zip(buffers, saved):
                    b.copy_(s)
            model.train(was_training)
        with torch.no_grad():
            mems = [state.memories[k] for k in names]
            send = [g + e for g, e in zip(grads, mems)]
            if hasattr(reducer, "diagnose"):
                rel, fidelity = reducer.diagnose(state.reducer_state, send, mems)
            else:  # a reducer with no diagnostics (the gather compressors)
                rel, fidelity = torch.zeros((), dtype=torch.float32, device=device), None
            scalars = [sq_norm(grads), sq_norm(mems), rel, loss.detach()]
            keys = [(group_name, k) for group_name, vals in (fidelity or {}).items() for k in vals]
            scalars += [fidelity[g][k] for g, k in keys]
            stacked = torch.stack([s.to(device=device, dtype=torch.float32).reshape(()) for s in scalars])
            stacked = all_reduce_mean(stacked, group)
            stacked[:2] = torch.sqrt(stacked[:2])
            host = stacked.cpu().tolist()  # the probe's one fetch
        out: Dict = {
            "grad_norm": host[0], "ef_memory_norm": host[1], "powersgd_rel_error": host[2], "loss": host[3],
        }
        if fidelity is not None:
            out["fidelity"] = {}
            for (g, k), v in zip(keys, host[4:]):
                out["fidelity"].setdefault(g, {})[k] = v
        return out

    return health


def make_train_step(
    loss_fn: LossFn,
    reducer,
    model: nn.Module,
    learning_rate: float,
    momentum: float = 0.9,
    algorithm: str = "ef_momentum",
    group=None,
    accum_steps: int = 1,
    max_grad_norm: Optional[float] = None,
    optimizer: Optional[OptimizerFactory] = None,
) -> TrainStep:
    """Build the training step for ``model`` (see :class:`TrainStep`)."""
    return TrainStep(
        loss_fn, reducer, model, learning_rate, momentum, algorithm,
        group, accum_steps, max_grad_norm, optimizer,
    )
