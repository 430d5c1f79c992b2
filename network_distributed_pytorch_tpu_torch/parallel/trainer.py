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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from .comm import all_reduce_mean

# The one collective outside the reducer: the scalar loss is all-reduced
# for reporting (f32 = 32 bits), counted in bits_per_step.
LOSS_SYNC_BITS = 32

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
        self.bits_per_step = reducer.bits_per_step(params) + (
            LOSS_SYNC_BITS if group is not None else 0
        )

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
