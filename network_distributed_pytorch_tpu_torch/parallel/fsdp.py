"""L4: fully-sharded data parallelism (ZeRO-3) over the data-parallel ranks,
the JAX package's ``parallel/fsdp.py`` for the port.

Every parameter, its gradient and its optimizer state live sharded across
the ranks of the group, so each rank's model and optimizer memory drops by
about ``1 / world``, while the training math stays exact data-parallel SGD:

- each leaf, in the torch layout of the model's parameter, is flattened and
  zero-padded to ``world * chunk`` with ``chunk = ceil(size / world)``, and
  rank ``r`` keeps elements ``[r * chunk, (r + 1) * chunk)``
  (:func:`shard_params`). A conv kernel is OIHW here and HWIO in flax, so
  the two packages' shards hold other elements of the same leaf; the
  sizes, the padding and the bits on the wire depend only on the leaf's
  size and are the same;
- the forward gathers every leaf up front (``comm.all_gather_tiled``, or K
  chunk gathers with ``comm_chunks``) and runs the model on the full
  parameters through ``torch.func.functional_call``; the model's own
  parameters are released when the state is made, so a rank holds only
  its shards between steps;
- the backward of each gather is a reduce-scatter, so each rank receives
  its shard of the summed gradient; times ``1 / world``, the mean;
- the update runs on the shards, with the trainer's update rules;
- BatchNorm buffers stay each rank's own and are never synchronised in the
  step (the reference's ``:72-81``); :meth:`FSDPStep.eval_model_state`
  averages them for an evaluation.

Every collective goes through :mod:`.comm`, so ``record_collectives`` sees
every byte. Bits a step: one all-gather and one reduce-scatter of every
padded leaf, ``2 * sum(8 * world * chunk * itemsize)``, whatever
``comm_chunks``, plus the 32 bits of the loss's all-reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from ..observe.ledger import LedgerEntry, WireLedger, dtype_name, loss_sync_entry
from .comm import all_gather_tiled, all_reduce_mean, chunk_bounds, chunked_all_gather_tiled, world_size
from .localsgd import _check_reduce, mean_model_state
from .trainer import (
    DATA_AXIS,
    LossFn,
    OptimizerFactory,
    sgd_momentum_update,
    sgd_nesterov_update,
)

ALGORITHMS = ("sgd", "sgd_plain", "sgd_nesterov", "optax")


def chunk_size(n: int, world: int) -> int:
    """Elements of each rank's shard of a leaf of ``n``: ``ceil(n / world)``."""
    return -(-int(n) // int(world))


def _padded_flat(leaf: torch.Tensor, world: int) -> torch.Tensor:
    flat = leaf.detach().reshape(-1)
    pad = world * chunk_size(flat.numel(), world) - flat.numel()
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def shard_params(params: Dict[str, torch.Tensor], world: int) -> Dict[str, torch.Tensor]:
    """Each leaf flattened, zero-padded and cut into ``world`` flat shards:
    ``(...shape)`` -> ``(world, ceil(size / world))``; row ``r`` is rank
    ``r``'s shard."""
    return {k: _padded_flat(v, world).view(world, -1).clone() for k, v in params.items()}


def unshard_params(shards: Dict[str, torch.Tensor], params_template: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params`: each leaf's ``(world, chunk)``
    shards (or their flat concatenation) back to its template's shape and
    dtype."""
    return {k: shards[k].reshape(-1)[: t.numel()].reshape(t.shape).to(t.dtype) for k, t in params_template.items()}


@dataclasses.dataclass
class FSDPState:
    """The carry of an FSDP step, every field this rank's own: its flat
    shard of every parameter (``(chunk,)``, by the model's parameter
    names), its optimizer state (the momentum shards of ``sgd`` and
    ``sgd_nesterov``, ``{}`` for ``sgd_plain``, the ``torch.optim``
    optimizer over the shards for ``"optax"``) and its BatchNorm buffers
    (the model's own). A checkpoint writes all of it in the rank's own
    file."""

    PER_RANK_FIELDS = ("param_shards", "opt_shards", "model_state")
    param_shards: Dict[str, torch.Tensor]
    opt_shards: Any
    model_state: Dict[str, torch.Tensor]


class _LossOf(nn.Module):
    """``loss_fn(model, batch)`` as a module, so that ``functional_call``
    can run it on parameters and buffers given from outside the model."""

    def __init__(self, model: nn.Module, loss_fn: LossFn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch):
        return self.loss_fn(self.model, batch)


class FSDPStep:
    """One fully-sharded training step, ``step(state, batch) -> (state,
    loss)``, over ``group`` (a process group; a world of one included).

    ``loss_fn(model, batch)`` sees the model with its full parameters: the
    sharding is invisible to the model. ``algorithm`` is one of
    :data:`ALGORITHMS` with the trainer's update rules (torch
    ``optim.SGD``: momentum, none, Nesterov) applied to the shards, or
    ``"optax"`` with ``optimizer``, a factory of a ``torch.optim``
    optimizer over the shard tensors (elementwise optimizers apply
    shard-wise unchanged). ``comm_chunks=K`` gathers each leaf as up to K
    collectives (:func:`.comm.chunked_all_gather_tiled`), each piece's
    backward its own reduce-scatter: the result is the monolithic step's
    bit for bit where the reduction does not depend on the payload's size,
    and the bits on the wire do not depend on K."""

    accum_steps = 1  # the loop's batches carry no accumulation axis

    def __init__(
        self,
        loss_fn: LossFn,
        model: nn.Module,
        learning_rate: float,
        momentum: float = 0.9,
        algorithm: str = "sgd",
        group=None,
        optimizer: Optional[OptimizerFactory] = None,
        comm_chunks: Optional[int] = None,
    ):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS}, got {algorithm!r}")
        if (algorithm == "optax") != (optimizer is not None):
            raise ValueError("an optimizer factory goes with algorithm='optax' and only with it")
        if comm_chunks is not None and comm_chunks < 1:
            raise ValueError(f"comm_chunks must be >= 1, got {comm_chunks}")
        if group is None:
            raise ValueError("FSDP runs over a process group (a world of one included)")
        self.model = model
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.algorithm = algorithm
        self.group = group
        self.optimizer = optimizer
        self.comm_chunks = comm_chunks
        self.world = world_size(group)
        self._loss = _LossOf(model, loss_fn)
        # each leaf's shape and dtype: the model's parameters are released
        # once a state exists
        self.templates: Dict[str, torch.Tensor] = {
            k: torch.empty(p.shape, dtype=p.dtype, device="meta") for k, p in model.named_parameters()
        }
        chunks = {k: chunk_size(t.numel(), self.world) for k, t in self.templates.items()}
        gather_bytes = sum(self.world * chunks[k] * t.element_size() for k, t in self.templates.items())
        # a collective each way a leaf, or a leaf's chunk when the gather is
        # split (the payload does not depend on K)
        n_gathers = sum(len(chunk_bounds(c, comm_chunks or 1)) for c in chunks.values())
        dtypes = {dtype_name(t.dtype) for t in self.templates.values()}
        dtype = dtypes.pop() if len(dtypes) == 1 else "mixed"
        # the JAX package's FSDP ledger: the gathers, the reduce-scatters and
        # the loss's all-reduce
        self.ledger = WireLedger(
            [
                LedgerEntry("fsdp.param-gather", "fsdp", "all-gather", DATA_AXIS, dtype, gather_bytes, n_gathers),
                LedgerEntry("fsdp.grad-scatter", "fsdp", "reduce-scatter", DATA_AXIS, dtype, gather_bytes, n_gathers),
                loss_sync_entry(DATA_AXIS),
            ],
            dense_grad_bits=sum(8 * t.numel() * t.element_size() for t in self.templates.values()),
        )
        self.bits_by_kind = {e.op: 8 * e.payload_bytes for e in self.ledger.entries}
        self.collectives_by_kind = {e.op: e.count for e in self.ledger.entries}
        self.bits_per_step = self.ledger.total_bits()

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    def init_state(self, state: Optional[FSDPState] = None) -> FSDPState:
        """This rank's state: the shards of the model's current parameters
        (or of ``state``, e.g. one of ``models.import_weights.
        fsdp_state_from_jax``), zero momenta (or ``state``'s), the model's
        own BatchNorm buffers (``state``'s values written into them) and,
        for ``"optax"``, a fresh optimizer over the shards. The model's
        parameters are released after: from here on the step gathers them.
        """
        params = dict(self.model.named_parameters())
        device = next(iter(params.values())).device
        with torch.no_grad():
            if state is None:
                released = [k for k, p in params.items() if p.shape != self.templates[k].shape]
                if released:
                    raise ValueError(f"the model's parameters were released (first {released[0]!r}): pass a state")
                shards = {k: self._own_shard(p) for k, p in params.items()}
            else:
                shards = {k: state.param_shards[k].detach().to(device).clone() for k in self.templates}
            for k, s in shards.items():
                want = chunk_size(self.templates[k].numel(), self.world)
                if s.shape != (want,):
                    raise ValueError(f"{k}: shard {tuple(s.shape)}, want ({want},) at world {self.world}")
                s.requires_grad_(True)
            model_state = dict(self.model.named_buffers())
            if state is not None:
                for k, b in model_state.items():
                    b.copy_(state.model_state[k])
            if self.algorithm == "optax":
                if state is not None and state.opt_shards is not None:
                    raise ValueError("an 'optax' state starts from a fresh optimizer: pass opt_shards=None")
                opt = self.optimizer(list(shards.values()))
            elif self.algorithm == "sgd_plain":
                opt = {}
            elif state is not None and state.opt_shards is not None:
                opt = {k: state.opt_shards[k].detach().to(device).clone() for k in shards}
            else:
                opt = {k: torch.zeros_like(s) for k, s in shards.items()}
            for p in params.values():  # ZeRO-3: no rank holds a full parameter between steps
                p.data = p.data.new_empty(0)
        return FSDPState(shards, opt, model_state)

    def _own_shard(self, leaf: torch.Tensor) -> torch.Tensor:
        """This rank's flat shard of the full ``leaf``."""
        chunk = chunk_size(leaf.numel(), self.world)
        return _padded_flat(leaf, self.world)[self.rank * chunk : (self.rank + 1) * chunk].clone()

    def _gather(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        t = self.templates[name]
        return chunked_all_gather_tiled(shard, self.group, self.comm_chunks)[: t.numel()].view(t.shape)

    def __call__(self, state: FSDPState, batch) -> Tuple[FSDPState, torch.Tensor]:
        names = list(state.param_shards)
        shards = [state.param_shards[k] for k in names]
        full = {f"model.{k}": self._gather(k, s) for k, s in zip(names, shards)}
        buffers = {f"model.{k}": b for k, b in state.model_state.items()}
        self.model.train()
        # the buffers are this rank's own tensors: BatchNorm updates them in place
        loss = functional_call(self._loss, {**full, **buffers}, (batch,))
        grads = torch.autograd.grad(loss, shards)
        del full  # the gathered parameters go before the update, not after it
        with torch.no_grad():
            # the reduce-scatters summed the ranks' gradients: the mean
            delta = [g.mul_(1.0 / self.world) for g in grads]
            if self.algorithm == "optax":
                for p, d in zip(shards, delta):
                    p.grad = d
                state.opt_shards.step()
                for p in shards:
                    p.grad = None
            elif self.algorithm == "sgd_plain":
                for p, d in zip(shards, delta):
                    p.sub_(self.learning_rate * d)
            else:
                update = sgd_nesterov_update if self.algorithm == "sgd_nesterov" else sgd_momentum_update
                update(shards, [state.opt_shards[k] for k in names], delta, self.learning_rate, self.momentum)
            loss = all_reduce_mean(loss.detach().clone(), self.group)
        return state, loss

    @torch.no_grad()
    def unshard(self, state: FSDPState) -> Dict[str, torch.Tensor]:
        """The full parameters, by name: a collective (no rank holds the
        others' shards), for an evaluation or a full checkpoint; outside
        the step and its bits."""
        out = {}
        for k, s in state.param_shards.items():
            t = self.templates[k]
            out[k] = all_gather_tiled(s.detach(), 0, self.group)[: t.numel()].view(t.shape).clone()
        return out

    def eval_model_state(self, state: FSDPState, reduce: str = "mean") -> Dict[str, torch.Tensor]:
        """The BatchNorm buffers for an evaluation: the ranks' floating
        buffers averaged (a collective, outside the step's bits), as copies;
        ``num_batches_tracked`` as this rank holds it. Only ``"mean"`` is
        ported."""
        _check_reduce(reduce)
        return mean_model_state(state.model_state, self.group)


def make_fsdp_train_step(
    loss_fn: LossFn,
    model: nn.Module,
    learning_rate: float,
    momentum: float = 0.9,
    algorithm: str = "sgd",
    group=None,
    optimizer: Optional[OptimizerFactory] = None,
    comm_chunks: Optional[int] = None,
) -> FSDPStep:
    """Build the fully-sharded training step for ``model`` (see
    :class:`FSDPStep`)."""
    return FSDPStep(loss_fn, model, learning_rate, momentum, algorithm, group, optimizer, comm_chunks)
