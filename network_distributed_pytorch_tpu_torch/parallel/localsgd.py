"""L4: communication avoidance, local SGD and DiLoCo (the JAX package's
``parallel/localsgd.py``).

Local SGD (Stich, 2018): each rank takes ``sync_every`` purely local SGD
steps, then the ranks average their PARAMETERS once: the wire cost per step
falls from one gradient-sized all-reduce to ``params / sync_every``. With
``sync_every=1`` and plain SGD it is exact DDP (averaging the stepped
parameters is stepping with the averaged gradient).

DiLoCo (Douillard et al., 2023): local SGD whose sync is an OUTER step. The
round's displacement ``theta_0 - theta_H`` is reduced across the ranks (by
any reducer: exact, or PowerSGD with error feedback on the outer delta) and
an outer SGD with (Nesterov) momentum moves the global parameters along it.
``outer_learning_rate=1, outer_momentum=0`` is local SGD's average.

Streaming DiLoCo (Douillard et al., 2025): DiLoCo whose outer sync is split
into ``num_fragments`` size-balanced fragments of the leaves, one synced a
phase, so the peak bytes of one sync fall K-fold.

The JAX package compiles a round as one ``lax.scan``; here a round is a
Python loop over its ``sync_every`` inner steps. Each rank holds its own
tensors: the JAX package's "per-worker" state (inner optimizer, error
memories, BatchNorm statistics, and between syncs local SGD's parameters)
is the rank's own, and its "replicated" state (DiLoCo's parameters, outer
momenta, reducer state; streaming DiLoCo's anchors) is bitwise equal on
every rank after each round, since every rank applies the same reduced
values in the same order. Parameters are the model's own ``Parameter``
tensors, updated in place.

A round takes ``weights``, one a slot: a slot of weight 0 (the padding of a
trailing partial round) runs no forward or backward pass and leaves the
state as it was, but still all-reduces its loss, a zero, so that every rank
issues the same collectives and the round's bits stay ``bits_per_round``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from .comm import all_reduce_mean, world_size
from .packing import TensorPacker
from .reducers import ExactReducer
from .trainer import LOSS_SYNC_BITS, LossFn, OptimizerFactory, sgd_momentum_update

INNER_ALGORITHMS = ("sgd", "sgd_plain", "optax")


class _InnerStep:
    """One local step of a rank, shared by local SGD, DiLoCo and streaming
    DiLoCo: forward and backward on the rank's batch, the local update
    (``"sgd"``: torch SGD with momentum, ``"sgd_plain"``, or ``"optax"``: a
    torch optimizer from ``optimizer``), and the loss all-reduced to its
    mean over the ranks (the JAX package's per-step ``pmean``)."""

    def __init__(self, loss_fn: LossFn, model: nn.Module, algorithm: str, learning_rate, momentum: float,
                 group, optimizer: Optional[OptimizerFactory] = None):
        if algorithm not in INNER_ALGORITHMS:
            raise ValueError(f"inner algorithm must be one of {INNER_ALGORITHMS}, got {algorithm!r}")
        if (algorithm == "optax") != (optimizer is not None):
            raise ValueError("an optimizer factory goes with algorithm='optax' and only with it")
        self.loss_fn = loss_fn
        self.model = model
        self.algorithm = algorithm
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.group = group
        self.optimizer = optimizer

    def init(self, params: Dict[str, torch.Tensor]):
        """The rank's inner optimizer state: momenta by name (``"sgd"``),
        nothing (``"sgd_plain"``), or the torch optimizer (``"optax"``)."""
        if self.algorithm == "optax":
            return self.optimizer(list(params.values()))
        if self.algorithm == "sgd":
            with torch.no_grad():
                return {k: torch.zeros_like(p) for k, p in params.items()}
        return {}

    def __call__(self, params: Dict[str, torch.Tensor], inner_opt, batch) -> torch.Tensor:
        plist = list(params.values())
        for p in plist:
            p.grad = None
        self.model.train()
        loss = self.loss_fn(self.model, batch)
        loss.backward()
        with torch.no_grad():
            grads = [p.grad for p in plist]
            if self.algorithm == "optax":
                inner_opt.step()
            elif self.algorithm == "sgd":
                sgd_momentum_update(plist, list(inner_opt.values()), grads, self.learning_rate, self.momentum)
            else:
                for p, g in zip(plist, grads):
                    p.sub_(self.learning_rate * g)
            for p in plist:
                p.grad = None
        return all_reduce_mean(loss.detach().clone(), self.group)

    def skipped(self, device) -> torch.Tensor:
        """A zero-weight slot: no step, and the loss all-reduce of a zero."""
        return all_reduce_mean(torch.zeros((), device=device), self.group)

    def run(self, params, inner_opt, batches, weights) -> torch.Tensor:
        """The round's inner steps, one per slot with a positive weight;
        the losses, ``(len(batches),)``, 0 in a skipped slot."""
        if weights is None:
            weights = [1.0] * len(batches)
        if len(weights) != len(batches):
            raise ValueError(f"{len(weights)} weights for {len(batches)} batches")
        device = next(iter(params.values())).device
        losses = [
            self(params, inner_opt, batch) if float(w) > 0 else self.skipped(device)
            for batch, w in zip(batches, weights)
        ]
        return torch.stack(losses)


def _loss_bits(sync_every: int, group) -> int:
    """The round's loss all-reduces (none without a group)."""
    return sync_every * LOSS_SYNC_BITS if group is not None else 0


@torch.no_grad()
def mean_model_state(model_state: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The ranks' floating-point buffers (BatchNorm statistics) averaged in
    one packed all-reduce, as copies; other buffers as they are. The JAX
    package's ``collapse_per_worker(reduce="mean")``, for evaluation: not
    part of a round's bits."""
    names = [k for k, b in model_state.items() if b.is_floating_point()]
    out = dict(model_state)
    if not names:
        return out
    bufs = [model_state[k] for k in names]
    packer = TensorPacker.for_tensors(bufs)
    for k, mean in zip(names, packer.unpack(all_reduce_mean(packer.pack(bufs), group))):
        out[k] = mean.clone()
    return out


def _check_reduce(reduce: str) -> None:
    if reduce != "mean":
        raise ValueError(f"reduce={reduce!r}: the port averages the ranks' statistics ('mean')")


def _check_sync_every(sync_every: int) -> None:
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")


# ---------------------------------------------------------------------------
# local SGD
# ---------------------------------------------------------------------------


@dataclass
class LocalSGDState:
    # what each rank holds its own of (utils.checkpoint writes them per rank)
    PER_RANK_FIELDS = ("params", "momenta", "model_state")

    params: Dict[str, torch.Tensor]  # the model's own; this rank's between syncs
    momenta: Dict[str, torch.Tensor]  # this rank's ({} for "sgd_plain")
    model_state: Dict[str, torch.Tensor]  # this rank's buffers


class LocalSGD:
    """One local-SGD sync round (the JAX package's ``CompiledLocalSGD``):
    ``state, losses = round(state, batches)`` with ``sync_every`` batches,
    each this rank's own. ``bits_per_round`` is one parameter all-reduce
    plus ``sync_every`` loss all-reduces."""

    def __init__(self, loss_fn, model, learning_rate, momentum, sync_every, algorithm, group):
        self.model = model
        self.sync_every = sync_every
        self.group = group
        self.inner = _InnerStep(loss_fn, model, algorithm, learning_rate, momentum, group)
        self.reducer = ExactReducer()  # the parameter average
        params = list(model.parameters())
        self.bits_per_round = self.reducer.bits_per_step(params) + _loss_bits(sync_every, group)

    @property
    def bits_per_step(self) -> float:
        return self.bits_per_round / self.sync_every

    def init_state(self) -> LocalSGDState:
        params = dict(self.model.named_parameters())
        return LocalSGDState(params, self.inner.init(params), dict(self.model.named_buffers()))

    def __call__(self, state: LocalSGDState, batches: Sequence[Any], weights=None):
        losses = self.inner.run(state.params, state.momenta, batches, weights)
        with torch.no_grad():
            plist = list(state.params.values())
            # the round's one parameter collective: average the diverged replicas
            _, mean, _, _ = self.reducer.reduce({}, plist, self.group)
            for p, m in zip(plist, mean):
                p.copy_(m)
        return state, losses

    def eval_params(self, state: LocalSGDState) -> Dict[str, torch.Tensor]:
        """Parameters just after a sync are the same on every rank."""
        return state.params

    def eval_model_state(self, state: LocalSGDState, reduce: str = "mean"):
        _check_reduce(reduce)
        return mean_model_state(state.model_state, self.group)


def make_local_sgd_train_fn(
    loss_fn: LossFn,
    model: nn.Module,
    learning_rate: float,
    momentum: float = 0.9,
    sync_every: int = 8,
    algorithm: str = "sgd",
    group=None,
) -> LocalSGD:
    """Local SGD over ``group``'s ranks; ``algorithm`` is ``"sgd"`` or
    ``"sgd_plain"`` (torch ``optim.SGD``'s rules), applied on each rank."""
    if algorithm not in ("sgd", "sgd_plain"):
        raise ValueError(f"local SGD runs 'sgd' or 'sgd_plain', got {algorithm!r}")
    _check_sync_every(sync_every)
    return LocalSGD(loss_fn, model, learning_rate, momentum, sync_every, algorithm, group)


# ---------------------------------------------------------------------------
# DiLoCo
# ---------------------------------------------------------------------------


def _outer_update(dbar, momenta, outer_momentum: float, outer_nesterov: bool):
    """Outer SGD with (Nesterov) momentum on the reduced outer gradient:
    ``m <- mu m + d``, then ``d + mu m`` (Nesterov) or ``m``; ``d`` where
    ``mu = 0``. Returns the update and the new momenta."""
    if outer_momentum <= 0.0:
        return list(dbar), list(momenta)
    new_m = [outer_momentum * m + d for m, d in zip(momenta, dbar)]
    if outer_nesterov:
        return [d + outer_momentum * m for d, m in zip(dbar, new_m)], new_m
    return new_m, new_m


@dataclass
class DiLoCoState:
    params: Dict[str, torch.Tensor]  # the model's own; the same on every rank after a round
    outer_momenta: Dict[str, torch.Tensor]  # the same on every rank
    inner_opt: Any  # this rank's: momenta by name, {} or a torch optimizer
    memories: Dict[str, torch.Tensor]  # this rank's error feedback on the outer delta
    reducer_state: Any  # the same on every rank
    model_state: Dict[str, torch.Tensor]  # this rank's buffers


class DiLoCo:
    """One DiLoCo round (the JAX package's ``CompiledDiLoCo``):
    ``state, losses = round(state, batches, weights=None)``.
    ``bits_per_round`` is one reducer pass over a parameter-shaped list plus
    ``sync_every`` loss all-reduces."""

    def __init__(self, loss_fn, model, inner_learning_rate, outer_learning_rate, outer_momentum,
                 outer_nesterov, inner_momentum, sync_every, inner_algorithm, reducer, group,
                 inner_optimizer):
        self.model = model
        self.outer_learning_rate = outer_learning_rate
        self.outer_momentum = outer_momentum
        self.outer_nesterov = outer_nesterov
        self.sync_every = sync_every
        self.reducer = reducer
        self.group = group
        self.inner = _InnerStep(
            loss_fn, model, inner_algorithm, inner_learning_rate, inner_momentum, group, inner_optimizer
        )
        params = list(model.parameters())
        self.bits_per_round = reducer.bits_per_step(params, world_size(group)) + _loss_bits(sync_every, group)

    @property
    def bits_per_step(self) -> float:
        return self.bits_per_round / self.sync_every

    def init_state(self) -> DiLoCoState:
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
            return DiLoCoState(
                params=params,
                outer_momenta=zeros(),
                inner_opt=self.inner.init(params),
                memories=zeros(),
                reducer_state=self.reducer.init(list(params.values())),
                model_state=dict(self.model.named_buffers()),
            )

    def __call__(self, state: DiLoCoState, batches: Sequence[Any], weights=None):
        names = list(state.params)
        plist = [state.params[k] for k in names]
        with torch.no_grad():
            params0 = [p.detach().clone() for p in plist]
        losses = self.inner.run(state.params, state.inner_opt, batches, weights)
        with torch.no_grad():
            # the outer gradient: this rank's displacement theta_0 - theta_H,
            # plus the residual its compressor dropped last round
            send = [(p0 - p) + state.memories[k] for k, p0, p in zip(names, params0, plist)]
            reducer_state, dbar, memories, _ = self.reducer.reduce(state.reducer_state, send, self.group)
            update, momenta = _outer_update(
                dbar, [state.outer_momenta[k] for k in names], self.outer_momentum, self.outer_nesterov
            )
            for p, p0, u in zip(plist, params0, update):
                p.copy_(p0 - self.outer_learning_rate * u)
        state.outer_momenta = dict(zip(names, momenta))
        state.memories = dict(zip(names, memories))
        state.reducer_state = reducer_state
        return state, losses

    def eval_params(self, state: DiLoCoState) -> Dict[str, torch.Tensor]:
        """The global parameters, the same on every rank."""
        return state.params

    def eval_model_state(self, state: DiLoCoState, reduce: str = "mean"):
        _check_reduce(reduce)
        return mean_model_state(state.model_state, self.group)


def _check_inner_learning_rate(inner_algorithm: str, inner_learning_rate) -> None:
    """The optimizer of ``"optax"`` carries its own rate; the SGD inners
    need one: a rate that would be ignored is refused."""
    if inner_algorithm == "optax":
        if inner_learning_rate is not None:
            raise ValueError(
                "inner_learning_rate is unused with inner_algorithm='optax': the inner optimizer"
                " carries its own learning rate"
            )
    elif inner_learning_rate is None:
        raise ValueError(f"inner_algorithm={inner_algorithm!r} needs inner_learning_rate")


def make_diloco_train_fn(
    loss_fn: LossFn,
    model: nn.Module,
    inner_learning_rate: Optional[float] = None,
    outer_learning_rate: float = 0.7,
    outer_momentum: float = 0.9,
    outer_nesterov: bool = True,
    inner_momentum: float = 0.9,
    sync_every: int = 8,
    inner_algorithm: str = "sgd",
    reducer=None,
    group=None,
    inner_optimizer: Optional[OptimizerFactory] = None,
) -> DiLoCo:
    """DiLoCo over ``group``'s ranks. ``reducer`` reduces the outer delta
    (default :class:`~.reducers.ExactReducer`; a compressing reducer keeps
    its residual in each rank's ``memories``). ``inner_algorithm`` is
    ``"sgd"``, ``"sgd_plain"`` or ``"optax"`` with ``inner_optimizer``, a
    factory from the parameters to a torch optimizer (the paper's AdamW
    inner), whose state each rank keeps across rounds."""
    _check_inner_learning_rate(inner_algorithm, inner_learning_rate)
    _check_sync_every(sync_every)
    return DiLoCo(
        loss_fn, model, inner_learning_rate, outer_learning_rate, outer_momentum, outer_nesterov,
        inner_momentum, sync_every, inner_algorithm, reducer if reducer is not None else ExactReducer(),
        group, inner_optimizer,
    )


# ---------------------------------------------------------------------------
# Streaming DiLoCo: one fragment synced a phase, K-fold lower peak bytes
# ---------------------------------------------------------------------------


def _fragment_indices(leaf_sizes: Sequence[int], num_fragments: int) -> List[List[int]]:
    """Greedy size-balanced leaf -> fragment assignment: the largest leaf
    first, into the lightest fragment; ties broken by leaf index, and by
    fragment index. Each fragment's indices ascend. The streaming claim is
    about the PEAK bytes of a sync, so the fragments are balanced by size
    rather than dealt round-robin."""
    bins: List[List[int]] = [[] for _ in range(num_fragments)]
    loads = [0] * num_fragments
    for i in sorted(range(len(leaf_sizes)), key=lambda i: (-leaf_sizes[i], i)):
        k = min(range(num_fragments), key=lambda j: (loads[j], j))
        bins[k].append(i)
        loads[k] += leaf_sizes[i]
    return [sorted(b) for b in bins]


@dataclass
class StreamingDiLoCoState:
    # what each rank holds its own of (utils.checkpoint writes them per rank)
    PER_RANK_FIELDS = ("params", "inner_opt", "memories", "model_state")

    params: Dict[str, torch.Tensor]  # the model's own; this rank's (only a synced fragment snaps back)
    anchors: Dict[str, torch.Tensor]  # each leaf at its last sync; the same on every rank
    outer_momenta: Dict[str, torch.Tensor]  # the same on every rank
    inner_opt: Dict[str, torch.Tensor]  # this rank's momenta ({} for "sgd_plain")
    memories: Dict[str, torch.Tensor]  # this rank's error feedback
    reducer_states: List[Any]  # one a fragment, the same on every rank
    model_state: Dict[str, torch.Tensor]  # this rank's buffers
    phase: int  # phases completed: a resumed run syncs the right fragment next


class StreamingDiLoCo:
    """Streaming DiLoCo's phases (the JAX package's
    ``CompiledStreamingDiLoCo``): phase ``r`` takes ``sync_every`` local
    steps, then syncs fragment ``r % K`` only, each fragment with its own
    outer momenta, error memories and reducer state. ``bits_per_phase[k]``
    is one reducer pass over fragment k plus the loss all-reduces."""

    def __init__(self, loss_fn, model, inner_learning_rate, num_fragments, outer_learning_rate,
                 outer_momentum, outer_nesterov, inner_momentum, sync_every, inner_algorithm, reducer, group):
        self.model = model
        self.num_fragments = num_fragments
        self.outer_learning_rate = outer_learning_rate
        self.outer_momentum = outer_momentum
        self.outer_nesterov = outer_nesterov
        self.sync_every = sync_every
        self.reducer = reducer
        self.group = group
        self.inner = _InnerStep(loss_fn, model, inner_algorithm, inner_learning_rate, inner_momentum, group)
        params = list(model.parameters())
        self.fragments = _fragment_indices([p.numel() for p in params], num_fragments)
        world = world_size(group)
        self.bits_per_phase = tuple(
            reducer.bits_per_step([params[i] for i in idx], world) + _loss_bits(sync_every, group)
            for idx in self.fragments
        )

    @property
    def peak_sync_bits(self) -> int:
        return max(self.bits_per_phase)

    @property
    def bits_per_step(self) -> float:
        return sum(self.bits_per_phase) / (self.num_fragments * self.sync_every)

    def init_state(self) -> StreamingDiLoCoState:
        params = dict(self.model.named_parameters())
        leaves = list(params.values())
        with torch.no_grad():
            zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
            return StreamingDiLoCoState(
                params=params,
                anchors={k: p.detach().clone() for k, p in params.items()},
                outer_momenta=zeros(),
                inner_opt=self.inner.init(params),
                memories=zeros(),
                reducer_states=[self.reducer.init([leaves[i] for i in idx]) for idx in self.fragments],
                model_state=dict(self.model.named_buffers()),
                phase=0,
            )

    def __call__(self, state: StreamingDiLoCoState, batches: Sequence[Any], round_index: Optional[int] = None,
                 weights=None):
        """One phase; ``round_index`` overrides the phase counter the state
        carries (the fragment synced is ``round_index % K``)."""
        phase = state.phase if round_index is None else round_index
        k = phase % self.num_fragments
        losses = self.inner.run(state.params, state.inner_opt, batches, weights)
        names = list(state.params)
        frag = [names[i] for i in self.fragments[k]]
        with torch.no_grad():
            send = [(state.anchors[n] - state.params[n]) + state.memories[n] for n in frag]
            state.reducer_states[k], dbar, memories, _ = self.reducer.reduce(state.reducer_states[k], send, self.group)
            update, momenta = _outer_update(
                dbar, [state.outer_momenta[n] for n in frag], self.outer_momentum, self.outer_nesterov
            )
            for n, u, m, mem in zip(frag, update, momenta, memories):
                merged = state.anchors[n] - self.outer_learning_rate * u
                state.anchors[n] = merged
                state.params[n].copy_(merged)  # every rank's fragment snaps to the merged value
                state.outer_momenta[n] = m
                state.memories[n] = mem
        state.phase = phase + 1
        return state, losses

    def eval_params(self, state: StreamingDiLoCoState) -> Dict[str, torch.Tensor]:
        """The ranks' parameters averaged (between a fragment's syncs they
        differ), as copies: one all-reduce, at evaluation."""
        names = list(state.params)
        _, mean, _, _ = ExactReducer().reduce({}, [state.params[n].detach() for n in names], self.group)
        return dict(zip(names, mean))

    def eval_model_state(self, state: StreamingDiLoCoState, reduce: str = "mean"):
        _check_reduce(reduce)
        return mean_model_state(state.model_state, self.group)


def make_streaming_diloco_train_fn(
    loss_fn: LossFn,
    model: nn.Module,
    inner_learning_rate: float,
    num_fragments: int = 2,
    outer_learning_rate: float = 0.7,
    outer_momentum: float = 0.9,
    outer_nesterov: bool = True,
    inner_momentum: float = 0.9,
    sync_every: int = 8,
    inner_algorithm: str = "sgd",
    reducer=None,
    group=None,
) -> StreamingDiLoCo:
    """Streaming DiLoCo over ``group``'s ranks, with ``num_fragments``
    fragments (:func:`_fragment_indices` over the model's
    ``parameters()``); ``num_fragments=1`` is DiLoCo."""
    if inner_algorithm not in ("sgd", "sgd_plain"):
        raise ValueError(f"streaming DiLoCo runs 'sgd' or 'sgd_plain', got {inner_algorithm!r}")
    if num_fragments < 1:
        raise ValueError(f"num_fragments must be >= 1, got {num_fragments}")
    if inner_learning_rate is None:
        raise ValueError("inner_learning_rate is required")
    _check_sync_every(sync_every)
    return StreamingDiLoCo(
        loss_fn, model, inner_learning_rate, num_fragments, outer_learning_rate, outer_momentum,
        outer_nesterov, inner_momentum, sync_every, inner_algorithm,
        reducer if reducer is not None else ExactReducer(), group,
    )


@torch.no_grad()
def drift_stats(state, group) -> Dict[str, float]:
    """Replica and anchor drift of a round's state (the JAX package's
    ``drift_stats``): ``replica_drift``, the RMS distance of the ranks'
    parameters from their mean over the mean's norm, and ``anchor_drift``,
    the distance of the mean from the anchors over the anchors' norm (0
    without anchors). DiLoCo's parameters are re-synced every round, so
    both are 0 there. The ranks' parameters meet in two all-reduces (not
    part of a round's bits)."""
    if isinstance(state, DiLoCoState):
        return {"replica_drift": 0.0, "anchor_drift": 0.0}
    names = list(state.params)
    leaves = [state.params[n].detach().float() for n in names]
    packer = TensorPacker.for_tensors(leaves)
    means = packer.unpack(all_reduce_mean(packer.pack(leaves), group))
    dev_sq = torch.stack([torch.sum(torch.square(p - mu)) for p, mu in zip(leaves, means)]).sum()
    dev_sq = all_reduce_mean(dev_sq.reshape(1), group)[0]
    mean_sq = torch.stack([torch.sum(torch.square(mu)) for mu in means]).sum()
    eps = 1e-30
    replica = torch.sqrt(dev_sq) / torch.clamp(torch.sqrt(mean_sq), min=eps)
    anchor = 0.0
    if isinstance(state, StreamingDiLoCoState):
        anchors = [state.anchors[n].float() for n in names]
        diff_sq = torch.stack([torch.sum(torch.square(mu - a)) for mu, a in zip(means, anchors)]).sum()
        a_sq = torch.stack([torch.sum(torch.square(a)) for a in anchors]).sum()
        anchor = float(torch.sqrt(diff_sq) / torch.clamp(torch.sqrt(a_sq), min=eps))
    return {"replica_drift": float(replica), "anchor_drift": anchor}
