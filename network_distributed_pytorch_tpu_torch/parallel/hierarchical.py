"""L3: fabric-aware reduction, exact within the fast fabric and compressed
only across the slow one (the JAX package's ``parallel/hierarchical.py``,
its per-step ``HierarchicalReducer``).

The reference compresses across every pair of workers, including those
joined by fast in-node links, where compression only adds error. Here the
ranks form an ``outer x inner`` grid (:func:`make_hierarchical_groups`):
each step the send buffer is first averaged exactly over the rank's inner
group (one packed all-reduce, the fast fabric: NVLink in a node), then the
outer reducer (PowerSGD, a gather compressor, or exact) reduces that group
mean over the rank's outer group (the slow fabric between nodes). The error
memory holds the outer compression's residual, the same on every rank of an
inner group. With an exact outer reducer this is the flat mean (the mean of
equal groups' means).

:meth:`HierarchicalReducer.bits_by_fabric` splits the bits between the two
fabrics; the slow fabric's share is the one the bandwidth study projects.
Every collective is tagged with its level (``inner.*``, ``outer.*``,
``comm.tag_scope``), so the fence hooks (the chaos injector, the
watchdogs) can tell the fabrics apart.

:func:`make_hierarchical_train_fn` is the geo-resilient two-level round
of the JAX package: ``sync_every`` inner steps a round, each exact DDP
over the fast fabric only (``inner.step_grads``), then ONE compressed,
error-feedback outer reduction of the round's displacement from the
anchors (the global parameters at the last applied outer update) across
the slow fabric, and an outer (Nesterov) momentum step. With
``outer_async=True`` the outer update lands one round late (the
``inflight`` slot), as an outer collective that overlaps the next round's
inner steps would. ``local_round`` is the same round without any
outer-fabric collective, the partition-survival round: the next sync's
anchor-relative delta telescopes over every round skipped, and the EF
memories carry the compression residual across the gap (the rejoin).
``resilience.guards.PartitionPolicy`` and ``OuterSyncDriver`` drive it
from the host.

As everywhere in the port, each rank holds its own copy (no leading
device axis): the parameters, inner optimizer, EF memories and BatchNorm
buffers are this rank's; the anchors, outer momenta, reducer state and the
inflight update are bitwise the same on every rank after each round.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..observe.ledger import LedgerEntry, WireLedger, dtype_name, reducer_ledger_entries
from .comm import all_reduce_mean, chunked_all_reduce_mean, n_bits, tag_scope
from .localsgd import _InnerStep, _check_inner_learning_rate, _check_reduce, _outer_update, mean_model_state
from .packing import TensorPacker
from .reducers import ExactReducer
from .trainer import LOSS_SYNC_BITS, LossFn, OptimizerFactory, sgd_momentum_update


def make_hierarchical_groups(n_outer: int = 2, group=None) -> Tuple[object, object, int, int]:
    """This rank's inner and outer groups of an ``n_outer x (W / n_outer)``
    grid over ``group``'s ranks (the JAX study's ``("dcn", "ici")`` mesh):
    position ``p = o * inner_world + i`` is in inner group ``o`` (ranks
    ``o * inner_world + 0 .. inner_world - 1``) and outer group ``i`` (ranks
    ``i, inner_world + i, ...``). Every rank must call this, in the same
    order, as ``torch.distributed.new_group`` requires. Returns
    ``(inner_group, outer_group, inner_world, outer_world)``."""
    ranks = dist.get_process_group_ranks(group if group is not None else dist.group.WORLD)
    world = len(ranks)
    if n_outer < 1 or world % n_outer:
        raise ValueError(f"a world of {world} does not split into {n_outer} outer groups")
    inner_world = world // n_outer
    me = ranks.index(dist.get_rank())
    inner = outer = None
    for o in range(n_outer):
        g = dist.new_group([ranks[o * inner_world + i] for i in range(inner_world)])
        if me // inner_world == o:
            inner = g
    for i in range(inner_world):
        g = dist.new_group([ranks[o * inner_world + i] for o in range(n_outer)])
        if me % inner_world == i:
            outer = g
    return inner, outer, inner_world, n_outer


def _packed_exact_mean(leaves: List[torch.Tensor], group, tag: str) -> List[torch.Tensor]:
    """The exact all-reduce-mean of every leaf, one packed collective per
    dtype (in the order of the dtypes' names, tagged ``tag``, or
    ``tag.d{i}`` where the dtypes differ), each leaf keeping its dtype;
    bitwise the mean of each leaf alone (an all-reduce is elementwise).
    Through :func:`..comm.chunked_all_reduce_mean`, so the fence hooks and
    the tag scopes apply."""
    out: List[torch.Tensor] = list(leaves)
    by_dtype: Dict[str, List[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(str(leaf.dtype), []).append(i)
    multi = len(by_dtype) > 1
    for gi, (_, idx) in enumerate(sorted(by_dtype.items())):
        blk = [leaves[i] for i in idx]
        packer = TensorPacker.for_tensors(blk)
        reduced = chunked_all_reduce_mean(packer.pack(blk), group, 1, tag=f"{tag}.d{gi}" if multi else tag)
        for i, r in zip(idx, packer.unpack(reduced)):
            out[i] = r
    return out


class HierarchicalReducer:
    """Exact mean over ``inner_group``, then ``outer`` over ``outer_group``.

    With no groups (one process) it is ``outer`` alone. The step's own
    ``group`` (the trainer's, for its loss) is not used: the reducer's
    collectives run over its two groups. The wire ledger names the two
    fabrics by the JAX package's mesh axes (:attr:`inner_axis`,
    :attr:`outer_axis`)."""

    inner_axis = "ici"
    outer_axis = "dcn"

    def __init__(self, outer, inner_group, outer_group, inner_world: int, outer_world: int):
        if (inner_group is None) != (outer_group is None):
            raise ValueError("give both groups or neither")
        self.outer = outer
        self.inner_group = inner_group
        self.outer_group = outer_group
        self.inner_world = inner_world
        self.outer_world = outer_world

    def init(self, grads_template):
        return self.outer.init(grads_template)

    def reduce(self, state, send: Sequence[torch.Tensor], group):
        send = list(send)
        if self.inner_group is None:
            return self.outer.reduce(state, send, None)
        # the fast fabric: the exact mean over the inner group
        with tag_scope("inner"):
            mean = _packed_exact_mean(send, self.inner_group, tag="grads")
        inner_bits = sum(n_bits(t) for t in mean)
        # the slow fabric: the outer reducer over the outer group, its own
        # tags under "outer."
        with tag_scope("outer"):
            state, out, memory, outer_bits = self.outer.reduce(state, mean, self.outer_group)
        return state, out, memory, inner_bits + outer_bits

    def reduce_ef(self, state, grads, memories, group):
        return self.reduce(state, [g + e for g, e in zip(grads, memories)], group)

    def bits_by_fabric(self, grads_template) -> Dict[str, int]:
        """``{"inner": the exact fast-fabric bits, "outer": the outer
        reducer's slow-fabric bits over the outer world}``."""
        leaves = list(grads_template)
        return {
            "inner": sum(n_bits(t) for t in leaves),
            "outer": self.outer.bits_per_step(leaves, self.outer_world),
        }

    def bits_per_step(self, grads_template, n_workers: int = 1) -> int:
        bits = self.bits_by_fabric(grads_template)
        return bits["inner"] + bits["outer"]

    # ---- the health probe and the wire ledger ----------------------------

    @staticmethod
    def _inner_groups(leaves) -> List[Tuple[str, List[int]]]:
        """(group, leaf indices) of the exact inner payload, one a dtype as
        :meth:`ledger_entries` prices it (``inner.grads``, or
        ``inner.grads.d{i}`` where the dtypes differ)."""
        by_dtype: Dict[str, List[int]] = {}
        for i, leaf in enumerate(leaves):
            by_dtype.setdefault(dtype_name(leaf.dtype), []).append(i)
        multi = len(by_dtype) > 1
        return [
            (f"inner.grads.d{gi}" if multi else "inner.grads", idx)
            for gi, (_, idx) in enumerate(sorted(by_dtype.items()))
        ]

    def diagnose(self, state, send, memories=None):
        """``(rel_error, stats)`` of the outer reducer's collective-free
        diagnostic round, the only lossy stage: the inner exact groups read
        0 and 1 by construction, the outer groups are re-keyed under
        ``outer.``."""
        leaves = list(send)
        device = leaves[0].device if leaves else None
        zero = torch.zeros((), dtype=torch.float32, device=device)
        stats = {
            name: {
                "rel_error": zero, "cosine_sim": torch.ones((), dtype=torch.float32, device=device),
                "ef_norm": zero, "quantized_share": zero,
            }
            for name, _ in self._inner_groups(leaves)
        }
        rel_error, outer = zero, {}
        if hasattr(self.outer, "diagnose"):
            rel_error, outer = self.outer.diagnose(state, leaves, memories)
        stats.update({f"outer.{g}": v for g, v in outer.items()})
        return rel_error, stats

    def compression_error(self, state, send, group=None) -> torch.Tensor:
        return self.diagnose(state, send)[0]

    def fidelity_stats(self, state, send, memories=None, group=None) -> dict:
        return self.diagnose(state, send, memories)[1]

    def fidelity_group_tags(self, grads_template) -> Dict[str, str]:
        """``fidelity group -> wire-ledger tag``: the inner groups are their
        own tags, the outer reducer's are re-keyed under ``outer.``."""
        tags = {name: name for name, _ in self._inner_groups(list(grads_template))}
        if hasattr(self.outer, "fidelity_group_tags"):
            for g, t in self.outer.fidelity_group_tags(grads_template).items():
                tags[f"outer.{g}"] = f"outer.{t}"
        return tags

    def ledger_entries(self, grads_template, axis: str = "", n_workers: int = 1) -> list:
        """The packed exact inner payload on :attr:`inner_axis` and the outer
        reducer's own entries, re-tagged under ``outer.``, on
        :attr:`outer_axis`; sums to :meth:`bits_per_step`."""
        leaves = list(grads_template)
        entries = [
            LedgerEntry(
                tag=name, layer="reducer", op="all-reduce", axis=self.inner_axis,
                dtype=dtype_name(leaves[idx[0]].dtype),
                payload_bytes=sum(n_bits(leaves[i]) for i in idx) // 8,
            )
            for name, idx in self._inner_groups(leaves)
        ]
        for e in reducer_ledger_entries(self.outer, leaves, axis=self.outer_axis, n_workers=self.outer_world):
            entries.append(dataclasses.replace(e, tag=f"outer.{e.tag}", axis=self.outer_axis))
        return entries


# ---------------------------------------------------------------------------
# The geo-resilient round: inner DDP at the fast fabric's cadence, one
# compressed outer sync a round (async: landing a round late), and a round
# without any outer collective for a partition
# ---------------------------------------------------------------------------


@torch.no_grad()
def replica_drift_stats(params: Dict[str, torch.Tensor], anchors: Optional[Dict[str, torch.Tensor]] = None,
                        group=None) -> Dict[str, float]:
    """Replica and anchor drift for the fidelity plane (the JAX package's
    function of the same name), from this rank's parameters:

    - ``replica_drift``: the RMS distance of the ranks' copies from their
      mean over ``group``, over the mean's norm (0 where the copies are
      the same);
    - ``anchor_drift``: the distance of the mean from ``anchors`` over the
      anchors' norm (0 without anchors).

    The ranks' parameters meet in two all-reduces over ``group`` (not part
    of a round's bits); without a group the copy is its own mean."""
    names = list(params)
    leaves = [params[n].detach().float() for n in names]
    eps = 1e-30
    if not leaves:
        return {"replica_drift": 0.0, "anchor_drift": 0.0}
    packer = TensorPacker.for_tensors(leaves)
    means = packer.unpack(all_reduce_mean(packer.pack(leaves), group))
    dev_sq = torch.stack([torch.sum(torch.square(p - mu)) for p, mu in zip(leaves, means)]).sum()
    dev_sq = all_reduce_mean(dev_sq.reshape(1), group)[0]
    mean_sq = torch.stack([torch.sum(torch.square(mu)) for mu in means]).sum()
    replica = torch.sqrt(dev_sq) / torch.clamp(torch.sqrt(mean_sq), min=eps)
    anchor = 0.0
    if anchors is not None:
        a_leaves = [anchors[n].float() for n in names]
        diff_sq = torch.stack([torch.sum(torch.square(mu - a)) for mu, a in zip(means, a_leaves)]).sum()
        a_sq = torch.stack([torch.sum(torch.square(a)) for a in a_leaves]).sum()
        anchor = float(torch.sqrt(diff_sq) / torch.clamp(torch.sqrt(a_sq), min=eps))
    return {"replica_drift": float(replica), "anchor_drift": anchor}


@dataclass
class HierarchicalState:
    """The round carry of :func:`make_hierarchical_train_fn`. ``params``
    (the model's own), ``inner_opt``, ``memories`` and ``model_state`` are
    this rank's: the sites drift apart between syncs, and the inner
    optimizer is local by design. ``anchors`` (the global parameters at the
    last APPLIED outer update, from which every outer delta is measured),
    ``outer_momenta``, ``reducer_state`` and ``inflight`` (the async slot:
    last round's outer update, landing this round) are the same on every
    rank."""

    # what each rank holds its own of (utils.checkpoint writes them per rank)
    PER_RANK_FIELDS = ("params", "inner_opt", "memories", "model_state")

    params: Dict[str, torch.Tensor]
    anchors: Dict[str, torch.Tensor]
    outer_momenta: Dict[str, torch.Tensor]
    inner_opt: Any
    memories: Dict[str, torch.Tensor]
    reducer_state: Any
    inflight: Dict[str, torch.Tensor]
    model_state: Dict[str, torch.Tensor]


class _HierarchicalInnerStep(_InnerStep):
    """One inner step of a site: forward and backward on the rank's batch,
    the gradient averaged EXACTLY over the inner group (one packed
    collective, ``inner.step_grads``), the local update, and the loss
    averaged over the inner group. A zero-weight slot runs no forward or
    backward pass and leaves the state as it was, but still all-reduces a
    zero gradient and a zero loss, so every rank issues the same
    collectives (the JAX package's masked slot computes and discards)."""

    def _update(self, params, inner_opt, grads) -> None:
        with tag_scope("inner"):
            grads = _packed_exact_mean(grads, self.group, tag="step_grads")
        if self.algorithm == "optax":
            for p, g in zip(params, grads):
                p.grad = g
            inner_opt.step()
        elif self.algorithm == "sgd":
            sgd_momentum_update(params, list(inner_opt.values()), grads, self.learning_rate, self.momentum)
        else:
            for p, g in zip(params, grads):
                p.sub_(self.learning_rate * g)

    def __call__(self, params: Dict[str, torch.Tensor], inner_opt, batch) -> torch.Tensor:
        plist = list(params.values())
        for p in plist:
            p.grad = None
        self.model.train()
        loss = self.loss_fn(self.model, batch)
        loss.backward()
        with torch.no_grad():
            grads = [p.grad for p in plist]
            for p in plist:
                p.grad = None
            self._update(plist, inner_opt, grads)
            for p in plist:
                p.grad = None
        return all_reduce_mean(loss.detach().clone(), self.group)

    def skipped(self, device) -> torch.Tensor:
        plist = list(self.model.parameters())
        with torch.no_grad(), tag_scope("inner"):
            _packed_exact_mean([torch.zeros_like(p) for p in plist], self.group, tag="step_grads")
        return all_reduce_mean(torch.zeros((), device=device), self.group)


class CompiledHierarchical:
    """The two round programs over the ``outer x inner`` grid (the JAX
    package's ``CompiledHierarchical``).

    ``round(state, batches, weights=None, local=False) -> (state,
    site_losses)``: ``sync_every`` inner steps, then (unless ``local``) ONE
    hierarchical outer reduction of the anchor-relative delta plus the EF
    memory (``inner.grads`` and ``outer.*``) and the outer update, applied
    now (``outer_async=False``) or one round late through ``inflight``.
    ``site_losses``, ``(sync_every,)``, is this rank's site trajectory (the
    inner-group mean of each step's loss, 0 in a zero-weight slot).

    ``bits_per_round`` is the sync round's wire cost and
    ``local_bits_per_round`` the local round's (its inner collectives
    only); ``ledger`` itemises the sync round by level."""

    def __init__(self, model, inner, reducer: HierarchicalReducer, outer_learning_rate, outer_momentum,
                 outer_nesterov, sync_every: int, outer_async: bool, group, inner_optimizer):
        self.model = model
        self.inner = inner
        self.reducer = reducer
        self.outer_learning_rate = outer_learning_rate
        self.outer_momentum = outer_momentum
        self.outer_nesterov = outer_nesterov
        self.sync_every = sync_every
        self.outer_async = outer_async
        self.group = group
        self.inner_optimizer = inner_optimizer
        self.inner_axis, self.outer_axis = reducer.inner_axis, reducer.outer_axis
        leaves = list(model.parameters())
        dense_bits = sum(n_bits(t) for t in leaves)
        dtypes = {dtype_name(t.dtype) for t in leaves}
        by_fabric = reducer.bits_by_fabric(leaves)
        self.local_bits_per_round = sync_every * (dense_bits + LOSS_SYNC_BITS)
        self.inner_bits_per_round = self.local_bits_per_round + by_fabric["inner"]
        self.outer_bits_per_round = by_fabric["outer"]
        self.bits_per_round = self.inner_bits_per_round + self.outer_bits_per_round
        entries = [
            LedgerEntry(
                tag="inner.step_grads", layer="reducer", op="all-reduce", axis=self.inner_axis,
                dtype=dtypes.copy().pop() if len(dtypes) == 1 else "mixed",
                payload_bytes=sync_every * dense_bits // 8, count=sync_every,
            ),
            LedgerEntry(
                tag="inner.loss-sync", layer="trainer", op="all-reduce", axis=self.inner_axis, dtype="float32",
                payload_bytes=sync_every * LOSS_SYNC_BITS // 8, count=sync_every,
            ),
        ]
        entries.extend(reducer.ledger_entries(leaves))
        self.ledger = WireLedger(entries, dense_grad_bits=dense_bits)
        if self.ledger.total_bits() != self.bits_per_round:
            raise AssertionError(
                f"the hierarchical ledger itemises {self.ledger.total_bits()} bits but the round costs"
                f" {self.bits_per_round}"
            )

    @property
    def bits_per_step(self) -> float:
        return self.bits_per_round / self.sync_every

    @property
    def outer_bits_per_step(self) -> float:
        """Slow-fabric bits a round, per inner step: the number the
        cross-site shrink is about."""
        return self.outer_bits_per_round / self.sync_every

    def init_state(self) -> HierarchicalState:
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
            return HierarchicalState(
                params=params,
                anchors={k: p.detach().clone() for k, p in params.items()},
                outer_momenta=zeros(),
                inner_opt=self.inner.init(params),
                memories=zeros(),
                reducer_state=self.reducer.init(list(params.values())),
                inflight=zeros(),
                model_state=dict(self.model.named_buffers()),
            )

    def __call__(self, state: HierarchicalState, batches: Sequence[Any], weights=None, *, local: bool = False):
        losses = self.inner.run(state.params, state.inner_opt, batches, weights)
        if local:
            # partition survival: touch nothing that is the same on every
            # rank; the next sync's anchor-relative delta absorbs this round
            return state, losses
        names = list(state.params)
        plist = [state.params[k] for k in names]
        with torch.no_grad():
            # the outer gradient: the displacement from the last APPLIED
            # anchor (it telescopes over local rounds) plus the residual the
            # compressor dropped at the last sync (the EF catch-up)
            send = [(state.anchors[k] - p) + state.memories[k] for k, p in zip(names, plist)]
            reducer_state, dbar, memories, _ = self.reducer.reduce(state.reducer_state, send, None)
            update, momenta = _outer_update(
                dbar, [state.outer_momenta[k] for k in names], self.outer_momentum, self.outer_nesterov
            )
            inflight = [state.inflight[k] for k in names]
            applied = inflight if self.outer_async else update
            new_inflight = update if self.outer_async else inflight
            for k, p, u in zip(names, plist, applied):
                anchor = state.anchors[k] - self.outer_learning_rate * u
                state.anchors[k] = anchor
                p.copy_(anchor)
        state.outer_momenta = dict(zip(names, momenta))
        state.inflight = dict(zip(names, new_inflight))
        state.memories = dict(zip(names, memories))
        state.reducer_state = reducer_state
        return state, losses

    def local_round(self, state: HierarchicalState, batches: Sequence[Any], weights=None):
        return self(state, batches, weights, local=True)

    def eval_params(self, state: HierarchicalState) -> Dict[str, torch.Tensor]:
        """The mean of the ranks' copies over ``group`` (at a sync point
        every copy is the anchor; mid-partition the local-SGD convention),
        in one packed all-reduce, as new tensors."""
        names = list(state.params)
        leaves = [state.params[k].detach().clone() for k in names]
        packer = TensorPacker.for_tensors(leaves)
        return dict(zip(names, packer.unpack(all_reduce_mean(packer.pack(leaves), self.group))))

    def eval_model_state(self, state: HierarchicalState, reduce: str = "mean"):
        _check_reduce(reduce)
        return mean_model_state(state.model_state, self.group)


def make_hierarchical_train_fn(
    loss_fn: LossFn,
    model: nn.Module,
    inner_learning_rate: Optional[float] = None,
    outer_learning_rate: float = 0.7,
    outer_momentum: float = 0.9,
    outer_nesterov: bool = True,
    inner_momentum: float = 0.9,
    sync_every: int = 8,
    inner_algorithm: str = "sgd",
    outer_reducer=None,
    groups: Optional[Tuple[object, object, int, int]] = None,
    group=None,
    outer_async: bool = True,
    inner_optimizer: Optional[OptimizerFactory] = None,
) -> CompiledHierarchical:
    """The geo-resilient two-level round (see :class:`CompiledHierarchical`)
    over ``groups``, the ``(inner_group, outer_group, inner_world,
    outer_world)`` of :func:`make_hierarchical_groups` (a 1 x 1 grid
    included); ``group`` (default: the world) is the one the evaluation
    helpers average over. ``outer_reducer`` (default exact) reduces the
    site means of the outer delta across the slow fabric, its residual in
    each rank's ``memories``; ``inner_algorithm`` is ``"sgd"``,
    ``"sgd_plain"`` or ``"optax"`` with ``inner_optimizer``.

    As the JAX package pins: ``outer_async=False`` with an exact outer
    reducer, ``outer_learning_rate=1`` and ``outer_momentum=0`` is site
    averaging; the copies are bitwise equal at every sync point. The
    defaults are DiLoCo's synchronous recipe: an async run wants about
    ``outer_learning_rate=0.5``, ``outer_momentum <= 0.5`` and no Nesterov
    (every outer update lands one round stale)."""
    if groups is None:
        raise ValueError("hierarchical training needs its groups (make_hierarchical_groups), a 1 x 1 grid included")
    if inner_algorithm not in ("sgd", "sgd_plain", "optax"):
        raise ValueError(f"inner_algorithm must be 'sgd', 'sgd_plain' or 'optax', got {inner_algorithm!r}")
    if (inner_algorithm == "optax") != (inner_optimizer is not None):
        raise ValueError("an inner optimizer factory goes with inner_algorithm='optax' and only with it")
    _check_inner_learning_rate(inner_algorithm, inner_learning_rate)
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    inner_group, outer_group, inner_world, outer_world = groups
    if outer_reducer is None:
        outer_reducer = ExactReducer()
    hier = HierarchicalReducer(outer_reducer, inner_group, outer_group, inner_world, outer_world)
    inner = _HierarchicalInnerStep(
        loss_fn, model, inner_algorithm, inner_learning_rate, inner_momentum, inner_group, inner_optimizer
    )
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    return CompiledHierarchical(
        model, inner, hier, outer_learning_rate, outer_momentum, outer_nesterov, sync_every, outer_async, group,
        inner_optimizer,
    )
