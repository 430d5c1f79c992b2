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
``make_hierarchical_train_fn``, the JAX package's round loop over this
reducer, is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..observe.ledger import LedgerEntry, dtype_name, reducer_ledger_entries
from .comm import all_reduce_mean, n_bits
from .packing import TensorPacker


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


def _packed_exact_mean(leaves: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The exact all-reduce-mean of every leaf, one packed collective per
    dtype (in the order of the dtypes' names), each leaf keeping its dtype;
    bitwise the mean of each leaf alone (an all-reduce is elementwise)."""
    out: List[torch.Tensor] = list(leaves)
    by_dtype: Dict[str, List[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(str(leaf.dtype), []).append(i)
    for _, idx in sorted(by_dtype.items()):
        blk = [leaves[i] for i in idx]
        packer = TensorPacker.for_tensors(blk)
        for i, r in zip(idx, packer.unpack(all_reduce_mean(packer.pack(blk), group))):
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
        mean = _packed_exact_mean(send, self.inner_group)
        inner_bits = sum(n_bits(t) for t in mean)
        # the slow fabric: the outer reducer over the outer group
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
