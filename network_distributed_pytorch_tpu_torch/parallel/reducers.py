"""L3: gradient reduction, exact all-reduce and PowerSGD compression.

The JAX package's reducers with the same protocol, on lists of tensors in
the model's parameter order::

    state = reducer.init(params)
    state, out, new_memory, bits = reducer.reduce_ef(state, grads, memories, group)

``group=None`` is the single-process fallback (no collectives).

PowerSGD (``PowerSGDReducer``): split rank-1 from high-rank tensors,
``r = min(n, m, rank)``, batch same-shaped matrices into ``(g, n, m)`` shape
groups, then per round ``P = M Q`` -> all-reduce(P) -> Gram-Schmidt ->
``Q = M^T P`` -> all-reduce(Q), and decompress ``P Q^T`` with the residual
kept as error-feedback memory. All Ps ride one collective, all Qs another,
and the rank-1 tensors a third (each may be split into chunks,
``comm_chunks``). ``compress_impl`` picks the JAX package's
pipeline of the same name: ``"xla"`` runs each step as plain PyTorch ops,
``"pallas"`` the fused kernels of :mod:`..ops.powersgd`, one per shape group
per step.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..observe.ledger import LedgerEntry, dtype_name
from ..ops.gram_schmidt import gram_schmidt
from ..ops.orthogonalize import orthogonalize
from ..ops.powersgd import fused_decompress_residual, fused_ef_compress, fused_orthogonalize_project
from ..utils.config import COMM_STRATEGIES, COMPRESS_IMPLS, ORTHOGONALIZE_IMPLS
from .comm import (
    all_reduce_mean,
    bucket_assignments,
    chunk_bounds,
    chunked_all_reduce_mean,
    n_bits,
)
from .packing import TensorPacker


def _n_chunk_collectives(total_size: int, comm_chunks: Optional[int]) -> int:
    """Collectives a flat payload of ``total_size`` elements costs under
    :func:`..comm.chunked_all_reduce_mean` (1 when chunking is off or the
    payload is empty)."""
    if comm_chunks is None or total_size <= 0:
        return 1
    return len(chunk_bounds(total_size, comm_chunks))


def sq_norm(tensors) -> torch.Tensor:
    """The sum of the squares of every element, in fp32."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    return sum(torch.sum(torch.square(t.float())) for t in tensors)


class ExactReducer:
    """Exact all-reduce-mean of every gradient (the reference's
    ``average_gradients``).

    By default every leaf is flat-packed into ONE collective; the bytes are
    those of one collective per tensor. ``packed=False`` restores the
    reference's one collective per tensor (161 for ResNet-50).

    ``comm_chunks=K`` splits a packed payload into K collectives, and
    ``comm_strategy="ring"`` runs each as the explicit ring of
    :func:`..comm.ring_all_reduce_mean`. ``bucket_bytes=B`` is torch DDP's
    bucket structure: leaves go into buckets of about B bytes in REVERSE
    parameter order (the order the backward pass produces gradients,
    :func:`..comm.bucket_assignments`), each bucket packs and reduces only
    its own leaves, and ``comm_chunks`` applies per bucket. The buckets and
    chunks partition the payload, so bits on the wire do not depend on the
    layout; an all-reduce is elementwise, so the result does not either
    wherever the collective's summation order does not depend on the
    payload's size (two ranks, one rank, or dyadic values)."""

    def __init__(
        self,
        packed: bool = True,
        comm_chunks: Optional[int] = None,
        comm_strategy: str = "interleave",
        bucket_bytes: Optional[int] = None,
    ):
        if comm_strategy not in COMM_STRATEGIES:
            raise ValueError(f"comm_strategy must be one of {COMM_STRATEGIES}, got {comm_strategy!r}")
        if comm_chunks is not None and comm_chunks < 1:
            raise ValueError(f"comm_chunks must be >= 1, got {comm_chunks}")
        if bucket_bytes is not None and bucket_bytes < 1:
            raise ValueError(f"bucket_bytes must be >= 1, got {bucket_bytes}")
        # chunks and buckets re-partition the packed payload; one collective
        # per tensor has none to split
        if not packed and (comm_chunks is not None or bucket_bytes is not None):
            raise ValueError("comm_chunks and bucket_bytes need packed=True")
        self.packed = packed
        self.comm_chunks = comm_chunks
        self.comm_strategy = comm_strategy
        self.bucket_bytes = bucket_bytes

    def _buckets(self, leaves) -> List[List[int]]:
        """Leaf-index buckets in backward order; one bucket of every leaf
        when bucketing is off."""
        if self.bucket_bytes is None:
            return [list(range(len(leaves)))]
        return bucket_assignments([n_bits(t) // 8 for t in leaves], self.bucket_bytes)

    def init(self, grads_template: Sequence[torch.Tensor]) -> dict:
        return {}

    def n_collectives(self, grads_template: Sequence[torch.Tensor]) -> int:
        leaves = list(grads_template)
        if not self.packed:
            return len(leaves)
        return sum(
            _n_chunk_collectives(sum(leaves[i].numel() for i in idxs), self.comm_chunks)
            for idxs in self._buckets(leaves)
        )

    def reduce(self, state: dict, send: List[torch.Tensor], group):
        send = list(send)
        if not send:
            return state, [], [], 0
        out: List[Optional[torch.Tensor]] = [None] * len(send)
        if self.packed:
            bits = 0
            for idxs in self._buckets(send):
                blk = [send[i] for i in idxs]
                packer = TensorPacker.for_tensors(blk)
                reduced = chunked_all_reduce_mean(
                    packer.pack(blk), group, self.comm_chunks, self.comm_strategy
                )
                bits += packer.bits()
                for i, o in zip(idxs, packer.unpack(reduced)):
                    out[i] = o.to(send[i].dtype)
        else:
            # the reference's structure: one collective per tensor, each on
            # a copy (the collectives work in place)
            out = [all_reduce_mean(s.clone(), group) for s in send]
            bits = sum(n_bits(s) for s in send)
        new_memory = [torch.zeros_like(s) for s in send]
        return state, out, new_memory, bits

    def reduce_ef(self, state: dict, grads, memories, group):
        send = [g + e for g, e in zip(grads, memories)]
        return self.reduce(state, send, group)

    def bits_per_step(self, grads_template, n_workers: int = 1) -> int:
        return sum(n_bits(t) for t in grads_template)

    # ---- the health probe and the wire ledger ----------------------------

    def _fidelity_groups(self, leaves) -> List[Tuple[str, List[int]]]:
        """(group, leaf indices): a group a backward-order bucket
        (``grads.b{i}``), or ``grads``; each group key is its ledger tag."""
        if not leaves:
            return []
        if self.packed and self.bucket_bytes is not None:
            return [(f"grads.b{bi}", idxs) for bi, idxs in enumerate(self._buckets(leaves))]
        return [("grads", list(range(len(leaves))))]

    def fidelity_group_tags(self, grads_template) -> dict:
        """``fidelity group -> wire-ledger tag``: the group key is the tag
        (``grads``, ``grads.b{i}``), priced by :meth:`ledger_entries`."""
        return {name: name for name, _ in self._fidelity_groups(list(grads_template))}

    def diagnose(self, state: dict, send, memories=None):
        """``(rel_error, stats)`` of the health probe, as scalar tensors: an
        exact reduction loses nothing, so the error is 0, and a
        :meth:`fidelity_group_tags` group reads ``rel_error`` 0 and
        ``cosine_sim`` 1 by construction, its EF norm measured from
        ``memories`` (the trainer keeps it 0, so a breach shows) and
        ``quantized_share`` 0. No collective."""
        leaves = list(send)
        device = leaves[0].device if leaves else None
        mems = list(memories) if memories is not None else None
        zero = torch.zeros((), dtype=torch.float32, device=device)
        stats = {
            name: {
                "rel_error": zero,
                "cosine_sim": torch.ones((), dtype=torch.float32, device=device),
                "ef_norm": torch.sqrt(sq_norm([mems[i] for i in idxs])) if mems is not None else zero,
                "quantized_share": zero,
            }
            for name, idxs in self._fidelity_groups(leaves)
        }
        return zero, stats

    def compression_error(self, state: dict, send, group=None) -> torch.Tensor:
        """The probe's relative compression error: 0 (:meth:`diagnose`; the
        signature is PowerSGD's, so the probe treats both alike)."""
        return self.diagnose(state, send)[0]

    def fidelity_stats(self, state: dict, send, memories=None, group=None) -> dict:
        """The per-group diagnostics of :meth:`diagnose`."""
        return self.diagnose(state, send, memories)[1]

    def ledger_entries(self, grads_template, axis: str = "", n_workers: int = 1) -> list:
        """The wire ledger of one exact reduction: one all-reduce of the
        packed gradient (``count`` its chunks), one entry a bucket
        (``grads.b{i}``), or one batch of per-tensor all-reduces. The
        payload does not depend on the layout; the entries sum to
        :meth:`bits_per_step`."""
        leaves = list(grads_template)
        if not leaves:
            return []

        def entry(tag, idxs, count):
            dtypes = {dtype_name(leaves[i].dtype) for i in idxs}
            return LedgerEntry(
                tag=tag, layer="reducer", op="all-reduce", axis=axis,
                dtype=dtypes.pop() if len(dtypes) == 1 else "mixed",
                payload_bytes=sum(n_bits(leaves[i]) for i in idxs) // 8, count=count,
            )

        if not self.packed:
            return [entry("grads", list(range(len(leaves))), len(leaves))]
        return [
            entry(name, idxs, _n_chunk_collectives(sum(leaves[i].numel() for i in idxs), self.comm_chunks))
            for name, idxs in self._fidelity_groups(leaves)
        ]


def embedding_leaves(model: nn.Module) -> Tuple[int, ...]:
    """Positions, in ``model.parameters()`` order, of the ``nn.Embedding``
    weights: tables stored ``(num, dim)``, the layout of flax's ``Embed``,
    unlike a ``Linear`` weight's ``(out, in)``. ``PowerSGDReducer``'s
    ``features_last`` takes them."""
    tables = {id(mod.weight) for mod in model.modules() if isinstance(mod, nn.Embedding)}
    return tuple(i for i, p in enumerate(model.parameters()) if id(p) in tables)


def layer_stacked_leaves(model: nn.Module) -> Tuple[int, ...]:
    """Positions, in ``model.parameters()`` order, of the leaves stored
    with a leading layer axis: the parameters of every submodule that sets
    ``stacks_layers`` (a ``scan_layers`` GPT's ``h_scan``, the layout of
    the JAX package's ``nn.scan``). ``PowerSGDReducer``'s
    ``layer_stacked`` takes them."""
    stacked = {
        id(p) for mod in model.modules() if getattr(mod, "stacks_layers", False) for p in mod.parameters()
    }
    return tuple(i for i, p in enumerate(model.parameters()) if id(p) in stacked)


class _MatrixMeta(NamedTuple):
    leaf_index: int
    shape: Tuple[int, ...]
    n: int  # matrix rows
    m: int  # matrix columns
    r: int  # min(n, m, compression_rank)
    # the permutation that puts the torch-layout leaf into the matrix's
    # row-major order, or None when the plain reshape already does
    perm: Optional[Tuple[int, ...]]


class PowerSGDState(NamedTuple):
    """The warm-start Q buffer (packed, in the wire dtype) and the generator
    that redraws Q when ``reuse_query=False``."""

    q_memory: torch.Tensor
    generator: torch.Generator


class PowerSGDReducer:
    """Rank-r PowerSGD with error feedback (PowerSGD Algorithm 1).

    ``matricize`` picks the matrix a tensor of torch layout is viewed as:

    - ``"first"``: ``reshape(shape[0], -1)``, the reference's rule;
    - ``"last"``: output features last, the matrix the JAX package builds
      from its HWIO / (in, out) kernels: an OIHW conv weight becomes
      ``w.permute(2, 3, 1, 0).reshape(-1, O)``, a Linear weight ``w.t()``.
      The decompressed update is mapped back through the inverse
      permutation. The two modes give transposed (different) problems.
      The leaves at the positions in ``features_last`` (embedding tables,
      see :func:`embedding_leaves`) already keep the output features last,
      as flax's ``Embed`` does, and are taken as stored:
      ``(prod(shape[:-1]), shape[-1])``, so a ``(30522, 768)`` word table
      is the JAX package's ``(30522, 768)`` matrix, not its transpose.
      The leaves at the positions in ``layer_stacked`` (see
      :func:`layer_stacked_leaves`) hold a torch-layout leaf behind a
      leading layer axis ``L``, as flax's scanned leaves hold theirs: the
      matrix is the stacked flax leaf's, ``(L * prod(flax_shape[:-1]),
      flax_shape[-1])``, so a stacked Linear weight ``(L, out, in)`` is
      ``(L * in, out)``, one matrix, and a stacked bias ``(L, out)`` is
      taken as stored, as in the JAX package's ``gpt_lm`` under
      ``scan_layers``.

    ``orthogonalize_impl``: ``"auto"`` runs the CUDA Gram-Schmidt kernel on
    CUDA tensors and its plain version on CPU tensors; ``"cuda"`` requires
    CUDA tensors; ``"eager"`` always runs the plain version.
    ``compress_impl="pallas"`` swaps the per-group pipeline for the fused
    kernels (K2a/K2b ``P = (G + E) Q``, K3 Gram-Schmidt + ``Q = M^T P-hat``,
    K4 decompress + residual), which absorb the Gram-Schmidt, so
    ``orthogonalize_impl`` is not used there, as in the JAX package; the
    payloads and bits on the wire are the same as ``"xla"``'s.
    ``compression_dtype`` (e.g. ``torch.bfloat16``) is the wire dtype of
    the P, Q and rank-1 payloads; P and Q are cast back to the gradients'
    dtype for the math. ``comm_chunks`` and ``comm_strategy`` are the exact
    reducer's: each of the P, Q and rank-1 payloads rides
    :func:`..comm.chunked_all_reduce_mean`; the bits do not change.
    """

    def __init__(
        self,
        random_seed: int = 714,
        n_power_iterations: int = 0,
        reuse_query: bool = True,
        compression_rank: int = 1,
        matricize: str = "first",
        orthogonalize_impl: str = "auto",
        compression_dtype=None,
        compress_impl: str = "xla",
        features_last: Sequence[int] = (),
        comm_chunks: Optional[int] = None,
        comm_strategy: str = "interleave",
        layer_stacked: Sequence[int] = (),
    ):
        if comm_strategy not in COMM_STRATEGIES:
            raise ValueError(f"comm_strategy must be one of {COMM_STRATEGIES}, got {comm_strategy!r}")
        if comm_chunks is not None and comm_chunks < 1:
            raise ValueError(f"comm_chunks must be >= 1, got {comm_chunks}")
        if compress_impl not in COMPRESS_IMPLS:
            raise ValueError(f"unknown compress_impl {compress_impl!r}")
        if orthogonalize_impl not in ORTHOGONALIZE_IMPLS:
            raise ValueError(f"unknown orthogonalize_impl {orthogonalize_impl!r}")
        if matricize not in ("first", "last"):
            raise ValueError(f"unknown matricize {matricize!r}")
        if n_power_iterations < 0 or compression_rank < 1:
            raise ValueError("need n_power_iterations >= 0 and compression_rank >= 1")
        if isinstance(compression_dtype, str):
            compression_dtype = getattr(torch, compression_dtype)
        self.random_seed = random_seed
        self.n_power_iterations = n_power_iterations
        self.reuse_query = reuse_query
        self.compression_rank = compression_rank
        self.matricize = matricize
        self.orthogonalize_impl = orthogonalize_impl
        self.compression_dtype = compression_dtype
        self.compress_impl = compress_impl
        self.features_last = frozenset(features_last)
        self.layer_stacked = frozenset(layer_stacked)
        self.comm_chunks = comm_chunks
        self.comm_strategy = comm_strategy

    # ---- static layout ---------------------------------------------------

    @staticmethod
    def _split(leaves) -> Tuple[List[int], List[int]]:
        """Rank-1 (sent uncompressed) and high-rank (compressed) indices."""
        rank1 = [i for i, t in enumerate(leaves) if t.dim() <= 1]
        high = [i for i, t in enumerate(leaves) if t.dim() > 1]
        return rank1, high

    def _metas(self, leaves) -> List[_MatrixMeta]:
        _, high = self._split(leaves)
        metas = []
        for i in high:
            shape = tuple(leaves[i].shape)
            if self.matricize == "first":
                n, m, perm = shape[0], math.prod(shape[1:]), None
            elif i in self.features_last:
                n, m, perm = math.prod(shape[:-1]), shape[-1], None
            elif i in self.layer_stacked:
                if len(shape) == 2:  # stacked biases and LayerNorm parameters: (L, features)
                    n, m, perm = shape[0], shape[1], None
                else:  # (L, out, in, ...) -> (L, ..., in, out)
                    n, m = shape[0] * math.prod(shape[2:]), shape[1]
                    perm = (0,) + tuple(range(3, len(shape))) + (2, 1)
            else:
                n, m = math.prod(shape[1:]), shape[0]
                perm = tuple(range(2, len(shape))) + (1, 0)
            metas.append(_MatrixMeta(i, shape, n, m, min(n, m, self.compression_rank), perm))
        return metas

    @staticmethod
    def _shape_groups(metas: List[_MatrixMeta]) -> List[List[int]]:
        """Positions (into meta order) bucketed by (n, m, r): one batched
        matmul and one Gram-Schmidt launch per distinct shape."""
        groups: dict = {}
        for pos, meta in enumerate(metas):
            groups.setdefault((meta.n, meta.m, meta.r), []).append(pos)
        return list(groups.values())

    def n_shape_groups(self, grads_template) -> int:
        return len(self._shape_groups(self._metas(grads_template)))

    def _packers(self, leaves, metas):
        rank1, _ = self._split(leaves)
        dtype = leaves[0].dtype if len(leaves) else torch.float32
        if self.compression_dtype is not None:
            dtype = self.compression_dtype
        p_packer = TensorPacker([(meta.n, meta.r) for meta in metas], dtype=dtype)
        q_packer = TensorPacker([(meta.m, meta.r) for meta in metas], dtype=dtype)
        rank1_packer = TensorPacker([tuple(leaves[i].shape) for i in rank1], dtype=dtype)
        return p_packer, q_packer, rank1_packer

    def _stack_matrices(self, leaves, metas, poss) -> torch.Tensor:
        """The ``(g, n, m)`` stack of one shape group's matrices (one copy)."""
        meta = metas[poss[0]]
        views = [leaves[metas[p].leaf_index] for p in poss]
        views = [v if metas[p].perm is None else v.permute(metas[p].perm) for v, p in zip(views, poss)]
        if any(v.shape != views[0].shape for v in views):  # e.g. a table beside stacked (L, in, out) leaves
            views = [v.reshape(meta.n, meta.m) for v in views]
        return torch.stack(views).reshape(len(poss), meta.n, meta.m)

    @staticmethod
    def _from_matrix(mat: torch.Tensor, meta: _MatrixMeta) -> torch.Tensor:
        """Inverse of the matricization: a view of ``mat`` in the leaf's shape."""
        shape, perm = meta.shape, meta.perm
        if perm is None:
            return mat.reshape(shape)
        inv = [0] * len(perm)
        for k, p in enumerate(perm):
            inv[p] = k
        return mat.reshape([shape[p] for p in perm]).permute(inv)

    def _reduce_flat(self, flat: torch.Tensor, group) -> torch.Tensor:
        """One packed payload, all-reduce-meaned in place as configured."""
        return chunked_all_reduce_mean(flat, group, self.comm_chunks, self.comm_strategy)

    def _orthogonalize(self, p: torch.Tensor) -> torch.Tensor:
        if self.orthogonalize_impl == "eager":
            return orthogonalize(p)
        if self.orthogonalize_impl == "cuda" and p.device.type != "cuda":
            raise ValueError("orthogonalize_impl='cuda' needs CUDA tensors")
        return gram_schmidt(p)

    # ---- state -----------------------------------------------------------

    def init(self, grads_template) -> PowerSGDState:
        """Seed the warm-start Q buffer. Every rank draws the same Q from the
        same seed, with no communication. Q is drawn on the CPU and moved to
        the gradients' device, so it does not depend on the device."""
        leaves = list(grads_template)
        metas = self._metas(leaves)
        _, q_packer, _ = self._packers(leaves, metas)
        device = leaves[0].device if leaves else torch.device("cpu")
        gen = torch.Generator().manual_seed(self.random_seed)
        qs = [torch.randn((meta.m, meta.r), generator=gen) for meta in metas]
        q_memory = q_packer.pack(qs).to(device)
        return PowerSGDState(q_memory, torch.Generator().manual_seed(self.random_seed + 0x5EED))

    # ---- the hot path ----------------------------------------------------

    def reduce_ef(self, state: PowerSGDState, grads, memories, group):
        """``reduce(state, grads + memories, group)``. On the fused path the
        high-rank adds happen inside the compress kernel (K2a)."""
        if self.compress_impl == "pallas":
            return self._reduce(state, list(grads), list(memories), group)
        return self.reduce(state, [g + e for g, e in zip(grads, memories)], group)

    def reduce(self, state: PowerSGDState, send: List[torch.Tensor], group):
        return self._reduce(state, list(send), None, group)

    def _reduce(self, state: PowerSGDState, g_leaves, e_leaves, group):
        """The JAX package's ``_reduce``: ``e_leaves`` is None, or the error
        memories that the fused path adds inside K2a."""
        fused = self.compress_impl == "pallas"
        # the leaves the rest of the pipeline sees are the send values; on
        # the fused path the high-rank adds happen in K2a, rank-1 ones here
        if e_leaves is None:
            leaves = g_leaves
        else:
            leaves = [g if g.dim() > 1 else g + e for g, e in zip(g_leaves, e_leaves)]
        rank1_idx, _ = self._split(leaves)
        metas = self._metas(leaves)
        p_packer, q_packer, rank1_packer = self._packers(leaves, metas)
        groups = self._shape_groups(metas)
        bits = 0
        out_leaves = list(leaves)
        # rank-1 error memory stays zero (the reference never writes it);
        # the high-rank entries are filled in below
        mem_leaves = [torch.zeros_like(t) if t.dim() <= 1 else None for t in leaves]

        first_ps = None
        if metas:
            math_dtype = leaves[metas[0].leaf_index].dtype
            device = leaves[metas[0].leaf_index].device
            # Q: warm start from the previous step, or a fresh draw
            if self.reuse_query:
                qs = q_packer.unpack(state.q_memory)
            else:
                qs = [
                    torch.randn((meta.m, meta.r), generator=state.generator)
                    for meta in metas
                ]
            q_stacks = [
                torch.stack([qs[p] for p in poss]).to(device=device, dtype=math_dtype)
                for poss in groups
            ]
            if fused and e_leaves is not None:
                # M = G + E and P = M Q in one kernel per shape group (K2a);
                # M is written once because K3 and K4 read it again
                m_stacks, first_ps = [], []
                for poss, q_st in zip(groups, q_stacks):
                    m_st, p_st = fused_ef_compress(
                        self._stack_matrices(g_leaves, metas, poss),
                        q_st,
                        self._stack_matrices(e_leaves, metas, poss),
                    )
                    m_stacks.append(m_st)
                    first_ps.append(p_st)
            else:
                m_stacks = [self._stack_matrices(leaves, metas, poss) for poss in groups]
        new_q_memory = state.q_memory

        for it in range(1 + self.n_power_iterations):
            if metas:
                # P = M Q, one batched product per shape group (fused: K2b,
                # or K2a's P in round 0); ALL_REDUCE_MEAN(P)
                if it == 0 and first_ps is not None:
                    p_sts = first_ps
                elif fused:
                    p_sts = [fused_ef_compress(m_st, q_st)[1] for m_st, q_st in zip(m_stacks, q_stacks)]
                else:
                    p_sts = [torch.bmm(m_st, q_st) for m_st, q_st in zip(m_stacks, q_stacks)]
                ps = [None] * len(metas)
                for poss, p_st in zip(groups, p_sts):
                    for j, p in enumerate(poss):
                        ps[p] = p_st[j]
                p_flat = self._reduce_flat(p_packer.pack(ps), group)
                bits += n_bits(p_flat)
                ps = p_packer.unpack(p_flat)
                p_stacks = [
                    torch.stack([ps[p] for p in poss]).to(math_dtype) for poss in groups
                ]

            # rank-1 tensors: uncompressed, once
            if it == 0 and rank1_idx:
                rank1_flat = self._reduce_flat(
                    rank1_packer.pack([leaves[i] for i in rank1_idx]), group
                )
                bits += rank1_packer.bits()
                for i, o in zip(rank1_idx, rank1_packer.unpack(rank1_flat)):
                    out_leaves[i] = o.to(leaves[i].dtype)

            if metas:
                # P-hat = Gram-Schmidt(P) and Q = M^T P-hat: one launch per
                # shape group (fused: both in K3); ALL_REDUCE_MEAN(Q)
                if fused:
                    pqs = [fused_orthogonalize_project(p_st, m_st) for p_st, m_st in zip(p_stacks, m_stacks)]
                    p_stacks = [phat for phat, _ in pqs]
                    q_sts = [q_st for _, q_st in pqs]
                else:
                    p_stacks = [self._orthogonalize(p_st) for p_st in p_stacks]
                    q_sts = [
                        torch.bmm(m_st.transpose(1, 2), p_st)
                        for m_st, p_st in zip(m_stacks, p_stacks)
                    ]
                qs = [None] * len(metas)
                for poss, q_st in zip(groups, q_sts):
                    for j, p in enumerate(poss):
                        qs[p] = q_st[j]
                q_flat = self._reduce_flat(q_packer.pack(qs), group)
                bits += n_bits(q_flat)
                qs = q_packer.unpack(q_flat)
                q_stacks = [
                    torch.stack([qs[p] for p in poss]).to(math_dtype) for poss in groups
                ]
                new_q_memory = q_flat

        # decompress P-hat Q^T; error memory = send - out (fused: both in K4,
        # against M = G + E; the results are views in torch layout)
        if metas:
            for poss, p_st, q_st, m_st in zip(groups, p_stacks, q_stacks, m_stacks):
                if fused:
                    out_st, mem_st = fused_decompress_residual(p_st, q_st, m_st)
                else:
                    out_st, mem_st = torch.bmm(p_st, q_st.transpose(1, 2)), None
                for j, p in enumerate(poss):
                    meta = metas[p]
                    out = self._from_matrix(out_st[j], meta)
                    out_leaves[meta.leaf_index] = out
                    mem_leaves[meta.leaf_index] = (
                        leaves[meta.leaf_index] - out
                        if mem_st is None
                        else self._from_matrix(mem_st[j], meta)
                    )

        return PowerSGDState(new_q_memory, state.generator), out_leaves, mem_leaves, bits

    # ---- analytics -------------------------------------------------------

    def bits_per_step(self, grads_template, n_workers: int = 1) -> int:
        """``rounds * (P bits + Q bits) + rank-1 bits``; all-reduce payloads
        do not depend on the number of workers."""
        leaves = list(grads_template)
        metas = self._metas(leaves)
        p_packer, q_packer, rank1_packer = self._packers(leaves, metas)
        rounds = 1 + self.n_power_iterations
        return rounds * (p_packer.bits() + q_packer.bits()) + rank1_packer.bits()

    def ledger_entries(self, grads_template, axis: str = "", n_workers: int = 1) -> list:
        """The wire ledger of one compressed reduction: the P and the Q
        all-reduces (once each a power-iteration round) and the rank-1
        payload, each ``count`` its chunks; sums to :meth:`bits_per_step`."""
        leaves = list(grads_template)
        metas = self._metas(leaves)
        p_packer, q_packer, rank1_packer = self._packers(leaves, metas)
        rounds = 1 + self.n_power_iterations
        entries = []
        for tag, packer, repeats in (
            ("powersgd.P", p_packer, rounds), ("powersgd.Q", q_packer, rounds), ("powersgd.rank1", rank1_packer, 1),
        ):
            if packer.bits():
                chunks = _n_chunk_collectives(packer.total_size, self.comm_chunks)
                entries.append(LedgerEntry(
                    tag=tag, layer="reducer", op="all-reduce", axis=axis, dtype=dtype_name(packer.dtype),
                    payload_bytes=repeats * packer.bits() // 8, count=repeats * chunks,
                ))
        return entries

    # ---- the health probe: one collective-free diagnostic round -----------

    def _fidelity_group_names(self, metas, groups) -> List[str]:
        """A key a shape group, ``powersgd.g{k}:{n}x{m}r{r}``, in the order
        the compressed path batches them."""
        return [f"powersgd.g{k}:{metas[poss[0]].n}x{metas[poss[0]].m}r{metas[poss[0]].r}" for k, poss in enumerate(groups)]

    def fidelity_group_tags(self, grads_template) -> dict:
        """``fidelity group -> wire-ledger tag``: every shape group rides the
        packed P all-reduce (``powersgd.P``), the rank-1 tensors
        ``powersgd.rank1``."""
        leaves = list(grads_template)
        metas = self._metas(leaves)
        tags = {name: "powersgd.P" for name in self._fidelity_group_names(metas, self._shape_groups(metas))}
        if self._split(leaves)[0]:
            tags["powersgd.rank1"] = "powersgd.rank1"
        return tags

    def diagnose(self, state: PowerSGDState, send, memories=None):
        """``(rel_error, stats)`` of ONE diagnostic round,
        ``self.reduce(state, send, None)``: no collective, so on the card it
        launches the pipeline's kernels at the step's own shape groups.

        ``rel_error`` is ``|M - P-hat Q^T| / |M|`` over every leaf (the
        residual is the round's new error memory, 0 for the rank-1
        leaves); ``stats`` holds a :meth:`fidelity_group_tags` group's
        ``rel_error``, ``cosine_sim`` of ``M`` and ``P-hat Q^T``, the EF
        norm of its leaves' ``memories`` and ``quantized_share`` (1 where
        ``compression_dtype`` narrows the wire), each a scalar tensor.

        The state is read, never written: the round gets a copy of the
        generator (``reuse_query=False`` draws Q from it), its new Q is
        dropped, and the JAX package's two rounds (one for
        ``compression_error``, one for ``fidelity_stats``) are this one."""
        leaves = list(send)
        generator = torch.Generator(device=state.generator.device)
        generator.set_state(state.generator.get_state())
        _, _, residual, _ = self.reduce(PowerSGDState(state.q_memory, generator), leaves, None)
        device = leaves[0].device if leaves else None
        eps = torch.tensor(1e-30, dtype=torch.float32, device=device)
        rel_error = torch.sqrt(sq_norm(residual)) / torch.maximum(torch.sqrt(sq_norm(leaves)), eps)
        metas = self._metas(leaves)
        groups = self._shape_groups(metas)
        mems = list(memories) if memories is not None else None
        zero = torch.zeros((), dtype=torch.float32, device=device)
        quantized = torch.full((), 1.0 if self.compression_dtype is not None else 0.0, device=device)

        def ef(idxs):
            return torch.sqrt(sq_norm([mems[i] for i in idxs])) if mems is not None else zero

        stats: dict = {}
        for name, poss in zip(self._fidelity_group_names(metas, groups), groups):
            idxs = [metas[p].leaf_index for p in poss]
            sends = [leaves[i].float() for i in idxs]
            outs = [leaves[i].float() - residual[i].float() for i in idxs]
            send_norm, out_norm = torch.sqrt(sq_norm(sends)), torch.sqrt(sq_norm(outs))
            dot = sum(torch.sum(s * o) for s, o in zip(sends, outs))
            stats[name] = {
                "rel_error": torch.sqrt(sq_norm([residual[i] for i in idxs])) / torch.maximum(send_norm, eps),
                "cosine_sim": dot / torch.maximum(send_norm * out_norm, eps),
                "ef_norm": ef(idxs),
                "quantized_share": quantized,
            }
        rank1 = self._split(leaves)[0]
        if rank1:
            stats["powersgd.rank1"] = {
                "rel_error": zero, "cosine_sim": torch.ones((), dtype=torch.float32, device=device),
                "ef_norm": ef(rank1), "quantized_share": quantized,
            }
        return rel_error, stats

    def compression_error(self, state: PowerSGDState, send, group=None) -> torch.Tensor:
        """The relative compression error ``|M - P-hat Q^T| / |M|`` over the
        whole send (:meth:`diagnose`)."""
        return self.diagnose(state, send)[0]

    def fidelity_stats(self, state: PowerSGDState, send, memories=None, group=None) -> dict:
        """The per-group diagnostics of :meth:`diagnose`."""
        return self.diagnose(state, send, memories)[1]
