"""L3: gradient reduction, exact all-reduce and PowerSGD compression.

The JAX package's reducers with the same protocol, on lists of tensors in
the model's parameter order::

    state = reducer.init(params)
    state, out, new_memory, bits = reducer.reduce_ef(state, grads, memories, group)

``group=None`` is the single-process fallback (no collectives).

PowerSGD (``PowerSGDReducer``) is the JAX package's ``compress_impl="xla"``
path (the fused ``"pallas"`` pipeline is not ported yet): split rank-1 from high-rank tensors, ``r = min(n, m, rank)``, batch
same-shaped matrices into ``(g, n, m)`` shape groups, then per round
``P = M Q`` -> all-reduce(P) -> Gram-Schmidt -> ``Q = M^T P`` ->
all-reduce(Q), and decompress ``P Q^T`` with the residual kept as
error-feedback memory. All Ps ride one collective, all Qs another, and the
rank-1 tensors a third.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.gram_schmidt import gram_schmidt
from ..ops.orthogonalize import orthogonalize
from ..utils.config import ORTHOGONALIZE_IMPLS
from .comm import all_reduce_mean, n_bits
from .packing import TensorPacker


class ExactReducer:
    """All-reduce-mean of every gradient, flat-packed into one collective
    (the reference's ``average_gradients``, one collective in place of one
    per tensor; the bytes are the same)."""

    def init(self, grads_template: Sequence[torch.Tensor]) -> dict:
        return {}

    def reduce(self, state: dict, send: List[torch.Tensor], group):
        if not send:
            return state, [], [], 0
        packer = TensorPacker.for_tensors(send)
        reduced = all_reduce_mean(packer.pack(send), group)
        out = [o.to(s.dtype) for o, s in zip(packer.unpack(reduced), send)]
        new_memory = [torch.zeros_like(s) for s in send]
        return state, out, new_memory, packer.bits()

    def reduce_ef(self, state: dict, grads, memories, group):
        send = [g + e for g, e in zip(grads, memories)]
        return self.reduce(state, send, group)

    def bits_per_step(self, grads_template, n_workers: int = 1) -> int:
        return sum(n_bits(t) for t in grads_template)


class _MatrixMeta(NamedTuple):
    leaf_index: int
    shape: Tuple[int, ...]
    n: int  # matrix rows
    m: int  # matrix columns
    r: int  # min(n, m, compression_rank)


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

    ``orthogonalize_impl``: ``"auto"`` runs the CUDA Gram-Schmidt kernel on
    CUDA tensors and its plain version on CPU tensors; ``"cuda"`` requires
    CUDA tensors; ``"eager"`` always runs the plain version.
    ``compression_dtype`` (e.g. ``torch.bfloat16``) is the wire dtype of
    the P, Q and rank-1 payloads; P and Q are cast back to the gradients'
    dtype for the math.
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
    ):
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

    # ---- static layout ---------------------------------------------------

    @staticmethod
    def _split(leaves) -> Tuple[List[int], List[int]]:
        """Rank-1 (sent uncompressed) and high-rank (compressed) indices."""
        rank1 = [i for i, t in enumerate(leaves) if t.dim() <= 1]
        high = [i for i, t in enumerate(leaves) if t.dim() > 1]
        return rank1, high

    def _perm(self, ndim: int) -> Optional[Tuple[int, ...]]:
        """The permutation that puts a torch-layout tensor into the matrix's
        row-major order, or None when the plain reshape already does."""
        if self.matricize == "first":
            return None
        return tuple(range(2, ndim)) + (1, 0)

    def _metas(self, leaves) -> List[_MatrixMeta]:
        _, high = self._split(leaves)
        metas = []
        for i in high:
            shape = tuple(leaves[i].shape)
            if self.matricize == "first":
                n, m = shape[0], math.prod(shape[1:])
            else:
                n, m = math.prod(shape[1:]), shape[0]
            metas.append(_MatrixMeta(i, shape, n, m, min(n, m, self.compression_rank)))
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
        perm = self._perm(len(meta.shape))
        views = [leaves[metas[p].leaf_index] for p in poss]
        if perm is not None:
            views = [v.permute(perm) for v in views]
        return torch.stack(views).reshape(len(poss), meta.n, meta.m)

    def _from_matrix(self, mat: torch.Tensor, shape) -> torch.Tensor:
        """Inverse of the matricization: a view of ``mat`` in ``shape``."""
        perm = self._perm(len(shape))
        if perm is None:
            return mat.reshape(shape)
        inv = [0] * len(perm)
        for k, p in enumerate(perm):
            inv[p] = k
        return mat.reshape([shape[p] for p in perm]).permute(inv)

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
        """``reduce(state, grads + memories, group)``."""
        return self.reduce(state, [g + e for g, e in zip(grads, memories)], group)

    def reduce(self, state: PowerSGDState, send: List[torch.Tensor], group):
        leaves = list(send)
        rank1_idx, _ = self._split(leaves)
        metas = self._metas(leaves)
        p_packer, q_packer, rank1_packer = self._packers(leaves, metas)
        groups = self._shape_groups(metas)
        bits = 0
        out_leaves = list(leaves)
        # rank-1 error memory stays zero (the reference never writes it);
        # the high-rank entries are filled in below
        mem_leaves = [torch.zeros_like(t) if t.dim() <= 1 else None for t in leaves]

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
            m_stacks = [self._stack_matrices(leaves, metas, poss) for poss in groups]
        new_q_memory = state.q_memory

        for it in range(1 + self.n_power_iterations):
            if metas:
                # P = M Q, one batched matmul per shape group; ALL_REDUCE_MEAN(P)
                ps = [None] * len(metas)
                for poss, m_st, q_st in zip(groups, m_stacks, q_stacks):
                    p_st = torch.bmm(m_st, q_st)
                    for j, p in enumerate(poss):
                        ps[p] = p_st[j]
                p_flat = all_reduce_mean(p_packer.pack(ps), group)
                bits += n_bits(p_flat)
                ps = p_packer.unpack(p_flat)
                p_stacks = [
                    torch.stack([ps[p] for p in poss]).to(math_dtype) for poss in groups
                ]

            # rank-1 tensors: uncompressed, once
            if it == 0 and rank1_idx:
                rank1_flat = all_reduce_mean(
                    rank1_packer.pack([leaves[i] for i in rank1_idx]), group
                )
                bits += rank1_packer.bits()
                for i, o in zip(rank1_idx, rank1_packer.unpack(rank1_flat)):
                    out_leaves[i] = o.to(leaves[i].dtype)

            if metas:
                # P-hat = Gram-Schmidt(P): one launch per shape group;
                # Q = M^T P-hat; ALL_REDUCE_MEAN(Q)
                p_stacks = [self._orthogonalize(p_st) for p_st in p_stacks]
                qs = [None] * len(metas)
                for poss, m_st, p_st in zip(groups, m_stacks, p_stacks):
                    q_st = torch.bmm(m_st.transpose(1, 2), p_st)
                    for j, p in enumerate(poss):
                        qs[p] = q_st[j]
                q_flat = all_reduce_mean(q_packer.pack(qs), group)
                bits += n_bits(q_flat)
                qs = q_packer.unpack(q_flat)
                q_stacks = [
                    torch.stack([qs[p] for p in poss]).to(math_dtype) for poss in groups
                ]
                new_q_memory = q_flat

        # decompress P-hat Q^T; error memory = send - out
        if metas:
            for poss, p_st, q_st in zip(groups, p_stacks, q_stacks):
                approx = torch.bmm(p_st, q_st.transpose(1, 2))
                for j, p in enumerate(poss):
                    meta = metas[p]
                    out = self._from_matrix(approx[j], meta.shape)
                    out_leaves[meta.leaf_index] = out
                    mem_leaves[meta.leaf_index] = leaves[meta.leaf_index] - out

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
