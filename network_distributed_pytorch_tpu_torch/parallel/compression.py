"""L3: the gather-based gradient compressors: top-k, 1-bit sign and int8
quantization (the JAX package's ``parallel/compression.py``).

Each has the reducers' protocol, on lists of tensors in the model's
parameter order::

    state = reducer.init(params)
    state, out, new_memory, bits = reducer.reduce(state, send, group)
    state, out, new_memory, bits = reducer.reduce_ef(state, grads, memories, group)

and pairs with ``algorithm="ef_momentum"``: what the compression drops
lands in the error-feedback memory and is sent again next step.

Every leaf rides one flat buffer in leaf order. Each worker sends its
compressed payload in its own dtype through :func:`..comm.all_gather`
(TopK: fp32 values and int32 indices; SignSGD: a uint8 bitmap and one fp32
scale a leaf; QSGD: int8 levels and one fp32 scale a leaf), never a
widened all-reduce. Bits are counted as the gathered result, W times each
worker's contribution, the JAX package's convention: a gather's wire cost
grows with W, unlike PowerSGD's all-reduced factors.

``out`` is the same on every rank, bit for bit: each rank decodes the same
gathered payloads in the same order. The mean over workers is the sum
times ``1 / W`` (:mod:`..comm`'s convention).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist

from .comm import all_gather
from .packing import TensorPacker


def _flatten(send):
    leaves = list(send)
    packer = TensorPacker.for_tensors(leaves)
    return leaves, packer, packer.pack(leaves)


def _slices(packer: TensorPacker):
    """``(start, end)`` of each leaf in the flat buffer."""
    out, start = [], 0
    for size in packer.sizes:
        out.append((start, start + size))
        start += size
    return out


def _per_leaf_mean(gathered: torch.Tensor, scales: torch.Tensor, packer: TensorPacker) -> List[torch.Tensor]:
    """The mean over workers of ``scales[w, leaf] * gathered[w, leaf's
    elements]``, leaf by leaf (no ``(W, n)`` fp32 scale matrix)."""
    w = gathered.shape[0]
    out = []
    for t, ((s, e), shape) in enumerate(zip(_slices(packer), packer.shapes)):
        block = gathered[:, s:e].to(torch.float32)
        out.append((scales[:, t] @ block).mul_(1.0 / w).reshape(shape))
    return out


def _own_contribution_residual(flat, leaves, packer, scales, decoded) -> List[torch.Tensor]:
    """Each leaf's send minus this worker's own decoded contribution,
    ``scale * decoded``: the error-feedback memory."""
    mems = []
    for t, ((s, e), leaf) in enumerate(zip(_slices(packer), leaves)):
        local = (scales[t] * decoded[s:e]).reshape(leaf.shape)
        mems.append((flat[s:e].reshape(leaf.shape) - local).to(leaf.dtype))
    return mems


class TopKReducer:
    """Top-k sparsification with error feedback: each worker keeps the
    ``k`` largest-magnitude elements of its flat send buffer, the workers
    gather ``(values, indices)``, and the mean scatters every worker's
    values back. ``k = max(min_k, min(n, round(k_fraction * n)))`` over all
    n elements. Wire: ``W * k * (32 + 32)`` bits.

    The scatter-add runs worker by worker, in worker order: within one
    worker the indices are unique, so each add is deterministic even where
    ``index_add_`` adds with atomics (CUDA), and where two workers picked
    the same element their values sum in the same order on every rank."""

    def __init__(self, k_fraction: float = 0.01, min_k: int = 1):
        if not 0.0 < k_fraction <= 1.0:
            raise ValueError(f"k_fraction must be in (0, 1], got {k_fraction}")
        self.k_fraction = k_fraction
        self.min_k = min_k

    def _k(self, total: int) -> int:
        return max(self.min_k, min(total, int(round(self.k_fraction * total))))

    def init(self, grads_template) -> dict:
        return {}

    def reduce(self, state: dict, send, group):
        leaves, packer, flat = _flatten(send)
        k = self._k(packer.total_size)
        _, idx = torch.topk(flat.abs(), k)
        vals = flat[idx]
        vals_all = all_gather(vals, group)  # (W, k) fp32
        idx_all = all_gather(idx.to(torch.int32), group)  # (W, k) int32
        w = vals_all.shape[0]
        out_flat = torch.zeros_like(flat)
        for j in range(w):
            out_flat.index_add_(0, idx_all[j].long(), vals_all[j])
        out_flat.mul_(1.0 / w)
        mem_flat = flat - torch.zeros_like(flat).index_put_((idx,), vals)
        out = [o.to(l.dtype) for o, l in zip(packer.unpack(out_flat), leaves)]
        mem = [m.to(l.dtype) for m, l in zip(packer.unpack(mem_flat), leaves)]
        return state, out, mem, w * k * (32 + 32)

    def reduce_ef(self, state, grads, memories, group):
        return self.reduce(state, [g + e for g, e in zip(grads, memories)], group)

    def bits_per_step(self, grads_template, n_workers: int = 1) -> int:
        total = sum(t.numel() for t in grads_template)
        return n_workers * self._k(total) * (32 + 32)


def pack_bits(positive: torch.Tensor) -> torch.Tensor:
    """``(n,)`` bool -> ``(ceil(n / 8),)`` uint8, little-endian within each
    byte: element ``8 i + b`` is bit ``b`` of byte ``i``."""
    n = positive.shape[0]
    nb = -(-n // 8)
    padded = torch.zeros(nb * 8, dtype=torch.uint8, device=positive.device)
    padded[:n] = positive.to(torch.uint8)
    weights = torch.tensor([1 << b for b in range(8)], dtype=torch.int32, device=positive.device)
    return (padded.view(nb, 8).to(torch.int32) * weights).sum(1).to(torch.uint8)


def unpack_signs(bitmap: torch.Tensor, n: int) -> torch.Tensor:
    """``(..., nb)`` uint8 -> ``(..., n)`` int8 in {-1, +1}."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bitmap.device)
    bits = (bitmap[..., None] >> shifts) & 1
    bits = bits.reshape(*bitmap.shape[:-1], -1)[..., :n]
    return (2 * bits.to(torch.int8) - 1).to(torch.int8)


class SignSGDReducer:
    """1-bit sign compression with one scale a leaf and error feedback
    (EF-signSGD): each worker sends ``send >= 0`` as a uint8 bitmap (so
    -0.0 counts as positive) and ``mean(|leaf|)`` a leaf; a contribution
    decodes to ``scale * sign``. Wire: ``W * (8 * ceil(n / 8) + 32 L)``
    bits for n elements in L leaves."""

    def init(self, grads_template) -> dict:
        return {}

    def reduce(self, state: dict, send, group):
        leaves, packer, flat = _flatten(send)
        n = packer.total_size
        scales = torch.stack([leaf.abs().mean() for leaf in leaves]).to(torch.float32)
        bitmap = pack_bits(flat >= 0)
        bitmap_all = all_gather(bitmap, group)  # (W, nb) uint8
        scales_all = all_gather(scales, group)  # (W, L) fp32
        out_leaves = _per_leaf_mean(unpack_signs(bitmap_all, n), scales_all, packer)
        local_signs = unpack_signs(bitmap, n).to(torch.float32)
        mem = _own_contribution_residual(flat, leaves, packer, scales, local_signs)
        out = [o.to(l.dtype) for o, l in zip(out_leaves, leaves)]
        w = bitmap_all.shape[0]
        return state, out, mem, w * (8 * bitmap.numel() + 32 * len(leaves))

    def reduce_ef(self, state, grads, memories, group):
        return self.reduce(state, [g + e for g, e in zip(grads, memories)], group)

    def bits_per_step(self, grads_template, n_workers: int = 1) -> int:
        leaves = list(grads_template)
        n = sum(t.numel() for t in leaves)
        return n_workers * (8 * (-(-n // 8)) + 32 * len(leaves))


def quantize(levels: torch.Tensor, noise: Optional[torch.Tensor]) -> torch.Tensor:
    """QSGD's int8 levels: ``floor(levels + noise)`` (stochastic rounding,
    ``noise`` uniform on [0, 1)), or ``round(levels)`` half to even where
    ``noise`` is None; clipped to [-127, 127]."""
    q = torch.round(levels) if noise is None else torch.floor(levels + noise)
    return q.clamp_(-127, 127).to(torch.int8)


class QSGDState(NamedTuple):
    """The steps taken: with the seed and the rank it keys each step's
    rounding noise."""

    step: int


class QSGDReducer:
    """Stochastic int8 quantization with error feedback (QSGD at s = 127):
    one scale a leaf, ``max|leaf| / 127`` (1 for an all-zero leaf), each
    element rounded to an int8 level at random so that ``E[q scale] = x``.
    Wire: ``W * (8 n + 32 L)`` bits.

    The noise is uniform on [0, 1), drawn by a ``torch.Generator`` on the
    send buffer's device, seeded from ``random_seed``, the step and the
    rank in the group, so the ranks' noise is independent with no
    communication. It is not ``jax.random``'s stream, and the CPU's and the
    card's generators give different streams: the quantizer itself is
    :func:`quantize`, which takes the noise as an input.
    ``stochastic=False`` rounds half to even, as the JAX package does."""

    def __init__(self, random_seed: int = 714, stochastic: bool = True):
        self.random_seed = random_seed
        self.stochastic = stochastic

    def init(self, grads_template) -> QSGDState:
        return QSGDState(step=0)

    def noise(self, state: QSGDState, n: int, device, rank: int) -> torch.Tensor:
        """The uniform noise of ``state``'s step on ``rank``, ``(n,)`` fp32."""
        seed = ((self.random_seed * 1_000_003 + state.step) * 65_537 + rank) % (1 << 63)
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.rand(n, generator=gen, device=device)

    def reduce(self, state: QSGDState, send, group):
        leaves, packer, flat = _flatten(send)
        n = packer.total_size
        maxabs = torch.stack([leaf.abs().max() for leaf in leaves]).to(torch.float32)
        scales = torch.where(maxabs > 0, maxabs / 127.0, torch.ones_like(maxabs))
        inv = torch.repeat_interleave(
            1.0 / scales, torch.tensor(packer.sizes, device=scales.device), output_size=n
        )
        levels = flat.to(torch.float32) * inv
        rank = 0 if group is None else dist.get_rank(group)
        noise = self.noise(state, n, flat.device, rank) if self.stochastic else None
        q = quantize(levels, noise)
        q_all = all_gather(q, group)  # (W, n) int8
        scales_all = all_gather(scales, group)  # (W, L) fp32
        out_leaves = _per_leaf_mean(q_all, scales_all, packer)
        mem = _own_contribution_residual(flat, leaves, packer, scales, q.to(torch.float32))
        out = [o.to(l.dtype) for o, l in zip(out_leaves, leaves)]
        w = q_all.shape[0]
        return QSGDState(state.step + 1), out, mem, w * (8 * n + 32 * len(leaves))

    def reduce_ef(self, state, grads, memories, group):
        return self.reduce(state, [g + e for g, e in zip(grads, memories)], group)

    def bits_per_step(self, grads_template, n_workers: int = 1) -> int:
        leaves = list(grads_template)
        n = sum(t.numel() for t in leaves)
        return n_workers * (8 * n + 32 * len(leaves))

