"""Sequence (context) parallelism, the JAX package's
``parallel/sequence.py``: exact attention with q, k and v sharded along
the sequence over a ``seq`` mesh axis.

- :func:`ring_attention` (Liu et al. 2023): the k and v blocks, and the
  additive padding mask with them, rotate one rank round the ring per hop
  (:func:`..comm.ppermute`, each hop one permute each of k, v and the
  mask), and each rank accumulates its queries' softmax online (running
  max, normaliser and numerator), so the full score matrix never exists;
- :func:`ulysses_attention` (DeepSpeed-Ulysses, Jacobs et al. 2023): one
  :func:`..comm.all_to_all` per tensor re-shards q, k, v from
  sequence-split to head-split, each rank attends over the whole sequence
  for its ``H / N`` heads (the same online softmax, one key block per
  shard), and one all-to-all brings the output back. It needs
  ``n_heads % N == 0``.

Both keep the JAX functions' arithmetic: fp32 scores scaled by
``1 / sqrt(D)`` after the product, ``-inf`` for masked scores, the guard of
fully masked rows, and the ``1e-37`` floor under the normaliser. The
attention itself is plain PyTorch, as in the JAX package (``jnp.einsum``),
not the flash kernel. Autograd differentiates through the hops: each
permute's backward sends the cotangent back along the inverse permutation.

The ring makes ``N - 1`` hops: the JAX loop permutes after its last block
too, handing each block back to its owner, a transfer whose result is
never read; here it is not made.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from .comm import all_gather_tiled, all_to_all, ppermute, world_size


def _axis_index(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _online_block(q32, k_blk, v_blk, bias, allowed, m, l, acc, scale):
    """One key block of the online softmax: ``q32`` ``(B, Tq, H, D)`` fp32,
    ``bias`` ``(B, Tk)`` additive, ``allowed`` a ``(Tq, Tk)`` bool or None.
    Returns the new ``(m, l, acc)``."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float()) * scale
    scores = scores + bias[:, None, None, :]
    if allowed is not None:
        scores = scores.masked_fill(~allowed, float("-inf"))
    blk_max = scores.amax(dim=-1, keepdim=True)
    new_m = torch.maximum(m, blk_max)
    # fully masked rows: exp(-inf - -inf) at new_m = -inf
    safe_m = torch.where(torch.isfinite(new_m), new_m, torch.zeros_like(new_m))
    correction = torch.exp(torch.where(torch.isfinite(m), m - safe_m, torch.full_like(m, float("-inf"))))
    p = torch.exp(scores - safe_m)
    p = torch.where(torch.isfinite(scores), p, torch.zeros_like(p))
    l = l * correction + p.sum(dim=-1, keepdim=True)
    acc = acc * correction + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
    return new_m, l, acc


def _start(b, h, tq, d, device):
    m = torch.full((b, h, tq, 1), float("-inf"), device=device)
    return m, torch.zeros((b, h, tq, 1), device=device), torch.zeros((b, h, tq, d), device=device)


def _finish(l, acc, dtype):
    return (acc / l.clamp_min(1e-37)).permute(0, 2, 1, 3).to(dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Exact multi-head attention with sequence-sharded q, k, v.

    Per rank: ``q`` ``(B, Tq, H, D)`` this rank's query block, ``k``, ``v``
    ``(B, Tk, H, D)`` its key/value block, ``mask`` ``(B, Tk)`` the additive
    mask of its key block (0 attends, ``-inf`` is padding; None: all
    attend), which rotates with k and v. ``causal`` masks by global token
    position, computed from each block's place in the ring. Returns this
    rank's ``(B, Tq, H, D)`` block of the full-attention output, in q's
    dtype. ``group`` is the ``seq`` axis (None: one shard)."""
    n = world_size(group)
    me = _axis_index(group)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    if mask is None:
        mask = torch.zeros((b, tk), device=q.device)
    mask = mask.float()
    q32 = q.float()
    m, l, acc = _start(b, h, tq, d, q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]  # pass k, v to the right
    k_blk, v_blk, mask_blk = k, v, mask
    for i in range(n):
        src = (me - i) % n  # the block in hand started on rank src
        allowed = None
        if causal:
            q_pos = me * tq + torch.arange(tq, device=q.device)
            k_pos = src * tk + torch.arange(tk, device=q.device)
            allowed = q_pos[:, None] >= k_pos[None, :]
        m, l, acc = _online_block(q32, k_blk, v_blk, mask_blk, allowed, m, l, acc, scale)
        if i < n - 1:
            k_blk, v_blk, mask_blk = (ppermute(t, perm, group) for t in (k_blk, v_blk, mask_blk))
    return _finish(l, acc, q.dtype)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Exact attention with sequence-sharded q, k, v by the head <->
    sequence all-to-all: per rank ``(B, T / N, H, D)`` in and out, ``mask``
    ``(B, T / N)`` additive for the local block. Raises ``ValueError``
    when ``N`` does not divide the heads."""
    n = world_size(group)
    b, t_loc, h, d = q.shape
    if h % n:
        raise ValueError(f"n_heads={h} must divide over {n} sequence shards")
    t = t_loc * n
    scale = 1.0 / math.sqrt(d)
    # sequence-sharded -> head-sharded: (B, T/N, H, D) -> (B, T, H/N, D)
    qh, kh, vh = (all_to_all(x, 2, 1, group) for x in (q, k, v))
    if mask is None:
        bias = torch.zeros((b, t), device=q.device)
    else:
        # (B, T/N) -> (B, T), shard-major, the all-to-all's order
        bias = all_gather_tiled(mask.float(), 1, group)
    q32 = qh.float()
    m, l, acc = _start(b, h // n, t, d, q.device)
    for i in range(n):
        ks = slice(i * t_loc, (i + 1) * t_loc)
        allowed = None
        if causal:
            q_pos = torch.arange(t, device=q.device)
            k_pos = i * t_loc + torch.arange(t_loc, device=q.device)
            allowed = q_pos[:, None] >= k_pos[None, :]
        m, l, acc = _online_block(q32, kh[:, ks], vh[:, ks], bias[:, ks], allowed, m, l, acc, scale)
    ctx = _finish(l, acc, q.dtype)
    # head-sharded -> sequence-sharded: (B, T, H/N, D) -> (B, T/N, H, D)
    return all_to_all(ctx, 1, 2, group)
