"""The paged KV cache's gathers and scatters, the JAX package's
``ops/paged.py`` in torch indexing (XLA gathers and scatters there, no
Pallas kernel).

A paged K or V buffer of one layer is ``(n_blocks, block_len, H, D)``; a
slot's logical ``(max_len, H, D)`` view is stitched through a block TABLE
of ``max_len // block_len`` physical block ids. Tables are data: the
serving engine's one decode step serves every allocation, free and
copy-on-write.

:func:`gather_block_view` gives a ``(B, max_len, H, D)`` tensor whose
valid positions hold exactly the dense cache's rows, and the decode step's
position mask gives every other position a softmax weight of exactly 0. So
whatever the garbage block 0 (or a block not yet written) holds adds
``0.0 * finite`` to the attention, which is exact; the pool starts as
zeros so that nothing in it is ever NaN.

Out-of-range writes: JAX clamps an index, torch raises on the CPU and
fires a device-side assert on the card. :func:`scatter_token_rows` clamps
the block index and sends a position past the table to the garbage block
0, as the reference does: a speculative round writes up to K - 1 positions
past a finished row, and those writes must not land on a live block.

The scatters write ``pool_buf`` in place (where the JAX engine donates it)
and return it. Duplicate coordinates only ever fall in block 0 (overrun
rows, a chain padded with 0), where which write wins does not matter.
"""

from __future__ import annotations

import torch


def block_view_shape(tables: torch.Tensor, pool_buf: torch.Tensor):
    """The logical ``(B, max_len, H, D)`` shape of a table and pool pair."""
    return (
        tables.shape[0],
        tables.shape[1] * pool_buf.shape[1],
        pool_buf.shape[2],
        pool_buf.shape[3],
    )


def gather_block_view(pool_buf: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Each slot's logical K or V rows: pool_buf ``(n_blocks, L, H, D)``,
    tables ``(B, T)`` (long) -> ``(B, T * L, H, D)``, a new tensor."""
    g = pool_buf[tables]  # (B, T, L, H, D)
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], g.shape[3], g.shape[4])


def scatter_token_rows(
    pool_buf: torch.Tensor, tables: torch.Tensor, pos: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """Write one token's K or V rows for every slot, in place: tables ``(B,
    T)``, pos ``(B,)`` logical positions, rows ``(B, H, D)``. Row ``b`` lands
    at ``(tables[b, pos[b] // L], pos[b] % L)``; a position ``>= T * L`` goes
    to the garbage block 0."""
    n_blk = tables.shape[1]
    block_len = pool_buf.shape[1]
    blk_idx = torch.clamp(pos // block_len, max=n_blk - 1)
    phys = tables.gather(1, blk_idx[:, None])[:, 0]
    phys = torch.where(pos < n_blk * block_len, phys, torch.zeros_like(phys))
    pool_buf[phys, pos % block_len] = rows.to(pool_buf.dtype)
    return pool_buf


def scatter_chain(pool_buf: torch.Tensor, chain: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Write a freshly prefilled logical row into its block chain, in place:
    chain ``(T,)`` physical ids (padded with 0 past the request's
    reservation), rows ``(T * L, H, D)``. The padding's blocks all land in
    block 0, which is never read as valid."""
    block_len = pool_buf.shape[1]
    blocks = rows.reshape(chain.shape[0], block_len, rows.shape[1], rows.shape[2])
    pool_buf[chain] = blocks.to(pool_buf.dtype)
    return pool_buf


def copy_block(pool_buf: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """Copy-on-write of one block, in place: physical block ``src`` into
    ``dst``. The caller points the slot's table entry at ``dst``."""
    pool_buf[dst] = pool_buf[src]
    return pool_buf


def pool_chain_view(pool_buf: torch.Tensor, chain: torch.Tensor) -> torch.Tensor:
    """One chain's logical rows: chain ``(T,)`` -> ``(T * L, H, D)``, a new
    tensor. Shared-prefix admission reads the prefix's K/V with it."""
    g = pool_buf[chain]  # (T, L, H, D)
    return g.reshape(g.shape[0] * g.shape[1], g.shape[2], g.shape[3])
