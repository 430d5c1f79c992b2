"""The port's paged KV ops (``ops/paged.py``) against the JAX package's on
the same numpy inputs, bit for bit: the view shape, the block gather, the
per-token scatter (a position past the table lands in the garbage block 0,
never on a live block), the chain scatter (a chain padded with 0), the
copy-on-write block copy and the chain view.

Duplicate coordinates only ever fall in block 0, where the order of the
writes is unspecified on both sides: where two writes collide there, block
0 is held to hold one of them, and every other block bit for bit."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu_torch.ops import paged

jax_paged = importlib.import_module("network_distributed_pytorch_tpu.ops.paged")

N_BLOCKS, L, H, D = 9, 4, 2, 3
T = 3  # blocks a table: max_len 12


def _pool(seed, n_blocks=N_BLOCKS):
    return np.random.RandomState(seed).randn(n_blocks, L, H, D).astype(np.float32)


def _rows(seed, b):
    return np.random.RandomState(seed).randn(b, H, D).astype(np.float32)


TABLES = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0], [0, 0, 0]], np.int32)


def _both(name, *args):
    """``paged.<name>`` on torch copies of ``args`` and the JAX function on
    the arrays; returns both results as numpy."""
    got = getattr(paged, name)(*(torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a for a in args))
    want = getattr(jax_paged, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    if isinstance(got, tuple):
        return got, want
    return got.numpy(), np.asarray(want)


def test_block_view_shape_matches_jax():
    pool = _pool(0)
    got = paged.block_view_shape(torch.from_numpy(TABLES), torch.from_numpy(pool))
    assert got == jax_paged.block_view_shape(jnp.asarray(TABLES), jnp.asarray(pool)) == (4, T * L, H, D)


def test_gather_block_view_matches_jax():
    got, want = _both("gather_block_view", _pool(1), TABLES.astype(np.int64))
    assert got.shape == (4, T * L, H, D)
    np.testing.assert_array_equal(got, want)


POSITIONS = {
    # in range: block starts, block ends, a vacant row's position 0
    "in_range": [0, 7, 3, 0],
    # row 0 at the table's last position, row 1 past its chain's end inside
    # the table (its padding points at block 0), rows 2 and 3 past the
    # table; the three land at offsets 0, 1 and 2 of block 0
    "overrun": [11, 8, 13, 14],
}


@pytest.mark.parametrize("case", list(POSITIONS))
def test_scatter_token_rows_matches_jax(case):
    pool, rows = _pool(2), _rows(3, 4)
    pos = np.array(POSITIONS[case], np.int64)
    got, want = _both("scatter_token_rows", pool, TABLES.astype(np.int64), pos, rows)
    np.testing.assert_array_equal(got, want)
    for b, p in enumerate(pos):
        if p >= T * L:  # past the table: the garbage block
            np.testing.assert_array_equal(got[0, p % L], rows[b])
        elif TABLES[b, p // L] != 0:
            np.testing.assert_array_equal(got[TABLES[b, p // L], p % L], rows[b])
    # nothing but the targets moved
    touched = {(int(TABLES[b, p // L]) if p < T * L else 0, int(p % L)) for b, p in enumerate(pos)}
    for blk in range(N_BLOCKS):
        for off in range(L):
            if (blk, off) not in touched:
                np.testing.assert_array_equal(got[blk, off], pool[blk, off])


def test_scatter_token_rows_overrun_never_lands_on_a_live_block():
    """Two rows past the table at the same offset collide in block 0: every
    live block keeps its bits, and block 0 holds one of the two rows."""
    pool, rows = _pool(4), _rows(5, 4)
    # rows 0 and 1 past the table, both at offset 0 of block 0; rows 2 and 3
    # inside it, on table entries padded with 0 (offsets 1 and 2 of block 0)
    pos = np.array([12, 16, 5, 2], np.int64)
    got, want = _both("scatter_token_rows", pool, TABLES.astype(np.int64), pos, rows)
    np.testing.assert_array_equal(got[1:], want[1:])
    np.testing.assert_array_equal(got[0, 1:], want[0, 1:])
    assert any(np.array_equal(got[0, 0], rows[b]) for b in (0, 1))
    assert any(np.array_equal(want[0, 0], rows[b]) for b in (0, 1))
    np.testing.assert_array_equal(got[1:], pool[1:])  # every live block keeps its bits


@pytest.mark.parametrize("chain", [[3, 7, 1], [5, 0, 0]], ids=["full", "padded"])
def test_scatter_chain_matches_jax(chain):
    pool = _pool(6)
    rows = np.random.RandomState(7).randn(T * L, H, D).astype(np.float32)
    chain = np.array(chain, np.int64)
    got, want = _both("scatter_chain", pool, chain, rows)
    if 0 in chain:  # two padding blocks collide in block 0
        np.testing.assert_array_equal(got[1:], want[1:])
        pads = [rows[j * L : (j + 1) * L] for j in np.flatnonzero(chain == 0)]
        assert any(np.array_equal(got[0], p) for p in pads)
    else:
        np.testing.assert_array_equal(got, want)
    for j, blk in enumerate(chain):
        if blk:
            np.testing.assert_array_equal(got[blk], rows[j * L : (j + 1) * L])


def test_copy_block_matches_jax():
    got, want = _both("copy_block", _pool(8), 3, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[6], got[3])


def test_pool_chain_view_matches_jax():
    got, want = _both("pool_chain_view", _pool(9), np.array([4, 2, 0], np.int64))
    assert got.shape == (T * L, H, D)
    np.testing.assert_array_equal(got, want)


def test_scatters_write_in_place():
    """The port's scatters write the pool they are given (where the JAX
    engine donates it) and return it."""
    pool = torch.from_numpy(_pool(10))
    assert paged.scatter_token_rows(pool, torch.from_numpy(TABLES).long(), torch.tensor([0, 1, 2, 3]),
                                    torch.zeros(4, H, D)) is pool
    assert paged.scatter_chain(pool, torch.tensor([1, 2, 3]), torch.ones(T * L, H, D)) is pool
    assert paged.copy_block(pool, 1, 8) is pool
    assert torch.equal(pool[8], torch.ones(L, H, D))
