"""The port's elastic data (``data/partition.py``): ``elastic_assignments``,
the Feistel ``StreamedPermutation``, ``ElasticIndexStream`` with its
checkpointable ``state`` and ``streamed_elastic_assignments``, each equal
index for index to the JAX package's on the same arguments, plus the
properties a degraded restart relies on: a bijection, residue ownership
tiling every window at every world size, and a mid-shard resume across a
reshape that neither drops nor repeats a sample.

Both modules are pure integer code; the JAX package's is loaded by path,
as its own tests load it (it imports no jax).
"""

import importlib.util
import os

import numpy as np
import pytest

from network_distributed_pytorch_tpu_torch.data import partition as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_reference():
    path = os.path.join(REPO, "network_distributed_pytorch_tpu", "data", "partition.py")
    spec = importlib.util.spec_from_file_location("_reference_partition", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_reference()


@pytest.mark.parametrize("data_len,world", [(50_000, 1), (50_000, 3), (1000, 7), (97, 4)])
def test_elastic_assignments_equal_the_jax_package_s(data_len, world):
    assert port.elastic_assignments(data_len, world) == ref.elastic_assignments(data_len, world)
    assert port.elastic_assignments(data_len, world, seed=5) == ref.elastic_assignments(data_len, world, seed=5)
    # the W' survivors cover the same permutation prefix, disjointly
    parts = port.elastic_assignments(data_len, world)
    flat = [i for p in parts for i in p]
    assert len(flat) == len(set(flat)) == world * (data_len // world)


@pytest.mark.parametrize("data_len,seed", [(1, 0), (2, 3), (10, 1234), (50_000, 1234), (1_000_003, 7), (10**9, 11)])
def test_streamed_permutation_equals_the_jax_package_s(data_len, seed):
    p, r = port.StreamedPermutation(data_len, seed), ref.StreamedPermutation(data_len, seed)
    assert (p.bits, p.domain, p._keys) == (r.bits, r.domain, r._keys)
    offsets = np.random.RandomState(seed).randint(0, data_len, size=min(data_len, 4096))
    got = p.apply(offsets)
    np.testing.assert_array_equal(got, r.apply(offsets))
    np.testing.assert_array_equal(p.invert(got), offsets)
    np.testing.assert_array_equal(p.window(0, min(data_len, 300)), r.window(0, min(data_len, 300)))


def test_streamed_permutation_is_a_bijection():
    for n in (1, 5, 64, 1000, 4097):
        perm = port.StreamedPermutation(n, seed=3).window(0, n)
        assert sorted(perm.tolist()) == list(range(n))
    with pytest.raises(ValueError):
        port.StreamedPermutation(10).apply(np.array([10]))
    with pytest.raises(ValueError):
        port.StreamedPermutation(0)


def test_elastic_index_stream_equals_the_jax_package_s():
    p, r = port.ElasticIndexStream(50_000, seed=1234), ref.ElasticIndexStream(50_000, seed=1234)
    positions = np.arange(49_000, 52_000, 7)  # straddles an epoch boundary
    np.testing.assert_array_equal(p.indices_at(positions), r.indices_at(positions))
    for cursor, world, rank, count in ((0, 1, 0, 10), (123, 4, 3, 500), (49_990, 3, 1, 40), (10**6, 8, 5, 17)):
        np.testing.assert_array_equal(
            p.shard_positions(cursor, world, rank, count), r.shard_positions(cursor, world, rank, count)
        )
        np.testing.assert_array_equal(
            p.shard_indices(cursor, world, rank, count), r.shard_indices(cursor, world, rank, count)
        )
    assert p.state(777) == r.state(777)
    stream, cursor = port.ElasticIndexStream.from_state(r.state(777))
    assert (stream.data_len, stream.seed, cursor) == (50_000, 1234, 777)
    with pytest.raises(ValueError):
        port.ElasticIndexStream.from_state({"kind": "other"})
    with pytest.raises(ValueError):
        port.ElasticIndexStream.from_state({**p.state(0), "schema": 99})


@pytest.mark.parametrize("data_len,world,cursor,count", [(50_000, 4, 0, None), (1001, 3, 500, 40), (64, 5, 3, None)])
def test_streamed_elastic_assignments_equal_the_jax_package_s(data_len, world, cursor, count):
    got = port.streamed_elastic_assignments(data_len, world, seed=9, cursor=cursor, count=count)
    want = ref.streamed_elastic_assignments(data_len, world, seed=9, cursor=cursor, count=count)
    assert len(got) == len(want) == world
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_residue_windows_tile_and_a_reshape_drops_nothing():
    """Any window [c, c + G) is the disjoint union of the W ranks'
    positions, for every W; so a run that reshapes 4 -> 3 mid-shard
    consumes exactly the uninterrupted run's samples."""
    stream = port.ElasticIndexStream(1000, seed=2)
    for world in (1, 2, 3, 4, 7):
        for cursor in (0, 5, 998):
            per = [stream.shard_positions(cursor, world, r, 12 // world + 1) for r in range(world)]
            window = set(range(cursor, cursor + 12))
            owned = set(np.concatenate(per).tolist()) & window
            assert owned == window
    global_batch = 12
    uninterrupted = stream.indices_at(np.arange(0, 10 * global_batch))
    consumed, cursor = [], 0
    for step in range(10):
        world = 4 if step < 6 else 3  # a rank lost after step 6
        for r in range(world):
            consumed.extend(stream.shard_indices(cursor, world, r, global_batch // world).tolist())
        cursor += global_batch
    assert sorted(consumed) == sorted(uninterrupted.tolist())
