"""The PyTorch port's packing and collectives: ``TensorPacker`` round trips
and bit counts, ``chunk_bounds`` equal to the JAX package's, and on two Gloo
ranks an all-reduce-mean of K chunks bitwise equal to one collective."""

import pytest
import torch
import torch.distributed as dist

from network_distributed_pytorch_tpu.parallel.comm import chunk_bounds as jax_chunk_bounds
from network_distributed_pytorch_tpu_torch.parallel.comm import (
    all_reduce_mean,
    chunk_bounds,
    chunked_all_reduce_mean,
    n_bits,
)
from network_distributed_pytorch_tpu_torch.parallel.mesh import (
    DistributedConfig,
    initialize_distributed,
    resolve_device,
    shutdown_distributed,
)
from network_distributed_pytorch_tpu_torch.parallel.packing import TensorPacker
from torch_worker import comm_rank, exact_rank, few_torch_threads, run_all, spawn  # few_torch_threads: autouse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packer_round_trip_and_bits(dtype):
    shapes = [(3, 4), (7,), (), (2, 3, 5)]
    gen = torch.Generator().manual_seed(0)
    tensors = [torch.randn(s, generator=gen) for s in shapes]
    packer = TensorPacker(shapes, dtype=dtype)
    flat = packer.pack(tensors)
    assert flat.shape == (12 + 7 + 1 + 30,) and flat.dtype == dtype
    for got, want in zip(packer.unpack(flat), tensors):
        assert got.shape == want.shape
        assert torch.equal(got, want.to(dtype))
    itemsize = 2 if dtype == torch.bfloat16 else 4
    assert packer.bits() == 8 * 50 * itemsize == n_bits(flat)


def test_packer_unpack_is_a_view_and_empty_pack():
    packer = TensorPacker([(2, 2), (3,)])
    flat = packer.pack([torch.ones(2, 2), torch.zeros(3)])
    packer.unpack(flat)[1].fill_(5.0)
    assert torch.equal(flat[4:], torch.full((3,), 5.0))
    empty = TensorPacker([])
    assert empty.pack([]).numel() == 0 and empty.bits() == 0


@pytest.mark.parametrize("total,k", [(10, 3), (10, 1), (3, 7), (0, 4), (1001, 16)])
def test_chunk_bounds_match_jax(total, k):
    assert chunk_bounds(total, k) == jax_chunk_bounds(total, k)


def test_single_process_collectives_are_identity():
    x = torch.arange(6.0)
    assert all_reduce_mean(x, None) is x
    assert chunked_all_reduce_mean(x, None, 3) is x


CHUNK_COUNTS = (1, 2, 3, 7, 1001, 5000)


def _exact_sends():
    gen = torch.Generator().manual_seed(4)
    return [[torch.randn(3, 4, generator=gen), torch.randn(7, generator=gen)] for _ in range(2)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two Gloo ranks for both two-rank checks of this module:
    ``{"comm": (rank 0, rank 1), "exact": (rank 0, rank 1)}``."""
    calls = [(comm_rank, (1001, CHUNK_COUNTS)), (exact_rank, (_exact_sends(),))]
    comm, exact = zip(*spawn(run_all, 2, tmp_path_factory.mktemp("ranks"), calls))
    return {"comm": comm, "exact": exact}


def test_chunks_bitwise_equal_one_collective_on_two_ranks(two_ranks):
    """Two Gloo ranks: every K gives the bitwise result of one collective,
    which is the elementwise mean of the two ranks' buffers (a sum of two
    floats does not depend on order, so this pins the chunk engine exactly)."""
    r0, r1 = two_ranks["comm"]
    want = (r0["x"] + r1["x"]) / 2
    for res in (r0, r1):
        assert torch.equal(res["mono"], want)
        assert torch.equal(res["plain"], want)
        for k in CHUNK_COUNTS:
            assert torch.equal(res["chunked"][k], res["mono"]), k


def test_exact_reducer_on_two_ranks(two_ranks):
    sends = _exact_sends()
    for rank, res in enumerate(two_ranks["exact"]):
        for i in range(2):
            torch.testing.assert_close(res["out"][i], (sends[0][i] + sends[1][i]) / 2, rtol=0, atol=0)
            assert torch.count_nonzero(res["mem"][i]) == 0
        assert res["bits"] == 32 * (12 + 7)


def test_world_of_one_creates_a_group(tmp_path):
    """``initialize_distributed`` with one process still makes a (Gloo on
    CPU) group, and tears it down."""
    if dist.is_initialized():
        pytest.skip("a process group already exists in this process")
    group = initialize_distributed(
        DistributedConfig(coordinator_address=f"file://{tmp_path}/rdv"), torch.device("cpu")
    )
    try:
        assert dist.get_world_size(group) == 1 and dist.get_backend(group) == "gloo"
        x = torch.tensor([1.0, 3.0])
        assert torch.equal(all_reduce_mean(x, group), torch.tensor([1.0, 3.0]))
    finally:
        shutdown_distributed()
    assert not dist.is_initialized()


def test_world_of_one_without_an_address_binds_its_own_port():
    """With no address, a world of one gets a localhost store on a port the
    OS picks when the store binds it, group after group in one process."""
    if dist.is_initialized():
        pytest.skip("a process group already exists in this process")
    ports = []
    for _ in range(3):
        group = initialize_distributed(DistributedConfig(), torch.device("cpu"))
        try:
            assert dist.get_world_size(group) == 1 and dist.get_backend(group) == "gloo"
            x = torch.tensor([2.0, -1.0])
            assert torch.equal(all_reduce_mean(x, group), x)
            store = dist.distributed_c10d._get_default_store()
            while isinstance(store, dist.PrefixStore):
                store = store.underlying_store
            ports.append(store.port)
        finally:
            shutdown_distributed()
        assert not dist.is_initialized()
    assert all(p > 0 for p in ports)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
