"""Tests of the PyTorch port that need a CUDA card: the CUDA Gram-Schmidt
kernel against its plain version, and the PowerSGD reducer's ``"auto"``
choice launching it once per shape group.

This file imports torch and the port, never jax, so it also runs on a
machine that has the card and no JAX (``--noconftest`` skips the JAX
harness of ``tests/conftest.py``)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Where there is no card every test here skips.

Tolerance: fp32, rtol = atol = 1e-5, as in ``test_torch_orthogonalize.py``:
the kernel sums each column's squares and projections in another order than
the plain version, and later columns inherit the earlier columns' rounding.
"""

import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu_torch.ops import gram_schmidt as gs
from network_distributed_pytorch_tpu_torch.ops.orthogonalize import orthogonalize
from network_distributed_pytorch_tpu_torch.parallel.reducers import PowerSGDReducer

RTOL = ATOL = 1e-5


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 576, 4), (1, 147, 4), (2, 100, 3), (1, 4608, 32), (64, 4)])
def test_cuda_kernel_matches_plain(cuda_device, shape):
    x = torch.from_numpy(_x(shape, 11)).to(cuda_device)
    launches = gs.KERNEL.launches
    got = gs.gram_schmidt(x)
    torch.cuda.synchronize()
    assert gs.KERNEL.launches == launches + 1
    torch.testing.assert_close(got, orthogonalize(x), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_cuda_kernel_rejects_non_fp32(cuda_device):
    with pytest.raises(TypeError):
        gs.gram_schmidt(torch.zeros((2, 64, 4), dtype=torch.bfloat16, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("n_power_iterations", [0, 1])
def test_auto_reducer_launches_the_kernel_per_shape_group(cuda_device, n_power_iterations):
    """On CUDA tensors ``orthogonalize_impl="auto"`` goes through the kernel,
    once per shape group and power-iteration round, and gives what the plain
    version (``"eager"``) gives."""
    shapes = [(8, 3, 3, 3), (8, 8, 3, 3), (8, 8, 3, 3), (8,), (10, 16), (10,)]
    leaves = [torch.from_numpy(_x(s, 20 + i)).to(cuda_device) for i, s in enumerate(shapes)]
    results = {}
    for impl in ("eager", "auto"):
        reducer = PowerSGDReducer(
            compression_rank=2, matricize="last", orthogonalize_impl=impl,
            n_power_iterations=n_power_iterations,
        )
        launches = gs.KERNEL.launches
        _, out, mem, _ = reducer.reduce(reducer.init(leaves), leaves, None)
        torch.cuda.synchronize()
        results[impl] = (out, mem, gs.KERNEL.launches - launches)
    groups = PowerSGDReducer(compression_rank=2, matricize="last").n_shape_groups(leaves)
    assert results["eager"][2] == 0
    assert results["auto"][2] == groups * (1 + n_power_iterations) == 3 * (1 + n_power_iterations)
    for want, got in zip(results["eager"][0] + results["eager"][1], results["auto"][0] + results["auto"][1]):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
