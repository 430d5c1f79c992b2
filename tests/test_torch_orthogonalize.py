"""The PyTorch port's Gram-Schmidt: its plain version against the JAX
package's XLA version, its Pallas kernel (interpret mode) and the NumPy
oracle; and the wrapper's CPU path. The CUDA kernel against the plain
version is in ``test_torch_cuda.py``, which runs where there is no JAX.

Tolerance: fp32, rtol = atol = 1e-5. The inputs are the same numpy arrays;
the frameworks sum each column's squares and projections in a different
order (a few ulp per sum, ~1e-7 relative), and later columns inherit the
earlier columns' rounding, which stays well inside 1e-5 up to r = 16,
DistilBERT's rank, at the height of its (30522, 768) word table.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.ops import orthogonalize as jax_orthogonalize
from network_distributed_pytorch_tpu.ops.pallas_orthogonalize import orthogonalize_pallas
from network_distributed_pytorch_tpu_torch.ops import _build
from network_distributed_pytorch_tpu_torch.ops import gram_schmidt as gs
from network_distributed_pytorch_tpu_torch.ops.orthogonalize import orthogonalize
from oracle_powersgd import orthogonalize_np
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

RTOL = ATOL = 1e-5
SHAPES = [(64, 4), (256, 8), (128, 1), (100, 3), (768, 16), (30522, 16)]


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_pallas_and_oracle(shape):
    x = _x(shape, sum(shape))
    ours = orthogonalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_orthogonalize(jnp.asarray(x))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ours, np.asarray(orthogonalize_pallas(jnp.asarray(x), interpret=True)), rtol=RTOL, atol=ATOL
    )
    np.testing.assert_allclose(ours, orthogonalize_np(x), rtol=RTOL, atol=ATOL)


def test_stacked_group_matches_per_matrix_jax():
    """A (g=3, 576, 4) shape group, as the reducer stacks it, equals the JAX
    version run on each matrix."""
    x = _x((3, 576, 4), 5)
    ours = gs.gram_schmidt(torch.from_numpy(x)).numpy()
    for j in range(3):
        np.testing.assert_allclose(
            ours[j], np.asarray(jax_orthogonalize(jnp.asarray(x[j]))), rtol=RTOL, atol=ATOL
        )
        np.testing.assert_allclose(ours[j], orthogonalize_np(x[j]), rtol=RTOL, atol=ATOL)


def test_orthonormal_columns_and_input_untouched():
    x = torch.from_numpy(_x((300, 6), 9))
    before = x.clone()
    p = orthogonalize(x)
    assert torch.equal(x, before)
    np.testing.assert_allclose((p.T @ p).numpy(), np.eye(6), atol=1e-5)


def test_wrapper_takes_the_plain_version_on_cpu_without_launching():
    x = torch.from_numpy(_x((2, 64, 4), 1))
    launches = gs.KERNEL.launches
    assert torch.equal(gs.gram_schmidt(x), orthogonalize(x))
    assert gs.KERNEL.launches == launches


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        gs.gram_schmidt(torch.empty((4, 2), device="meta"))


def test_build_failure_raises(monkeypatch, tmp_path):
    """Without nvcc the kernel cannot be built, and loading it raises: there
    is no silent fallback to the plain version."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("gram_schmidt")
