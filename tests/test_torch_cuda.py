"""Tests of the PyTorch port that need a CUDA card: the CUDA Gram-Schmidt
kernel (with the route and cluster size it takes for the word table's
height and for small matrices), the fused PowerSGD kernels
(``ops/powersgd.py``: ragged and misaligned stacks, K3's P-hat equal to the
Gram-Schmidt kernel's bit for bit, two launches giving the same bits) and
the flash attention kernels, forward and backward
(``ops/flash_attention.py``, fp32 and bf16, with left padding, a lone real
key, a ragged T, GPT's causal T = 1024 and NaN in the key tiles they must
skip; the backward also through ``torch.autograd`` with the mask's
gradient, and two calls bitwise equal) against their plain versions, the
bf16 and fp32 backwards' warpgroup (``wgmma``) routes at ragged T and
D <= 64, one product of each bf16 and TF32 ``wgmma`` form against
``a @ b``, what the tensor cores take of an fp32 operand, how far a 3xTF32
chain drifts, and ``HGMMA`` in the SASS of both routes' kernels, the
PowerSGD reducer launching its kernels once per shape group,
DistilBERT launching flash attention once per layer, exact-DDP steps of the
small ResNet-18 on the card against the CPU, the single-node IMDb
baseline running flash attention (forward and backward) on the card, the
tiny GPT training (K5 causal forward and backward, fp32 and bf16) and
generating on the card, the gather-based compressors on the card against
the CPU (TopK's scatter-add bitwise equal across two calls), a DiLoCo
round of the small ResNet-18 with K1 against its plain twin, the paged KV
ops on the card against the CPU (positions past the table included), and
the tiny GPT served on the card by the slot and paged engines (and under
speculative decoding) with the same tokens, a checkpointed resume of the
small ResNet-18 on the card bit for bit under deterministic algorithms,
a checkpoint written from CPU tensors restored onto the card, K5
causal at GPT-2 small's width inside a pipeline stage and inside a
one-rank MoE block, each against the same module on the CPU (K5's plain
versions), the FSDP step of a SmallCNN over a one-rank NCCL group bit
for bit the DDP step (monolithic and chunked), a remat step of the tiny
GPT and DistilBERT (K5's forward twice a layer) and a ``scan_layers`` GPT
bit for bit the plain ones, K1 at GPT-2 small's stacked shape groups, and
the small ResNet-18 in bf16 on the fused pipeline against the xla one.

This file imports torch and the port, never jax, so it also runs on a
machine that has the card and no JAX (``--noconftest`` skips the JAX
harness of ``tests/conftest.py``)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Where there is no card every test here skips, but for
``test_serve_gpt_runs_on_the_card_or_raises_without_one``, which checks
there that ``serve_gpt.run`` raises rather than serve on the CPU.

Tolerance: fp32, rtol = atol = 1e-5, as in ``test_torch_orthogonalize.py``:
the kernel sums each column's squares and projections in another order than
the plain version, and later columns inherit the earlier columns' rounding.
The fused kernels' products (P, Q, out, mem) are held to
``1e-5 * max(1, max|plain|)``: sums of up to n or m terms in another order;
M = G + E is one rounded add, so it must be bitwise equal. Flash attention:
out within ``1e-5 * max(1, max|plain|)`` and lse within 1e-5 relative (fp32
sums over the keys in another order, the kernel in 64-key tiles); a fully
masked row exactly 0 with lse 1e30. A bf16 out: that bound plus 1 bf16 ulp
of the element (both sides sum in fp32 and round once). The backward's
gradients are held like out: fp32 within ``1e-5 * max(1, max|plain|)``,
bf16 that plus 1 bf16 ulp; the mask's gradient (fp32) like an fp32 one.
"""

import ctypes
import os
import subprocess
from dataclasses import replace as dataclass_replace

import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu_torch.data.cifar10 import load_cifar10_or_synthetic
from network_distributed_pytorch_tpu_torch.experiments import (
    diloco_cifar10,
    exact_cifar10,
    gpt_generate,
    gpt_lm,
    imdb_baseline,
    powersgd_cifar10,
)
from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches, image_classifier_loss
from network_distributed_pytorch_tpu_torch.models import gpt
from network_distributed_pytorch_tpu_torch.models.cnn import SmallCNN
from network_distributed_pytorch_tpu_torch.models.distilbert import distilbert_tiny
from network_distributed_pytorch_tpu_torch.ops import _build
from network_distributed_pytorch_tpu_torch.ops import flash_attention as fa
from network_distributed_pytorch_tpu_torch.ops import gram_schmidt as gs
from network_distributed_pytorch_tpu_torch.ops import powersgd as ps
from network_distributed_pytorch_tpu_torch.ops.orthogonalize import orthogonalize
from network_distributed_pytorch_tpu_torch.parallel import compression
from network_distributed_pytorch_tpu_torch.parallel.fsdp import make_fsdp_train_step
from network_distributed_pytorch_tpu_torch.parallel.localsgd import make_diloco_train_fn
from network_distributed_pytorch_tpu_torch.parallel.mesh import (
    DistributedConfig,
    initialize_distributed,
    shutdown_distributed,
)
from network_distributed_pytorch_tpu_torch.parallel.reducers import (
    ExactReducer,
    PowerSGDReducer,
    embedding_leaves,
    layer_stacked_leaves,
)
from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step
from network_distributed_pytorch_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

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
@pytest.mark.parametrize(
    "shape,route",
    [((1, 30522, 16), "on_chip"), ((1, 30522, 32), "streaming"), ((1, 30523, 16), "on_chip"),
     ((25, 768, 16), "on_chip"), ((1, 17, 16), "on_chip")],
)
def test_cuda_kernel_routes_tall_and_small_matrices(cuda_device, shape, route):
    """The word table's height (and one more row) is split over a cluster of
    CTAs with P in their shared memory; at r = 32 it does not fit even at 16
    CTAs and streams; the small matrices take one CTA each."""
    x = torch.from_numpy(_x(shape, 12)).to(cuda_device)
    got = gs.gram_schmidt(x)
    torch.cuda.synchronize()
    assert gs.KERNEL.last_route == route
    if shape[1] > 30000:
        assert gs.KERNEL.last_cluster > 1
    else:
        assert gs.KERNEL.last_cluster == 1
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


def _close_scaled(got, want):
    tol = 1e-5 * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


def _stack(shape, seed, dev, misalign=None):
    """A contiguous (g, rows, cols) stack. ``misalign="stack"``: ``x[1:]`` of a
    (g + 1, rows, cols) stack; ``"flat"``: a view of a flat buffer one float
    in, so its data_ptr is 4-byte aligned only (with cols % 4 == 0 the only
    way to reach the kernels' scalar loads)."""
    if misalign == "stack":
        return torch.from_numpy(_x((shape[0] + 1, *shape[1:]), seed)).to(dev)[1:]
    if misalign == "flat":
        flat = torch.from_numpy(_x((int(np.prod(shape)) + 1,), seed)).to(dev)
        return flat[1:].view(shape)
    return torch.from_numpy(_x(shape, seed)).to(dev)


def _case_id(case):
    return "-".join(str(v) for v in case if v is not None)


# (g, n, m, r, misalign): m % 4 in {1, 2, 3} (m = 10 is the ResNet fc
# group), misaligned stacks, r in {1, 4, 8, 32, 40}, the two largest ResNet
# groups, and n below one row group of the kernels (K3: with n >= r, since
# past a matrix's rank Gram-Schmidt normalises rounding noise)
_EF_CASES = [
    (1, 64, 32, 4, None), (3, 100, 37, 8, None), (2, 5, 3, 2, None), (2, 6, 9, 1, None),
    (3, 4608, 512, 4, None), (1, 512, 2048, 40, None), (1, 2048, 10, 4, None), (2, 50, 10, 4, None),
    (2, 70, 7, 3, None), (3, 33, 65, 4, "stack"), (3, 40, 256, 4, "flat"), (2, 300, 256, 1, None),
    (2, 300, 256, 32, None), (36, 2304, 256, 4, None), (2, 3, 256, 4, None), (3, 2, 64, 4, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,m,r,misalign", _EF_CASES, ids=[_case_id(c) for c in _EF_CASES])
def test_fused_ef_compress_matches_plain(cuda_device, g, n, m, r, misalign):
    grads = _stack((g, n, m), 1, cuda_device, misalign)
    resid = _stack((g, n, m), 2, cuda_device, misalign)
    q = _stack((g, m, r), 3, cuda_device)
    if misalign == "flat":
        assert grads.data_ptr() % 16 and resid.data_ptr() % 16
    launches = (ps.EF_COMPRESS.launches, ps.COMPRESS.launches)
    m_out, p = ps.fused_ef_compress(grads, q, resid)
    m_plain, p_plain = ps.ef_compress_reference(grads, q, resid)
    # K2b on the misaligned grads themselves, else on K2a's M
    src = grads if misalign else m_out
    same, p2 = ps.fused_ef_compress(src, q)
    torch.cuda.synchronize()
    assert (ps.EF_COMPRESS.launches, ps.COMPRESS.launches) == (launches[0] + 1, launches[1] + 1)
    assert torch.equal(m_out, m_plain)
    assert same is src
    _close_scaled(p, p_plain)
    _close_scaled(p2, ps.compress_reference(src, q))


# (g, n, m, r, misalign, route)
_OP_CASES = [
    (1, 64, 32, 4, None, "one_launch"), (2, 100, 37, 8, None, "one_launch"), (2, 6, 9, 1, None, "one_launch"),
    (3, 4608, 512, 4, None, "one_launch"), (1, 4608, 512, 32, None, "two_launch"),
    (1, 2048, 70, 40, None, "two_launch"), (1, 2048, 10, 4, None, "one_launch"), (2, 70, 7, 3, None, "one_launch"),
    (2, 50, 10, 4, None, "one_launch"), (3, 33, 65, 4, "stack", "one_launch"), (3, 40, 256, 4, "flat", "one_launch"),
    (1, 500, 64, 32, None, "one_launch"), (36, 2304, 256, 4, None, "one_launch"), (2, 5, 256, 4, None, "one_launch"),
    (1, 147, 64, 4, None, "one_launch"), (2, 1500, 33, 16, "flat", "one_launch"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,m,r,misalign,route", _OP_CASES, ids=[_case_id(c) for c in _OP_CASES])
def test_fused_orthogonalize_project_matches_plain(cuda_device, g, n, m, r, misalign, route):
    p, mat = _stack((g, n, r), 6, cuda_device, misalign), _stack((g, n, m), 7, cuda_device, misalign)
    launches = ps.ORTHOGONALIZE_PROJECT.launches
    phat, q = ps.fused_orthogonalize_project(p, mat)
    torch.cuda.synchronize()
    assert ps.ORTHOGONALIZE_PROJECT.launches == launches + 1
    assert ps.ORTHOGONALIZE_PROJECT.last_route == route
    phat_plain, q_plain = ps.orthogonalize_project_reference(p, mat)
    torch.testing.assert_close(phat, phat_plain, rtol=0, atol=1e-5)
    _close_scaled(q, q_plain)
    # both routes give K1's P-hat bit for bit: the two-launch route launches
    # K1, the one-launch route runs K1's per-CTA code where K1 takes one CTA
    assert torch.equal(phat, gs.gram_schmidt(p.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "g,n,m,r", [(36, 2304, 256, 4), (3, 4608, 512, 4), (1, 2048, 10, 4), (1, 4608, 512, 32), (2, 300, 256, 40)]
)
def test_redesigned_kernels_are_deterministic(cuda_device, g, n, m, r):
    """Two launches of K2a, K2b and K3 on the same inputs give the same bits:
    every sum runs in a fixed order, with no float atomics."""
    grads, resid = _stack((g, n, m), 13, cuda_device), _stack((g, n, m), 14, cuda_device)
    q = _stack((g, m, r), 15, cuda_device)
    runs = []
    for _ in range(2):
        m_out, p = ps.fused_ef_compress(grads, q, resid)
        runs.append([m_out, p, ps.fused_ef_compress(grads, q)[1], *ps.fused_orthogonalize_project(p, m_out)])
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,m,r", [(1, 64, 32, 4), (3, 100, 37, 8), (2, 5, 3, 2), (3, 4608, 512, 4), (2, 70, 45, 40)])
def test_fused_decompress_residual_matches_plain(cuda_device, g, n, m, r):
    p, q, mat = _stack((g, n, r), 10, cuda_device), _stack((g, m, r), 11, cuda_device), _stack((g, n, m), 12, cuda_device)
    launches = ps.DECOMPRESS_RESIDUAL.launches
    out, mem = ps.fused_decompress_residual(p, q, mat)
    torch.cuda.synchronize()
    assert ps.DECOMPRESS_RESIDUAL.launches == launches + 1
    out_plain, mem_plain = ps.decompress_residual_reference(p, q, mat)
    _close_scaled(out, out_plain)
    _close_scaled(mem, mem_plain)


@pytest.mark.cuda
def test_fused_kernels_refuse_non_fp32(cuda_device):
    bf = dict(dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(TypeError):
        ps.fused_ef_compress(torch.zeros((1, 8, 4), **bf), torch.zeros((1, 4, 2), **bf), torch.zeros((1, 8, 4), **bf))
    with pytest.raises(TypeError):
        ps.fused_orthogonalize_project(torch.zeros((1, 8, 2), **bf), torch.zeros((1, 8, 4), **bf))
    with pytest.raises(TypeError):
        ps.fused_decompress_residual(torch.zeros((1, 8, 2), **bf), torch.zeros((1, 4, 2), **bf), torch.zeros((1, 8, 4), **bf))
    with pytest.raises(ValueError):  # one operand on the CPU
        ps.fused_decompress_residual(torch.zeros((1, 8, 2)), torch.zeros((1, 4, 2), device=cuda_device), torch.zeros((1, 8, 4), device=cuda_device))


@pytest.mark.cuda
def test_fused_reducer_launches_each_kernel_per_shape_group(cuda_device):
    """A fused ``reduce_ef`` on CUDA tensors launches K2a, K3 and K4 once per
    shape group, K2b and K1 never, and gives what the ``"xla"`` path gives."""
    shapes = [(8, 3, 3, 3), (8, 8, 3, 3), (8, 8, 3, 3), (8,), (10, 16), (10,), (2, 3)]
    grads = [torch.from_numpy(_x(s, 30 + i)).to(cuda_device) for i, s in enumerate(shapes)]
    mems = [torch.from_numpy(0.3 * _x(s, 40 + i)).to(cuda_device) if len(s) > 1 else torch.zeros(s, device=cuda_device) for i, s in enumerate(shapes)]
    results = {}
    for impl in ("xla", "pallas"):
        reducer = PowerSGDReducer(compression_rank=4, matricize="last", compress_impl=impl)
        kernels = (ps.EF_COMPRESS, ps.COMPRESS, ps.ORTHOGONALIZE_PROJECT, ps.DECOMPRESS_RESIDUAL, gs.KERNEL)
        before = [k.launches for k in kernels]
        state, out, mem, bits = reducer.reduce_ef(reducer.init(grads), grads, mems, None)
        torch.cuda.synchronize()
        results[impl] = (out, mem, bits, state.q_memory, [k.launches - b for k, b in zip(kernels, before)])
    groups = PowerSGDReducer(compression_rank=4, matricize="last").n_shape_groups(grads)
    assert groups == 4  # (8, 3, 3, 3), the two (8, 8, 3, 3), (10, 16), (2, 3)
    assert results["pallas"][4] == [groups, 0, groups, groups, 0]
    assert results["xla"][4] == [0, 0, 0, 0, groups]
    assert results["pallas"][2] == results["xla"][2]
    for want, got in zip(results["xla"][0] + results["xla"][1], results["pallas"][0] + results["pallas"][1]):
        _close_scaled(got, want)
    _close_scaled(results["pallas"][3], results["xla"][3])


def _attention_inputs(bh, t, d, h, dev, seed=50):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(bh, t, d).astype(np.float32)).to(dev) for _ in range(3))
    mask = np.zeros((bh // h, t), np.float32)
    mask[0, :] = np.finfo(np.float32).min  # a fully masked row
    if bh // h > 1:
        mask[1, t // 3 :] = -1e30  # a padded tail
    return q, k, v, torch.from_numpy(mask).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,t,h,d,causal", [(4, 256, 12, 64, False), (2, 128, 4, 64, True), (3, 100, 2, 40, False), (2, 64, 2, 128, True)]
)
def test_flash_attention_kernel_matches_plain(cuda_device, b, t, h, d, causal):
    q, k, v, mask = _attention_inputs(b * h, t, d, h, cuda_device)
    launches = fa.KERNEL.launches
    out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, 128, 128, d**-0.5)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == launches + 1
    block = t if t % 64 else 64
    want_out, want_lse = fa.flash_attention_reference(q, k, v, mask, causal, block, block, d**-0.5)
    _close_scaled(out, want_out)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert torch.all(out[:h] == 0.0) and torch.all(lse[:h] == 1e30)


def _padded_mask(b, t, cases, dev):
    """A (b, t) additive mask, 0 on the keys ``cases[i]`` (a slice or a list
    of positions) of row i and finfo(f32).min elsewhere."""
    mask = np.full((b, t), np.finfo(np.float32).min, np.float32)
    for i, keys in enumerate(cases):
        mask[i, keys] = 0.0
    return torch.from_numpy(mask).to(dev)


# b, t, h, d, causal, the real keys of each batch row
_PADDING_CASES = {
    "left_padding": (2, 256, 3, 64, False, [slice(214, 256), slice(192, 256)]),
    "lone_middle_key": (2, 256, 3, 64, False, [[100], slice(0, 20)]),
    "ragged_t100": (2, 100, 3, 64, False, [slice(0, 30), slice(70, 100)]),
    "d128_causal_padded": (2, 256, 2, 128, True, [slice(0, 42), slice(0, 200)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_PADDING_CASES))
def test_flash_attention_kernel_padding_layouts(cuda_device, case):
    """Real keys only in the last tile, one real key inside a padded tile, a
    ragged last tile and causal with padding: each tile that holds a real
    key is walked, whatever its place."""
    b, t, h, d, causal, keys = _PADDING_CASES[case]
    q, k, v, _ = _attention_inputs(b * h, t, d, h, cuda_device, seed=52)
    mask = _padded_mask(b, t, keys, cuda_device)
    out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, 128, 128, d**-0.5)
    torch.cuda.synchronize()
    block = t if t % 64 else 64
    want_out, want_lse = fa.flash_attention_reference(q, k, v, mask, causal, block, block, d**-0.5)
    _close_scaled(out, want_out)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_kernel_skips_all_padding_tiles(cuda_device, causal):
    """NaN in K and V of every 64-key tile that holds only padding leaves out
    and lse bitwise as on the clean inputs: those tiles are not read."""
    b, t, h, d = 3, 256, 2, 64
    q, k, v, _ = _attention_inputs(b * h, t, d, h, cuda_device, seed=53)
    mask = _padded_mask(b, t, [slice(0, 42), [5, 130], slice(0, 256)], cuda_device)
    clean = fa.flash_attention_fwd(q, k, v, mask, causal, 128, 128, d**-0.5)
    empty = (mask.view(b, t // 64, 64) <= -1e29).all(-1).repeat_interleave(h, 0)  # (BH, tiles)
    assert empty.any()
    poison = empty.repeat_interleave(64, 1)[..., None]
    kp, vp = (torch.where(poison, float("nan"), x) for x in (k, v))
    dirty = fa.flash_attention_fwd(q, kp, vp, mask, causal, 128, 128, d**-0.5)
    torch.cuda.synchronize()
    assert torch.equal(dirty[0], clean[0]) and torch.equal(dirty[1], clean[1])
    want_out, want_lse = fa.flash_attention_reference(q, k, v, mask, causal, 64, 64, d**-0.5)
    _close_scaled(clean[0], want_out)
    torch.testing.assert_close(clean[1], want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_flash_attention_refuses_non_fp32(cuda_device):
    """The kernel takes q, k, v all fp32 or all bf16: fp16, or a mix,
    raises (the JAX kernel takes any float dtype)."""
    half = torch.zeros((1, 16, 2, 8), dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError):
        fa.flash_attention(half, half, half)
    bf, f32 = (torch.zeros((2, 16, 8), dtype=dt, device=cuda_device) for dt in (torch.bfloat16, torch.float32))
    mask = torch.zeros((1, 16), device=cuda_device)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(bf, f32, f32, mask, False, 16, 16, 0.3)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(bf, bf, bf, mask.to(torch.bfloat16), False, 16, 16, 0.3)


def _bf16_ulp(x):
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), (e - 8).clamp_min(-133))


def _close_bf16(got, want):
    """A bf16 out: both sides sum in fp32 (to fp32's 1e-5 of the largest
    |out|) and round once, so at most that plus 1 bf16 ulp of the element."""
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    bound = 1e-5 * max(1.0, want.float().abs().max().item()) + _bf16_ulp(want)
    assert bool((err <= bound).all()), f"max err {err.max().item()}"


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,t,h,d,causal,padded",
    [(4, 256, 12, 64, False, True), (2, 1024, 4, 64, True, False), (3, 100, 2, 40, False, True),
     (2, 64, 2, 128, True, True), (2, 256, 2, 128, True, False), (2, 200, 2, 64, True, True)],
)
def test_flash_attention_bf16_kernel_matches_plain(cuda_device, b, t, h, d, causal, padded):
    """K5 on bf16 q, k, v against its plain version on the same bf16
    inputs: masked, causal (GPT's T = 1024, and a ragged T = 200 whose q
    tiles run last first), a ragged T, D = 40 and 128; out in bf16 with no
    fp32 copy of the inputs, lse in fp32."""
    q, k, v, mask = _attention_inputs(b * h, t, d, h, cuda_device, seed=54)
    if not padded:
        mask = torch.zeros_like(mask)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    launches = fa.KERNEL_BF16.by_kind["causal" if causal else "masked"]
    out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, 128, 128, d**-0.5)
    torch.cuda.synchronize()
    assert fa.KERNEL_BF16.by_kind["causal" if causal else "masked"] == launches + 1
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    block = t if t % 64 else 64
    want_out, want_lse = fa.flash_attention_reference(q, k, v, mask, causal, block, block, d**-0.5)
    _close_bf16(out, want_out)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    if padded:
        assert torch.all(out[:h] == 0.0) and torch.all(lse[:h] == 1e30)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bf16_kernel_skips_all_padding_tiles(cuda_device, causal):
    """NaN in bf16 K and V of every all-padding tile changes nothing."""
    b, t, h, d = 3, 256, 2, 64
    q, k, v, _ = _attention_inputs(b * h, t, d, h, cuda_device, seed=55)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    mask = _padded_mask(b, t, [slice(0, 42), [5, 130], slice(0, 256)], cuda_device)
    clean = fa.flash_attention_fwd(q, k, v, mask, causal, 128, 128, d**-0.5)
    empty = (mask.view(b, t // 64, 64) <= -1e29).all(-1).repeat_interleave(h, 0)
    poison = empty.repeat_interleave(64, 1)[..., None]
    kp, vp = (torch.where(poison, float("nan"), x) for x in (k, v))
    dirty = fa.flash_attention_fwd(q, kp, vp, mask, causal, 128, 128, d**-0.5)
    torch.cuda.synchronize()
    assert torch.equal(dirty[0], clean[0]) and torch.equal(dirty[1], clean[1])
    want_out, _ = fa.flash_attention_reference(q, k, v, mask, causal, 64, 64, d**-0.5)
    _close_bf16(clean[0], want_out)


def _close_grad(got, want):
    """A gradient of the backward kernel against the plain version's: fp32
    within 1e-5 * max(1, max|plain|), bf16 that plus 1 bf16 ulp."""
    if want.dtype == torch.bfloat16:
        _close_bf16(got, want)
    else:
        _close_scaled(got, want)


# b, t, h, d, causal, the real keys of each batch row (None: the padded
# mask of _attention_inputs, with a fully masked row; "none": no mask)
_BWD_CASES = {
    "padded": (4, 256, 12, 64, False, None),
    "gpt_causal_1024": (2, 1024, 4, 64, True, "none"),
    "ragged_t100_d40": (3, 100, 2, 40, False, None),
    "d128_causal_padded": (2, 256, 2, 128, True, None),
    "left_padding": (2, 256, 3, 64, False, [slice(214, 256), slice(192, 256)]),
    # two real keys, each alone in its tile (a row with a single real key has
    # dq = dk = 0 exactly, where both fp32 versions return rounding noise)
    "lone_middle_keys": (2, 256, 3, 64, False, [[100, 230], slice(0, 20)]),
}


def _bwd_case(case, dtype, dev, seed=60):
    b, t, h, d, causal, keys = _BWD_CASES[case]
    q, k, v, mask = _attention_inputs(b * h, t, d, h, dev, seed=seed)
    if keys == "none":
        mask = torch.zeros_like(mask)
    elif keys is not None:
        mask = _padded_mask(b, t, keys, dev)
    do = torch.from_numpy(np.random.RandomState(seed + 1).randn(b * h, t, d).astype(np.float32)).to(dev)
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, 128, 128, d**-0.5)
    return (q, k, v, mask, out, lse, do), causal, h, d


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(_BWD_CASES))
def test_flash_attention_bwd_kernel_matches_plain(cuda_device, case, dtype):
    """K5's backward kernel against ``flash_attention_bwd`` on the same
    inputs and the forward kernel's own out and lse: dq, dk, dv in the
    heads' dtype, one launch a call, two calls bitwise equal, and a fully
    masked head's gradients exactly 0."""
    args, causal, h, d = _bwd_case(case, dtype, cuda_device)
    kernel = fa.BWD_KERNELS[dtype]
    launches = kernel.by_kind["causal" if causal else "masked"]
    got = fa.flash_attention_vjp(*args, causal, 128, d**-0.5, False)
    again = fa.flash_attention_vjp(*args, causal, 128, d**-0.5, False)
    torch.cuda.synchronize()
    assert kernel.by_kind["causal" if causal else "masked"] == launches + 2
    assert got[3] is None
    block = args[0].shape[1] if args[0].shape[1] % 64 else 64
    want = fa.flash_attention_bwd(*args, causal, block, d**-0.5, need_dmask=False)
    for g, a, w in zip(got[:3], again[:3], want[:3]):
        assert g.dtype == dtype and torch.equal(g, a)
        _close_grad(g, w)
    empty = (args[3] <= -1e29).all(dim=1).repeat_interleave(h)
    for g in got[:3]:
        assert torch.all(g[empty] == 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bwd_kernel_skips_all_padding_tiles(cuda_device, causal, dtype):
    """NaN in K and V of every 64-key tile that holds only padding leaves dq
    and the real keys' dk and dv bitwise unchanged: those tiles are not
    read; every padded key's dk and dv is exactly 0."""
    b, t, h, d = 3, 256, 2, 64
    q, k, v, _ = _attention_inputs(b * h, t, d, h, cuda_device, seed=61)
    mask = _padded_mask(b, t, [slice(0, 42), [5, 130], slice(0, 256)], cuda_device)
    do = torch.randn((b * h, t, d), generator=torch.Generator().manual_seed(62)).to(cuda_device)
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, 128, 128, d**-0.5)
    clean = fa.flash_attention_vjp(q, k, v, mask, out, lse, do, causal, 128, d**-0.5, False)
    empty = (mask.view(b, t // 64, 64) <= -1e29).all(-1).repeat_interleave(h, 0)
    assert empty.any()
    poison = empty.repeat_interleave(64, 1)[..., None]
    kp, vp = (torch.where(poison, float("nan"), x) for x in (k, v))
    dirty = fa.flash_attention_vjp(q, kp, vp, mask, out, lse, do, causal, 128, d**-0.5, False)
    torch.cuda.synchronize()
    real = (mask > -1e29).repeat_interleave(h, 0)
    assert torch.equal(dirty[0], clean[0])
    for x, y in zip(dirty[1:3], clean[1:3]):
        assert torch.equal(x[real], y[real])
        assert torch.all(x[~real] == 0.0) and torch.all(y[~real] == 0.0)
    want = fa.flash_attention_bwd(q, k, v, mask, out, lse, do, causal, 64, d**-0.5, need_dmask=False)
    for g, w in zip(clean[:3], want[:3]):
        _close_grad(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_autograd_on_the_card_matches_plain(cuda_device, causal, dtype):
    """``torch.autograd`` through ``flash_attention`` on the card runs the
    forward and backward kernels once each and gives the plain backward's
    gradients in q, k, v and the mask (the mask's in fp32)."""
    b, t, h, d = 2, 192, 3, 64
    rng = np.random.RandomState(63)
    q, k, v, w = (torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32)).to(cuda_device) for _ in range(4))
    q, k, v, w = (x.to(dtype) for x in (q, k, v, w))
    mask = torch.zeros((b, t), device=cuda_device)
    mask[1, 150:] = -1e30
    mask[0, 7] = -0.5  # a real key with a nonzero additive mask
    leaves = [x.clone().requires_grad_() for x in (q, k, v, mask)]
    kernels = (fa.KERNELS[dtype], fa.BWD_KERNELS[dtype])
    before = [x.launches for x in kernels]
    out = fa.flash_attention(*leaves[:3], leaves[3], causal=causal, block_q=64, block_k=64)
    (out.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    assert [x.launches - n for x, n in zip(kernels, before)] == [1, 1]

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()

    qf, kf, vf, do = fold(q), fold(k), fold(v), fold(w)
    fout, lse = fa.flash_attention_fwd(qf, kf, vf, mask, causal, 64, 64, d**-0.5)
    want = fa.flash_attention_bwd(qf, kf, vf, mask, fout, lse, do, causal, 64, d**-0.5, need_dmask=True)
    for leaf, wg in zip(leaves[:3], want[:3]):
        _close_grad(fold(leaf.grad), wg)
    assert leaves[3].grad.dtype == torch.float32
    _close_scaled(leaves[3].grad, want[3])


@pytest.mark.cuda
def test_flash_attention_bwd_refuses_other_dtypes(cuda_device):
    """The backward kernel takes q, k, v, out and dO all fp32 or all bf16:
    fp16, a mix of heads, or a dO of another dtype than out raises before
    any launch."""
    dev = cuda_device
    mask, lse = torch.zeros((1, 16), device=dev), torch.zeros((2, 16), device=dev)

    def heads(dtype):
        return torch.zeros((2, 16, 8), dtype=dtype, device=dev)

    f32, bf, half = heads(torch.float32), heads(torch.bfloat16), heads(torch.float16)
    launches = {k: v.launches for k, v in fa.BWD_KERNELS.items()}
    for args in (
        (half, half, half, mask, half, lse, half),
        (bf, f32, f32, mask, f32, lse, f32),
        (f32, f32, f32, mask, f32, lse, bf),
        (bf, bf, bf, mask, bf, lse, f32),
    ):
        with pytest.raises(TypeError):
            fa.flash_attention_vjp(*args, False, 16, 0.3, False)
    assert {k: v.launches for k, v in fa.BWD_KERNELS.items()} == launches


def _bwd_library():
    """The backward library, built on first use, and its path."""
    return _build.load("flash_attention_bwd"), _build.library_path("flash_attention_bwd")


@pytest.mark.cuda
@pytest.mark.parametrize("rs", [0, 1], ids=["a_shared", "a_registers"])
@pytest.mark.parametrize("trans_b", [0, 1], ids=["b_k_major", "b_mn_major"])
def test_wgmma_product_matches_matmul(cuda_device, rs, trans_b):
    """One 64 x 64 x 64 warpgroup product of the backward library's
    self-test, A from swizzled shared memory or registers, B K-major or
    MN-major (the transpose bit): the descriptors and fragment layouts the
    bf16 backward kernels use. Small integers make every product and sum
    exact, so the result must equal ``a @ b`` bit for bit."""
    lib, _ = _bwd_library()
    fn = lib.flash_bwd_wgmma_selftest
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rng = np.random.RandomState(70 + 2 * rs + trans_b)
    a, b = (torch.from_numpy(rng.randint(-8, 9, (64, 64)).astype(np.float32)).to(cuda_device) for _ in range(2))
    a16, b16 = a.bfloat16(), b.bfloat16()
    c = torch.full((64, 64), float("nan"), device=cuda_device)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    assert fn(a16.data_ptr(), b16.data_ptr(), c.data_ptr(), rs, trans_b, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(c, a @ b)


@pytest.mark.cuda
def test_flash_attention_bwd_bf16_kernels_use_wgmma(cuda_device):
    """The bf16 backward's kernels for D <= 64 (dK/dV and dQ, each named
    ``flash_bwd_..._wgmma``) hold HGMMA, the warpgroup product, in the SASS
    of the built library; the mma.sync kernels (fp32, and bf16 at D > 64)
    hold none."""
    _, path = _bwd_library()
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", path], capture_output=True, text=True, check=True).stdout
    functions = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        functions[name.strip()] = body
    bwd = {name: body for name, body in functions.items() if "flash_bwd" in name}
    for kernel in ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel"):
        found = [name for name in bwd if kernel in name]
        assert len(found) == 1, (kernel, sorted(bwd))
        assert "HGMMA" in bwd[found[0]], kernel
    plain = [name for name in bwd if "wgmma" not in name and ("dkdv" in name or "dq" in name)]
    assert plain and not any("HGMMA" in bwd[name] for name in plain)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["masked", "causal"])
@pytest.mark.parametrize("d", [36, 40, 64])
@pytest.mark.parametrize("t", [100, 130])
def test_flash_attention_bwd_bf16_wgmma_route(cuda_device, t, d, causal):
    """The bf16 backward's warpgroup kernels (D <= 64) on a ragged T, D = 40
    (16-byte rows), 36 (rows copied element by element) and 64, masked and
    causal, with a fully masked row and a row whose later key tiles are all
    padding, against ``flash_attention_bwd``; two calls bitwise equal, one
    launch a call under its kind, a fully masked head's gradients 0."""
    b, h = 3, 2
    q, k, v, _ = _attention_inputs(b * h, t, d, h, cuda_device, seed=64)
    mask = _padded_mask(b, t, [slice(0, t), [], slice(0, 30)], cuda_device)
    do = torch.randn((b * h, t, d), generator=torch.Generator().manual_seed(65)).to(cuda_device)
    q, k, v, do = (x.bfloat16() for x in (q, k, v, do))
    out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, 128, 128, d**-0.5)
    kernel, kind = fa.BWD_KERNELS[torch.bfloat16], "causal" if causal else "masked"
    launches = kernel.by_kind[kind]
    got = fa.flash_attention_vjp(q, k, v, mask, out, lse, do, causal, 128, d**-0.5, False)
    again = fa.flash_attention_vjp(q, k, v, mask, out, lse, do, causal, 128, d**-0.5, False)
    torch.cuda.synchronize()
    assert kernel.by_kind[kind] == launches + 2
    want = fa.flash_attention_bwd(q, k, v, mask, out, lse, do, causal, t, d**-0.5, need_dmask=False)
    empty = (mask <= -1e29).all(dim=1).repeat_interleave(h)
    for g, a, w in zip(got[:3], again[:3], want[:3]):
        assert torch.equal(g, a)
        _close_grad(g, w)
        assert torch.all(g[empty] == 0.0)


def _tf32(x):
    """x's TF32 value as the tensor cores take it: each fp32's low 13 bits
    cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mode,k", [(0, 64), (1, 64), (0, 128), (1, 8), (2, 64), (3, 8), (3, 32), (3, 64), (3, 128)],
    ids=["ss", "rs", "ss_k128", "rs_k8", "nn_permuted", "nt_chain3", "nt_chain12", "nt_chain24", "nt_chain48"],
)
def test_wgmma_tf32_products_match_matmul(cuda_device, mode, k):
    """The TF32 warpgroup products of the backward library's self-test on
    small integers, exact in every form, so the result must equal
    ``a @ b`` bit for bit: one pass with A from shared memory (ss) or
    registers (rs); the fp32 kernels' register-A product with A read as
    accumulator fragments and B split and transposed into the permuted k
    order (nn_permuted); their 3xTF32 shared-memory product over 1 to 16 k8
    steps (nt_chain*)."""
    rng = np.random.RandomState(80 + mode + k)
    a, b = (torch.from_numpy(rng.randint(-8, 9, shape).astype(np.float32)).to(cuda_device) for shape in ((64, k), (k, 64)))
    c = fa.wgmma_tf32_selftest(a, b, mode)
    torch.cuda.synchronize()
    assert torch.equal(c, a @ b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1], ids=["a_shared", "a_registers"])
def test_wgmma_tf32_ignores_the_low_13_bits(cuda_device, mode):
    """The tensor cores take an fp32 operand's top 19 bits and ignore the
    low 13 (they truncate, never round): what the fp32 kernels assume when
    they feed a tile as it arrived as its own hi part and lo = x - hi. With
    B the identity each output is A's element as the tensor cores took it,
    and with A the identity B's."""
    rng = np.random.RandomState(81)
    x = torch.from_numpy((1.0 + rng.randint(1, 2**13, (64, 64)) * 2.0**-23).astype(np.float32)).to(cuda_device)
    x[0, 0] = 1 + 2**-11 + 2**-20  # rounds up to 1 + 2^-10, truncates to 1
    eye = torch.eye(64, device=cuda_device)
    got_a, got_b = fa.wgmma_tf32_selftest(x, eye, mode), fa.wgmma_tf32_selftest(eye, x, mode)
    torch.cuda.synchronize()
    assert torch.equal(got_a, _tf32(x)) and torch.equal(got_b, _tf32(x))
    assert got_a[0, 0].item() == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 32, 64, 128], ids=["chain3", "chain12", "chain24", "chain48"])
def test_wgmma_tf32_chain_drift_stays_small(cuda_device, k):
    """A chain of 3 k / 8 TF32 passes into one accumulator (the fp32
    kernels' 3xTF32 product, the small passes first) on unit normal
    operands, as GPT-2's q, k, v and dO are: its sum strays from the same
    passes summed in fp64 by at most 1e-6 of max |a @ b| (the kernels chain
    24 passes into each accumulator and hold the gradients to 1e-5), and
    from the fp64 product by at most 2e-6."""
    gen = torch.Generator().manual_seed(82)
    a, b = torch.randn((64, k), generator=gen).to(cuda_device), torch.randn((k, 64), generator=gen).to(cuda_device)
    c = fa.wgmma_tf32_selftest(a, b, 3).double()
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    passes = al.double() @ bh.double() + ah.double() @ bl.double() + ah.double() @ bh.double()
    exact = a.double() @ b.double()
    top = exact.abs().max().item()
    assert (c - passes).abs().max().item() <= 1e-6 * top
    assert (c - exact).abs().max().item() <= 2e-6 * top


@pytest.mark.cuda
def test_flash_attention_bwd_f32_kernels_use_wgmma(cuda_device):
    """The fp32 backward's kernels for D <= 64 (dK/dV and dQ, named
    ``flash_bwd_..._tf32_wgmma``) hold HGMMA, the warpgroup product, in the
    SASS of the built library; the fp32 kernels for 64 < D <= 128 (mma.sync)
    hold none."""
    _, path = _bwd_library()
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", path], capture_output=True, text=True, check=True).stdout
    functions = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        functions[name.strip()] = body
    bwd = {name: body for name, body in functions.items() if "flash_bwd" in name}
    for kernel in ("flash_bwd_dkdv_tf32_wgmma_kernel", "flash_bwd_dq_tf32_wgmma_kernel"):
        found = [name for name in bwd if kernel in name]
        assert len(found) == 1, (kernel, sorted(bwd))
        assert "HGMMA" in bwd[found[0]], kernel
    plain = [name for name in bwd if "F32Route" in name and ("dkdv" in name or "dq" in name)]
    assert plain and not any("HGMMA" in bwd[name] for name in plain)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["masked", "causal"])
@pytest.mark.parametrize("d", [36, 40, 64])
@pytest.mark.parametrize("t", [100, 130])
def test_flash_attention_bwd_f32_wgmma_route(cuda_device, t, d, causal):
    """The fp32 backward's warpgroup kernels (D <= 64) on a ragged T, D = 36,
    40 and 64, masked and causal, with a fully masked row and a row whose
    later key tiles are all padding, against ``flash_attention_bwd`` within
    1e-5 * max(1, max|plain|), the mask's gradient too; two calls bitwise
    equal, one launch a call under its kind, a fully masked head's
    gradients 0."""
    b, h = 3, 2
    q, k, v, _ = _attention_inputs(b * h, t, d, h, cuda_device, seed=66)
    mask = _padded_mask(b, t, [slice(0, t), [], slice(0, 30)], cuda_device)
    do = torch.randn((b * h, t, d), generator=torch.Generator().manual_seed(67)).to(cuda_device)
    out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, 128, 128, d**-0.5)
    kernel, kind = fa.BWD_KERNELS[torch.float32], "causal" if causal else "masked"
    launches = kernel.by_kind[kind]
    got = fa.flash_attention_vjp(q, k, v, mask, out, lse, do, causal, 128, d**-0.5, True)
    again = fa.flash_attention_vjp(q, k, v, mask, out, lse, do, causal, 128, d**-0.5, True)
    torch.cuda.synchronize()
    assert kernel.by_kind[kind] == launches + 2
    want = fa.flash_attention_bwd(q, k, v, mask, out, lse, do, causal, t, d**-0.5, need_dmask=True)
    empty = (mask <= -1e29).all(dim=1).repeat_interleave(h)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        _close_grad(g, w)
    for g in got[:3]:
        assert torch.all(g[empty] == 0.0)


@pytest.mark.cuda
def test_distilbert_forward_launches_flash_attention_per_layer(cuda_device):
    """One forward of the tiny DistilBERT on the card launches K5 once per
    layer and gives what its einsum attention gives."""
    ids = torch.from_numpy(np.random.RandomState(51).randint(3, 1024, (2, 64))).to(cuda_device)
    amask = torch.ones_like(ids)
    amask[1, 20:] = 0
    logits = {}
    for impl in ("einsum", "auto"):
        model = distilbert_tiny(device=cuda_device, seed=3, attn_impl=impl)
        launches = fa.KERNEL.launches
        with torch.no_grad():
            logits[impl] = model(ids, amask)
        torch.cuda.synchronize()
        assert fa.KERNEL.launches - launches == (0 if impl == "einsum" else model.config.n_layers)
    torch.testing.assert_close(logits["auto"], logits["einsum"], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpt_lm_and_generate_run_on_the_card(cuda_device, dtype):
    """The tiny GPT trains on the card with K5 causal, forward and backward,
    once per layer and step (the kernels of q's dtype), and generates
    greedily: the same
    tokens as the CPU where the top two logits stand apart."""
    cfg = gpt_lm.default_config()
    cfg.compute_dtype = dtype
    kernels = (fa.KERNELS[getattr(torch, dtype)], fa.BWD_KERNELS[getattr(torch, dtype)])
    launches = [k.by_kind["causal"] for k in kernels]
    out = gpt_lm.run(cfg, preset="small", device=cuda_device, max_steps_per_epoch=2)
    assert [k.by_kind["causal"] - n for k, n in zip(kernels, launches)] == [2 * 2] * 2  # 2 steps, 2 layers
    assert out["steps"] == 2 and np.isfinite(out["losses"]).all()
    assert out["shape_groups"] == 3 and out["compute_dtype"] == dtype
    gcfg = gpt_generate.default_config()
    gcfg.compute_dtype = dtype
    res = gpt_generate.run(gcfg, preset="small", batch=4, prompt_len=8, max_new_tokens=8, device=cuda_device)
    assert len(res["sample_head"]) == 8 and res["prefill_ms"] > 0 and res["decode_ms_per_token"] > 0
    if dtype == "float32":
        model = gpt.gpt_tiny(device=cuda_device, vocab_size=64, max_position_embeddings=32)
        prompt = torch.randint(0, 64, (4, 8), generator=torch.Generator().manual_seed(0))
        tokens = gpt.generate(model, prompt.to(cuda_device), 8)
        ids = prompt.to(cuda_device)
        with torch.no_grad():
            for i in range(8):
                logits = model(ids)[:, -1]
                top2 = logits.topk(2).values
                sure = (top2[:, 0] - top2[:, 1]) > 1e-4
                nxt = logits.argmax(-1)
                assert torch.equal(nxt[sure], tokens[sure, i])
                ids = torch.cat([ids, tokens[:, i : i + 1]], 1)


@pytest.fixture
def exact_conv_math():
    """cuDNN without TF32 and with deterministic algorithms, restored after:
    the card against the CPU, with only the summation order differing."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True, False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _two_exact_steps(device, layout):
    cfg = exact_cifar10.default_config()
    cfg.global_batch_size = 16
    for k, v in layout.items():
        setattr(cfg, k, v)
    images, labels, _ = load_cifar10_or_synthetic(train=True)
    model, step, state = exact_cifar10.build(cfg, "small", device, group=None)
    losses = []
    for batch in accumulated_batches([images, labels], cfg, max_steps_per_epoch=2)(0):
        state, loss = step(state, tuple(torch.from_numpy(a).to(device) for a in batch))
        losses.append(loss.item())
    return losses, {k: v.detach().cpu() for k, v in state.params.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [{}, {"bucket_bytes": 50_000, "comm_chunks": 3}], ids=["mono", "bucket_chunks"])
def test_exact_cifar10_small_on_the_card_matches_the_cpu(cuda_device, exact_conv_math, layout):
    """Two exact-DDP steps of the small ResNet-18 on the card and on the CPU
    from the same seed and batches: 1e-4 (cuDNN against PyTorch's CPU
    convolutions, summed in other orders), as chip_smoke.py's small preset."""
    (cpu_losses, cpu_params), (gpu_losses, gpu_params) = (
        _two_exact_steps(torch.device("cpu"), layout), _two_exact_steps(cuda_device, layout)
    )
    np.testing.assert_allclose(gpu_losses, cpu_losses, rtol=1e-4, atol=1e-4)
    for name, want in cpu_params.items():
        torch.testing.assert_close(gpu_params[name], want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer_name", ["sgd_nesterov", "adamw"])
def test_imdb_baseline_runs_flash_attention_on_the_card(cuda_device, optimizer_name):
    """The single-node baseline on the card: K5's forward and backward once
    per layer and step (no fallback to their plain versions), finite
    losses, the gradient's bits."""
    cfg = imdb_baseline.default_config(optimizer_name)
    cfg.training_epochs = 1
    kernels = (fa.KERNEL, fa.BWD_KERNELS[torch.float32])
    launches = [k.launches for k in kernels]
    out = imdb_baseline.run(cfg, preset="small", device=cuda_device, max_steps_per_epoch=2, optimizer_name=optimizer_name)
    model = distilbert_tiny(device="cpu")
    assert [k.launches - n for k, n in zip(kernels, launches)] == [2 * model.config.n_layers] * 2
    assert out["steps"] == 2
    assert np.isfinite(out["losses"]).all()
    assert out["bits_per_step"] == 32 * sum(p.numel() for p in model.parameters())


# ---- the gather-based compressors and DiLoCo on the card ----------------------------------


class _FedNoiseQSGD(compression.QSGDReducer):
    """Stochastic QSGD rounding with the noise given (the CPU's and the
    card's generators draw different streams)."""

    def __init__(self, noise):
        super().__init__(stochastic=True)
        self.fixed = noise

    def noise(self, state, n, device, rank):
        return self.fixed.to(device)


def _compressor_leaves(device):
    shapes = [(64, 3, 3, 3), (64,), (128, 64), (10,), (1000,)]
    return [torch.from_numpy(_x(s, 60 + i)).to(device) for i, s in enumerate(shapes)]


def _four_worker_gather(x, group):
    """A stand-in for four workers' gather on one card: this rank's payload
    and three scaled copies (the indices as they are, so every kept element
    is added four times)."""
    if not x.is_floating_point():
        return torch.stack([x] * 4)
    return torch.stack([x * (j + 1) for j in range(4)])


@pytest.mark.cuda
def test_topk_out_is_bitwise_equal_across_calls(cuda_device, monkeypatch):
    """TopK's scatter-add on the card, with every kept element added by four
    workers: two calls give the same bits (worker by worker, each add's
    indices unique), and the CPU's sums within 1e-6."""
    monkeypatch.setattr(compression, "all_gather", _four_worker_gather)
    reducer = compression.TopKReducer(k_fraction=0.05)
    outs = []
    for device in (cuda_device, cuda_device, torch.device("cpu")):
        leaves = _compressor_leaves(device)
        _, out, mem, _ = reducer.reduce({}, leaves, None)
        outs.append([o.cpu() for o in out + mem])
    for a, b, c in zip(*outs):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["topk", "signsgd", "qsgd", "qsgd_stochastic"])
def test_compressor_on_the_card_matches_the_cpu(cuda_device, name):
    """Each compressor on the card against the CPU on the same leaves (QSGD's
    stochastic rounding fed the same noise): ``out`` and the memories
    within 1e-6 (the leaves' means and maxima summed in another order)."""
    n = sum(t.numel() for t in _compressor_leaves("cpu"))
    make = {
        "topk": lambda: compression.TopKReducer(k_fraction=0.01),
        "signsgd": compression.SignSGDReducer,
        "qsgd": lambda: compression.QSGDReducer(stochastic=False),
        "qsgd_stochastic": lambda: _FedNoiseQSGD(torch.rand(n, generator=torch.Generator().manual_seed(5))),
    }[name]
    results = []
    for device in (cuda_device, torch.device("cpu")):
        reducer = make()
        leaves = _compressor_leaves(device)
        _, out, mem, bits = reducer.reduce(reducer.init(leaves), leaves, None)
        results.append(([o.cpu() for o in out + mem], bits))
    (card, card_bits), (cpu, cpu_bits) = results
    assert card_bits == cpu_bits
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_diloco_round_with_k1_matches_its_plain_twin(cuda_device, exact_conv_math):
    """One DiLoCo round of the small ResNet-18 on the card (H = 2), its outer
    delta PowerSGD-compressed (rank 4): with K1, once a shape group, and with
    K1's plain version, from the same weights and batches; parameters within
    1e-5."""
    cfg = diloco_cifar10.default_config()
    cfg.global_batch_size = 16
    images, labels, _ = load_cifar10_or_synthetic(train=True)
    batches = [
        tuple(torch.from_numpy(a).to(cuda_device) for a in b)
        for b in accumulated_batches([images, labels], cfg, max_steps_per_epoch=2)(0)
    ]
    finals, launched = [], []
    for impl in ("cuda", "eager"):
        model = diloco_cifar10.build_model("small", cuda_device, seed=cfg.seed)
        reducer = PowerSGDReducer(random_seed=cfg.seed, compression_rank=4, matricize="last", orthogonalize_impl=impl)
        rnd = make_diloco_train_fn(image_classifier_loss(), model, inner_learning_rate=0.05, sync_every=2, reducer=reducer)
        state = rnd.init_state()
        before = gs.KERNEL.launches
        state, losses = rnd(state, batches)
        torch.cuda.synchronize()
        launched.append(gs.KERNEL.launches - before)
        assert torch.isfinite(losses).all()
        finals.append({k: v.detach().cpu() for k, v in state.params.items()})
    assert launched == [reducer.n_shape_groups(list(model.parameters())), 0]
    for name, want in finals[1].items():
        torch.testing.assert_close(finals[0][name], want, rtol=RTOL, atol=ATOL)


# ---- serving (no kernel of the port: torch indexing and cuBLAS) ----------------


def _paged_inputs(seed):
    gen = torch.Generator().manual_seed(seed)
    pool = torch.randn(9, 4, 2, 3, generator=gen)
    tables = torch.tensor([[1, 2, 3], [4, 5, 0], [6, 0, 0], [0, 0, 0]])
    return pool, tables, torch.randn(4, 2, 3, generator=gen), torch.randn(12, 2, 3, generator=gen)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [[0, 7, 3, 0], [11, 8, 13, 14]], ids=["in_range", "overrun"])
def test_paged_ops_on_the_card_equal_the_cpu(cuda_device, pos):
    """``ops/paged.py`` on CUDA tensors against the same calls on the CPU, bit
    for bit: positions past the table land in block 0 on the card too (no
    device-side assert), at offsets that do not collide."""
    from network_distributed_pytorch_tpu_torch.ops import paged

    pool, tables, rows, chain_rows = _paged_inputs(0)
    pos = torch.tensor(pos)
    results = []
    for dev in ("cpu", cuda_device):
        p = pool.to(dev)
        t = tables.to(dev)
        out = [paged.gather_block_view(p, t)]
        out.append(paged.scatter_token_rows(p.clone(), t, pos.to(dev), rows.to(dev)))
        out.append(paged.scatter_chain(p.clone(), torch.tensor([3, 7, 1], device=dev), chain_rows.to(dev)))
        out.append(paged.copy_block(p.clone(), 3, 6))
        out.append(paged.pool_chain_view(p, torch.tensor([4, 2, 0], device=dev)))
        torch.cuda.synchronize()
        results.append([o.cpu() for o in out])
    for cpu, card in zip(*results):
        assert torch.equal(cpu, card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_and_paged_engines_on_the_card_give_the_same_tokens(cuda_device, dtype):
    """The tiny GPT served on the card: the slot engine, the paged engine and
    the paged engine under a self-drafted K = 4 give the same tokens, bit
    for bit (the same shapes on one device), every self-drafted proposal the
    budget lets through is accepted, and the pool drains without a leak."""
    from network_distributed_pytorch_tpu_torch.serving import Request
    from network_distributed_pytorch_tpu_torch.serving.engine import PagedEngine, SlotEngine

    model = gpt.gpt_tiny(dtype=getattr(torch, dtype), device=cuda_device, vocab_size=64, max_position_embeddings=32)
    rng = np.random.RandomState(0)
    specs = [([int(t) for t in rng.randint(0, 64, rng.randint(2, 12))], int(rng.randint(2, 17))) for _ in range(10)]

    def serve(engine):
        reqs = [Request(request_id=f"r{i:02d}", prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(specs)]
        for r in reqs:
            engine.submit(r)
        assert len(engine.run(max_steps=500)) == len(reqs)
        return [r.tokens for r in reqs]

    slot = serve(SlotEngine(model, n_slots=4, max_len=32, device=cuda_device))
    paged = PagedEngine(model, n_slots=4, max_len=32, block_len=8, device=cuda_device, check_leaks=True)
    spec = PagedEngine(model, n_slots=4, max_len=32, block_len=8, draft_model=model, spec_k=4, device=cuda_device)
    assert serve(paged) == slot
    assert serve(spec) == slot
    rounds = sum(-(-(n - 1) // 4) for _, n in specs)
    assert spec.spec_accepted == sum(n - 1 for _, n in specs) - rounds
    paged.evict_all()
    assert paged.allocator.n_free == paged.allocator.n_usable


def test_serve_gpt_runs_on_the_card_or_raises_without_one():
    """Not marked ``cuda``: it runs everywhere. ``serve_gpt.run`` defaults
    to the card: where there is one, it serves there and names it; where
    there is none, it raises rather than run on the CPU."""
    from network_distributed_pytorch_tpu_torch.experiments import serve_gpt

    kw = dict(preset="small", slots=2, requests=3, request_rate=0.0, max_new_tokens=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_gpt.run(**kw)
        return
    out = serve_gpt.run(**kw)
    assert out["device"] == torch.cuda.get_device_name(0) and out["slo"]["n_finished"] == 3


@pytest.fixture
def deterministic_algorithms(exact_conv_math):
    """``torch.use_deterministic_algorithms(True)`` (warning, not raising,
    where an op has no deterministic kernel) and cuBLAS's fixed workspace,
    on top of deterministic cuDNN; all restored after."""
    saved = (
        torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
        os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
    )
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
    if saved[2] is None:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
    else:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[2]


def _state_tensors(state):
    """Params, momenta, memories, buffers and Q of a ``TrainState``, cloned."""
    out = {"q": state.reducer_state.q_memory.clone()}
    for field in ("params", "momenta", "memories", "model_state"):
        out.update({f"{field}.{k}": v.detach().clone() for k, v in getattr(state, field).items()})
    return out


@pytest.mark.cuda
def test_resnet18_resume_on_the_card_is_bit_for_bit(cuda_device, deterministic_algorithms, tmp_path):
    """Two PowerSGD steps of the small ResNet-18 on the card (K1 in each),
    saved after the first; a model of other weights restored from the save
    takes the second step and lands on the uninterrupted run's bits."""
    cfg = powersgd_cifar10.default_config()
    cfg.global_batch_size = 16
    images, labels, _ = load_cifar10_or_synthetic(train=True)
    batches = [
        tuple(torch.from_numpy(a).to(cuda_device) for a in b)
        for b in accumulated_batches([images, labels], cfg, max_steps_per_epoch=2)(0)
    ]
    _, step, state = powersgd_cifar10.build(cfg, "small", cuda_device, group=None)
    state, _ = step(state, batches[0])
    path = save_checkpoint(str(tmp_path), state, step=0)
    state, _ = step(state, batches[1])
    want = _state_tensors(state)

    launches = gs.KERNEL.launches
    _, step, fresh = powersgd_cifar10.build(cfg, "small", cuda_device, group=None)
    with torch.no_grad():
        for p in fresh.params.values():
            p.add_(1.0)
    fresh, _ = step(restore_checkpoint(path, fresh), batches[1])
    assert gs.KERNEL.launches - launches == step.reducer.n_shape_groups(list(fresh.params.values()))
    got = _state_tensors(fresh)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["ef_momentum", "optax"])
def test_a_cpu_checkpoint_restores_onto_the_card(cuda_device, tmp_path, algorithm):
    """A checkpoint written from CPU tensors restored into a state on the
    card: every leaf lands on the card with the CPU's values (an AdamW
    optimizer's state too)."""

    def setup(device):
        model = SmallCNN(width=4, image_size=8, device=device, seed=0)
        reducer = PowerSGDReducer(random_seed=7, compression_rank=2, matricize="last")
        kw = {"optimizer": lambda ps: torch.optim.AdamW(ps, lr=1e-3)} if algorithm == "optax" else {}
        step = make_train_step(image_classifier_loss(), reducer, model, 0.05, 0.9, algorithm, **kw)
        return step, step.init_state()

    step, state = setup("cpu")
    gen = torch.Generator().manual_seed(0)
    state, _ = step(state, (torch.randn(8, 8, 8, 3, generator=gen), torch.arange(8)))
    path = save_checkpoint(str(tmp_path), state, step=0)
    _, card = setup(cuda_device)
    restored = restore_checkpoint(path, card)
    want, got = _state_tensors(state), _state_tensors(restored)
    for k, v in want.items():
        assert got[k].device.type == "cuda" and torch.equal(got[k].cpu(), v), k
    if algorithm == "optax":
        for slot in restored.optimizer.state.values():
            for name, v in slot.items():
                if torch.is_tensor(v) and v.dim() > 0:
                    assert v.device.type == "cuda", name


def _stage_on(device, cfg, params, x, cot):
    """One GPT-2 block as a pipeline stage (``make_gpt_stage_fn``) on
    ``device``: its output and the gradients of ``sum(out * cot)``."""
    leaves = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
    xd = x.to(device).requires_grad_(True)
    out = gpt.make_gpt_stage_fn(cfg, 1)(leaves, xd)
    grads = torch.autograd.grad((out * cot.to(device)).sum(), [xd, *leaves.values()])
    return out.detach().cpu(), [g.cpu() for g in grads]


# the key projection's bias has a gradient of 0 in exact arithmetic (a
# softmax ignores a shift of a row's scores): both sides hold the rounding
# of a sum over every token (under 1e-9 at these shapes), held to
# KEY_BIAS_ATOL of max(1, max|want|) of the same layer's query bias, a sum
# of the same kind that does not cancel (about 1e-3 here)
KEY_BIAS_ATOL = 1e-7


def _held(got, want, names):
    """Each tensor within ATOL of max(1, max|want|), a key projection's
    bias within KEY_BIAS_ATOL of its query bias's."""
    wants = dict(zip(names, want))
    for name, g, w in zip(names, got, want):
        if name.endswith("attn.k_proj.bias"):
            atol = KEY_BIAS_ATOL * max(1.0, wants[name.replace("k_proj", "q_proj")].abs().max().item())
        else:
            atol = ATOL * max(1.0, w.abs().max().item())
        torch.testing.assert_close(g, w, rtol=0, atol=atol, msg=name)


@pytest.mark.cuda
def test_k5_inside_a_pipeline_stage_matches_its_plain_version(cuda_device, exact_conv_math):
    """A pipeline stage of GPT-2 small's width (dim 768, 12 heads, FFN
    3072; GPT-2's init) on a microbatch of 4 sequences of 1024, with the
    cotangent of a mean loss (1 / (B T) an element): the card's stage runs
    K5 causal once forward and once backward, the CPU's the kernels' plain
    versions; output and every gradient within 1e-5 of max(1, max|CPU|)."""
    cfg = gpt.GPTConfig(vocab_size=1024, dropout=0.0)
    model = gpt.GPTLM(dataclass_replace(cfg, n_layers=1), device="cpu", seed=5)
    stacked = {k[len("h.0."):]: v.detach()[None] for k, v in model.named_parameters() if k.startswith("h.0.")}
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((4, 1024, 768), generator=gen)
    cot = torch.randn((4, 1024, 768), generator=gen) / (4 * 1024)
    before = [fa.KERNEL.by_kind["causal"], fa.BWD_KERNELS[torch.float32].by_kind["causal"]]
    got = _stage_on(cuda_device, cfg, stacked, x, cot)
    after = [fa.KERNEL.by_kind["causal"], fa.BWD_KERNELS[torch.float32].by_kind["causal"]]
    assert [a - b for a, b in zip(after, before)] == [1, 1]
    want = _stage_on(torch.device("cpu"), cfg, stacked, x, cot)
    _held([got[0], *got[1]], [want[0], *want[1]], ["out", "x", *stacked])


@pytest.mark.cuda
def test_k5_inside_a_world1_moe_block_matches_its_plain_version(cuda_device, exact_conv_math):
    """A GPT-2-wide MoE decoder (dim 768, 12 heads, 8 experts of width
    1536, capacity factor 2) of one block over a one-rank NCCL group on
    the card, 16 sequences of 256: K5 causal once forward and once
    backward, against the same block on the CPU (K5's plain versions,
    ``group=None``): logits, aux loss and every gradient within 1e-5 of
    max(1, max|CPU|)."""
    from network_distributed_pytorch_tpu_torch.experiments import gpt_moe
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )

    cfg = dataclass_replace(gpt_moe.moe_config("full", 256, torch.float32), n_layers=1)
    base, routers, experts = gpt_moe.init_moe_params(cfg, 8, 714)
    ids = torch.randint(0, 1024, (16, 256), generator=torch.Generator().manual_seed(1))
    capacity = int(2.0 * 16 * 256 / 8)

    def block(device, group):
        leaves = [{k: v.to(device).requires_grad_(True) for k, v in d.items()} for d in (base, experts, routers)]
        logits, aux, _ = gpt_moe.moe_gpt_forward(cfg, *leaves, ids.to(device), capacity, group)
        loss = gpt.next_token_loss(logits, ids.to(device).roll(-1, 1)) + aux
        grads = torch.autograd.grad(loss, [v for d in leaves for v in d.values()])
        return [logits.detach().cpu(), aux.detach().cpu(), *(g.cpu() for g in grads)]

    group = initialize_distributed(DistributedConfig(), cuda_device)
    try:
        before = [fa.KERNEL.by_kind["causal"], fa.BWD_KERNELS[torch.float32].by_kind["causal"]]
        got = block(cuda_device, group)
        after = [fa.KERNEL.by_kind["causal"], fa.BWD_KERNELS[torch.float32].by_kind["causal"]]
    finally:
        shutdown_distributed()
    assert [a - b for a, b in zip(after, before)] == [1, 1]
    names = ["logits", "aux", *base, *experts, *routers]
    _held(got, block(torch.device("cpu"), None), names)


@pytest.fixture
def one_rank_nccl(cuda_device):
    """A one-rank NCCL group on the card, destroyed after."""
    group = initialize_distributed(DistributedConfig(), cuda_device)
    yield group
    shutdown_distributed()


@pytest.mark.cuda
def test_world1_fsdp_step_is_the_ddp_step_bit_for_bit(cuda_device, deterministic_algorithms, one_rank_nccl):
    """At world 1 every gather is a copy, the reduce-scatter sums one term
    and the update is the same elementwise SGD: two FSDP steps of the
    SmallCNN give the DDP step's parameters and losses bit for bit, and
    chunked FSDP (K = 3) the monolithic one's."""
    rng = np.random.RandomState(70)
    batches = [
        (torch.from_numpy(rng.randn(16, 32, 32, 3).astype(np.float32)).to(cuda_device),
         torch.from_numpy(rng.randint(0, 10, 16)).to(cuda_device))
        for _ in range(2)
    ]

    def two_steps(fsdp, chunks=None):
        model = SmallCNN(width=8, device=cuda_device, seed=4)
        if fsdp:
            step = make_fsdp_train_step(image_classifier_loss(), model, 0.05, 0.9, "sgd", one_rank_nccl,
                                        comm_chunks=chunks)
        else:
            step = make_train_step(image_classifier_loss(), ExactReducer(), model, 0.05, 0.9, "sgd", one_rank_nccl)
        state = step.init_state()
        losses = []
        for b in batches:
            state, loss = step(state, b)
            losses.append(loss.item())
        params = step.unshard(state) if fsdp else {k: v.detach().clone() for k, v in state.params.items()}
        return losses, params

    ddp_losses, ddp = two_steps(False)
    for chunks in (None, 3):
        losses, params = two_steps(True, chunks)
        assert losses == ddp_losses
        assert set(params) == set(ddp)
        for k, want in ddp.items():
            assert params[k].device.type == "cuda" and torch.equal(params[k], want), (chunks, k)


# ---- remat, scan_layers and the ResNet in bf16 on the card -------------------------


def _k5_launches():
    return {k.name: k.launches for k in (fa.KERNEL, fa.KERNEL_BF16, *fa.BWD_KERNELS.values())}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gpt", "distilbert"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_remat_step_is_the_plain_step_bit_for_bit_on_the_card(cuda_device, deterministic_algorithms, kind, dtype):
    """A remat step recomputes each block (K5's forward twice a layer, its
    backward once) and lands on the plain step's loss and gradients bit for
    bit under deterministic algorithms."""
    rng = np.random.RandomState(80)
    if kind == "gpt":
        ids = torch.from_numpy(rng.randint(0, 128, (2, 33))).long().to(cuda_device)
        batch = (ids[:, :-1], ids[:, 1:])
        make = lambda remat: gpt.gpt_tiny(device=cuda_device, seed=5, dtype=dtype, remat=remat)  # noqa: E731
        loss_fn = lambda m: gpt.next_token_loss(m(batch[0]), batch[1])  # noqa: E731
    else:
        ids = torch.from_numpy(rng.randint(3, 1024, (4, 32))).long().to(cuda_device)
        mask = torch.ones_like(ids)
        mask[1, 20:] = 0
        labels = torch.tensor([0, 1, 1, 0], device=cuda_device)
        make = lambda remat: distilbert_tiny(device=cuda_device, seed=5, dtype=dtype, remat=remat)  # noqa: E731
        loss_fn = lambda m: torch.nn.functional.cross_entropy(m(ids, mask), labels)  # noqa: E731
    got = {}
    for remat in (False, True):
        model = make(remat)
        before = _k5_launches()
        loss = loss_fn(model)
        loss.backward()
        torch.cuda.synchronize()
        after = _k5_launches()
        fwd = (fa.KERNEL if dtype == torch.float32 else fa.KERNEL_BF16).name
        n = model.config.n_layers
        assert after[fwd] - before[fwd] == (2 if remat else 1) * n
        assert after[fa.BWD_KERNELS[dtype].name] - before[fa.BWD_KERNELS[dtype].name] == n
        got[remat] = (loss.detach(), {k: p.grad for k, p in model.named_parameters()})
    assert torch.equal(got[False][0], got[True][0])
    for k, g in got[False][1].items():
        assert torch.equal(g, got[True][1][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_scan_layers_is_the_unrolled_model_bit_for_bit_on_the_card(cuda_device, deterministic_algorithms, dtype):
    ids = torch.from_numpy(np.random.RandomState(81).randint(0, 128, (2, 33))).long().to(cuda_device)
    got = {}
    for scan in (False, True):
        model = gpt.gpt_tiny(device=cuda_device, seed=6, dtype=dtype, n_layers=3, scan_layers=scan, remat=scan)
        loss = gpt.next_token_loss(model(ids[:, :-1]), ids[:, 1:])
        loss.backward()
        grads = {k: p.grad for k, p in model.named_parameters()}
        got[scan] = (loss.detach(), gpt.unstack_gpt_layer_params(grads) if scan else grads)
    assert torch.equal(got[False][0], got[True][0])
    assert set(got[False][1]) == set(got[True][1])
    for k, g in got[False][1].items():
        assert torch.equal(g, got[True][1][k]), k


@pytest.mark.cuda
def test_k1_at_gpt2_small_stacked_groups_matches_plain(cuda_device):
    """``scan_layers`` makes each stacked leaf one matrix: K1 runs on P
    stacks up to (1, 36864, 4) (the stacked MLP projection)."""
    model = gpt.gpt_small(device="meta", vocab_size=1024, scan_layers=True)
    params = list(model.parameters())
    reducer = PowerSGDReducer(
        compression_rank=4, matricize="last", features_last=embedding_leaves(model),
        layer_stacked=layer_stacked_leaves(model),
    )
    metas = reducer._metas(params)
    shapes = sorted({(len(g), metas[g[0]].n, metas[g[0]].r) for g in reducer._shape_groups(metas)})
    assert (1, 36864, 4) in shapes and (4, 9216, 4) in shapes and len(shapes) == 6
    for i, shape in enumerate(shapes):
        x = torch.from_numpy(_x(shape, 90 + i)).to(cuda_device)
        launches = gs.KERNEL.launches
        got = gs.gram_schmidt(x)
        torch.cuda.synchronize()
        assert gs.KERNEL.launches == launches + 1
        torch.testing.assert_close(got, orthogonalize(x), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_resnet_bf16_fused_pipeline_matches_xla_on_the_card(cuda_device, exact_conv_math):
    """The small ResNet-18 in bf16, two PowerSGD steps on each compress
    pipeline from the same weights and batches: the same bits as fp32, and
    the fused kernels' parameters within 1e-5 of the xla pipeline's (both
    reduce the same fp32 gradients; only the compress arithmetic differs)."""
    images, labels, _ = load_cifar10_or_synthetic(train=True)
    params, bits = {}, {}
    for impl in ("xla", "pallas"):
        for dtype in ("float32", "bfloat16"):
            cfg = powersgd_cifar10.default_config()
            cfg.global_batch_size, cfg.compress_impl, cfg.compute_dtype = 16, impl, dtype
            model, step, state = powersgd_cifar10.build(cfg, "small", cuda_device, group=None)
            assert model.dtype == getattr(torch, dtype)
            for b in accumulated_batches([images, labels], cfg, max_steps_per_epoch=2)(0):
                state, loss = step(state, tuple(torch.from_numpy(a).to(cuda_device) for a in b))
                assert torch.isfinite(loss)
            bits[impl, dtype] = step.bits_per_step
            params[impl, dtype] = {k: v.detach().clone() for k, v in state.params.items()}
    assert len(set(bits.values())) == 1
    for k, want in params["xla", "bfloat16"].items():
        got = params["pallas", "bfloat16"][k]
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, msg=k)


# ---- the telemetry core on the card -------------------------------------------


def _probe_setup(cuda_device, impl):
    """The small ResNet-18 after one PowerSGD step on the card, and the
    step's batch."""
    images, labels, _ = load_cifar10_or_synthetic(train=True)
    cfg = powersgd_cifar10.default_config()
    cfg.global_batch_size, cfg.compress_impl = 16, impl
    model, step, state = powersgd_cifar10.build(cfg, "small", cuda_device, group=None)
    batch = tuple(torch.from_numpy(a).to(cuda_device) for a in next(accumulated_batches([images, labels], cfg, 1)(0)))
    state, _ = step(state, batch)
    return step, state, batch


def _flat_probe(stats):
    out = {k: stats[k] for k in ("grad_norm", "ef_memory_norm", "powersgd_rel_error", "loss")}
    out.update({f"{g}.{k}": v for g, vals in stats["fidelity"].items() for k, v in vals.items()})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_health_probe_on_the_kernels_matches_their_plain_versions(cuda_device, exact_conv_math, impl, monkeypatch):
    """The probe's diagnostic round launches K1 (xla), or K2b, K3 and K4
    (fused), once a shape group; on their plain versions it gives the same
    values within 1e-5 and launches none."""
    from network_distributed_pytorch_tpu_torch.parallel import reducers as reducers_mod

    step, state, batch = _probe_setup(cuda_device, impl)
    n_groups = step.reducer.n_shape_groups(list(state.params.values()))
    kernels = [gs.KERNEL] if impl == "xla" else [ps.COMPRESS, ps.ORTHOGONALIZE_PROJECT, ps.DECOMPRESS_RESIDUAL]
    before = [k.launches for k in kernels]
    got = step.health_fn(state, batch)
    assert [k.launches - b for k, b in zip(kernels, before)] == [n_groups] * len(kernels)
    if impl == "xla":
        monkeypatch.setattr(step.reducer, "orthogonalize_impl", "eager")
    else:
        monkeypatch.setattr(reducers_mod, "fused_ef_compress", lambda g, q, r=None: (g, ps.compress_reference(g, q)))
        monkeypatch.setattr(reducers_mod, "fused_orthogonalize_project", ps.orthogonalize_project_reference)
        monkeypatch.setattr(reducers_mod, "fused_decompress_residual", ps.decompress_residual_reference)
    before = [k.launches for k in kernels]
    plain = step.health_fn(state, batch)
    assert [k.launches for k in kernels] == before
    got, plain = _flat_probe(got), _flat_probe(plain)
    assert sorted(got) == sorted(plain)
    for key, want in plain.items():
        assert got[key] == pytest.approx(want, rel=RTOL, abs=ATOL), key


@pytest.mark.cuda
def test_memory_sampler_reads_the_card(cuda_device):
    from network_distributed_pytorch_tpu_torch.observe import MemorySink, Telemetry
    from network_distributed_pytorch_tpu_torch.observe.memory import MemorySampler

    x = torch.empty(1 << 20, device=cuda_device)
    sink = MemorySink()
    sampler = MemorySampler(Telemetry([sink]), label="card", device=cuda_device)
    event = sampler.sample(3)
    assert sampler.enabled and event.bytes_in_use >= x.numel() * 4
    assert event.peak_bytes_in_use >= event.bytes_in_use
    assert event.bytes_limit == torch.cuda.get_device_properties(cuda_device).total_memory
    assert event.device_kind == torch.cuda.get_device_name(cuda_device) and sink.of_kind("memory")[0]["step"] == 3


@pytest.mark.cuda
def test_the_trace_holds_the_kernels_and_the_step_ranges(cuda_device, tmp_path):
    from network_distributed_pytorch_tpu_torch.observe import MemorySink, Telemetry
    from network_distributed_pytorch_tpu_torch.experiments.common import train_loop
    from network_distributed_pytorch_tpu_torch.utils.overlap import kernels_from_chrome_trace

    images, labels, _ = load_cifar10_or_synthetic(train=True)
    cfg = powersgd_cifar10.default_config()
    cfg.global_batch_size = 16
    _, step, state = powersgd_cifar10.build(cfg, "small", cuda_device, group=None)
    sink = MemorySink()
    train_loop(
        step, state, accumulated_batches([images, labels], cfg, 2), 1, cuda_device,
        telemetry=Telemetry([sink]), trace_dir=str(tmp_path), run_name="traced", health_every=1,
    )
    text = (tmp_path / "trace.json").read_text()
    assert '"traced#1"' in text and '"health_probe"' in text
    names = {k["name"] for k in kernels_from_chrome_trace(str(tmp_path / "trace.json"))}
    assert any("gram_schmidt" in n for n in names)
    assert len(sink.of_kind("memory")) == 2 and len(sink.of_kind("train_health")) == 2
