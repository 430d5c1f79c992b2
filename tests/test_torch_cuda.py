"""Tests of the PyTorch port that need a CUDA card: the CUDA Gram-Schmidt
kernel (with the route and cluster size it takes for the word table's
height and for small matrices), the fused PowerSGD kernels
(``ops/powersgd.py``: ragged and misaligned stacks, K3's P-hat equal to the
Gram-Schmidt kernel's bit for bit, two launches giving the same bits) and
the flash attention kernel
(``ops/flash_attention.py``, with left padding, a lone real key, a ragged
T and NaN in the key tiles it must skip) against their plain versions, the
PowerSGD reducer launching its kernels once per shape group,
DistilBERT launching flash attention once per layer, exact-DDP steps of the
small ResNet-18 on the card against the CPU, and the single-node IMDb
baseline running flash attention on the card.

This file imports torch and the port, never jax, so it also runs on a
machine that has the card and no JAX (``--noconftest`` skips the JAX
harness of ``tests/conftest.py``)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Where there is no card every test here skips.

Tolerance: fp32, rtol = atol = 1e-5, as in ``test_torch_orthogonalize.py``:
the kernel sums each column's squares and projections in another order than
the plain version, and later columns inherit the earlier columns' rounding.
The fused kernels' products (P, Q, out, mem) are held to
``1e-5 * max(1, max|plain|)``: sums of up to n or m terms in another order;
M = G + E is one rounded add, so it must be bitwise equal. Flash attention:
out within ``1e-5 * max(1, max|plain|)`` and lse within 1e-5 relative (fp32
sums over the keys in another order, the kernel in 64-key tiles); a fully
masked row exactly 0 with lse 1e30.
"""

import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu_torch.data.cifar10 import load_cifar10_or_synthetic
from network_distributed_pytorch_tpu_torch.experiments import exact_cifar10, imdb_baseline
from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches
from network_distributed_pytorch_tpu_torch.models.distilbert import distilbert_tiny
from network_distributed_pytorch_tpu_torch.ops import flash_attention as fa
from network_distributed_pytorch_tpu_torch.ops import gram_schmidt as gs
from network_distributed_pytorch_tpu_torch.ops import powersgd as ps
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
    x = torch.zeros((1, 16, 2, 8), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(TypeError):
        fa.flash_attention(x, x, x)


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
    """The single-node baseline on the card: K5 once per layer and step (no
    fallback to its plain version), finite losses, the gradient's bits."""
    cfg = imdb_baseline.default_config(optimizer_name)
    cfg.training_epochs = 1
    launches = fa.KERNEL.launches
    out = imdb_baseline.run(cfg, preset="small", device=cuda_device, max_steps_per_epoch=2, optimizer_name=optimizer_name)
    model = distilbert_tiny(device="cpu")
    assert fa.KERNEL.launches - launches == 2 * model.config.n_layers
    assert out["steps"] == 2
    assert np.isfinite(out["losses"]).all()
    assert out["bits_per_step"] == 32 * sum(p.numel() for p in model.parameters())
