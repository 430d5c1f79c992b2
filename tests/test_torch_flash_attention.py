"""The port's flash attention (K5) on the CPU against the JAX package's:
the plain forward (out and lse) against the Pallas kernel in interpret mode,
the blockwise backward against ``_flash_bwd_chunked`` on the same residuals,
``torch.autograd`` through the wrapper against ``jax.grad`` through the JAX
function, the fully masked rows for both padding values, and that a key
block holding only padding contributes nothing (what lets the CUDA kernel
skip such tiles without reading them).

Inputs are drawn with numpy from a seed and handed to both. Tolerance:
fp32, 1e-5 (out, lse relative to max(1, |lse|), and the gradients relative
to max(1, max|JAX|)): the two sum the same blocks in another order.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from network_distributed_pytorch_tpu_torch.ops import flash_attention as fa
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

# the module, not the function of the same name that the package exports
jfa = importlib.import_module("network_distributed_pytorch_tpu.ops.flash_attention")

TOL = 1e-5
B, T, H = 2, 32, 4
F32_MIN = float(np.finfo(np.float32).min)


def _inputs(seed, d, pad):
    """q, k, v as (B, T, H, D) and the (B, T) mask: ``pad`` is None, a
    ragged padded tail per row, or a padding value for a fully masked row 0
    beside a padded tail on row 1."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, H, d).astype(np.float32) for _ in range(3))
    mask = np.zeros((B, T), np.float32)
    if pad == "tail":
        mask[0, 24:] = F32_MIN
        mask[1, 29:] = -1e30
    elif pad is not None:
        mask[0, :] = pad
        mask[1, 20:] = pad
    return q, k, v, mask


def _fold(x):
    b, t, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, t, d)


def _jax_kernel(qf, kf, vf, mask, causal, block_q, block_k):
    """The Pallas ``_flash_kernel`` in interpret mode: (out, lse)."""
    bh, t, d = qf.shape
    h = bh // mask.shape[0]
    kernel = functools.partial(jfa._flash_kernel, block_q, block_k, t, causal, 1.0 / d**0.5)
    return pl.pallas_call(
        kernel,
        grid=(bh, t // block_q),
        in_specs=[
            pl.BlockSpec((1, block_q, d), lambda i, j: (i, j, 0)),
            pl.BlockSpec((1, t, d), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((1, t, d), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((1, t), lambda i, j: (i // h, 0)),
        ],
        out_specs=[
            pl.BlockSpec((1, block_q, d), lambda i, j: (i, j, 0)),
            pl.BlockSpec((1, block_q), lambda i, j: (i, j)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((bh, t, d), jnp.float32),
            jax.ShapeDtypeStruct((bh, t), jnp.float32),
        ],
        interpret=True,
    )(jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf), jnp.asarray(mask))


def _scaled_close(got, want, what):
    want = np.asarray(want)
    tol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol, err_msg=what)


def _lse_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL, atol=TOL, err_msg="lse")


CASES = {  # d, causal, pad, block_q, block_k
    "full": (16, False, None, 8, 8),
    "causal": (16, True, None, 8, 8),
    "padded": (8, False, "tail", 16, 16),
    "padded_causal_uneven": (16, True, "tail", 4, 16),
    "uneven": (8, False, "tail", 16, 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_forward_matches_jax_kernel(case):
    d, causal, pad, bq, bk = CASES[case]
    q, k, v, mask = _inputs(1, d, pad)
    qf, kf, vf = _fold(q), _fold(k), _fold(v)
    want_out, want_lse = _jax_kernel(qf, kf, vf, mask, causal, bq, bk)
    out, lse = fa.flash_attention_reference(
        *(torch.from_numpy(a) for a in (qf, kf, vf, mask)), causal, bq, bk, 1.0 / d**0.5
    )
    _scaled_close(out.numpy(), want_out, "out")
    _lse_close(lse.numpy(), want_lse)
    # the public wrapper, (B, T, H, D), against the JAX function
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)), causal=causal, block_q=bq, block_k=bk)
    want = jfa.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v, mask)), causal=causal, block_q=bq, block_k=bk, interpret=True
    )
    _scaled_close(got.numpy(), want, "wrapper out")


@pytest.mark.parametrize("case", ["full", "causal", "padded_causal_uneven"])
def test_backward_matches_jax_scan(case):
    """``flash_attention_bwd`` against ``_flash_bwd_chunked`` on the same
    residuals (the JAX kernel's out and lse) and the same cotangent."""
    d, causal, pad, bq, bk = CASES[case]
    q, k, v, mask = _inputs(2, d, pad)
    qf, kf, vf = _fold(q), _fold(k), _fold(v)
    out, lse = (np.array(a) for a in _jax_kernel(qf, kf, vf, mask, causal, bq, bk))
    do = np.random.RandomState(3).randn(*qf.shape).astype(np.float32)
    scale = 1.0 / d**0.5
    want = jfa._flash_bwd_chunked(scale, causal, bk, *(jnp.asarray(a) for a in (qf, kf, vf, mask, out, lse, do)))
    got = fa.flash_attention_bwd(
        *(torch.from_numpy(a) for a in (qf, kf, vf, mask, out, lse, do)), causal, bk, scale
    )
    for name, g, w in zip(("dq", "dk", "dv", "dmask"), got, want):
        _scaled_close(g.numpy(), w, name)


@pytest.mark.parametrize("case", ["causal", "padded"])
def test_autograd_matches_jax_grad(case):
    """Gradients in q, k, v and the mask of ``sum(out * w)`` through the
    port's wrapper and through the JAX function."""
    d, causal, pad, bq, bk = CASES[case]
    q, k, v, mask = _inputs(4, d, pad)
    w = np.random.RandomState(5).randn(B, T, H, d).astype(np.float32)

    def jax_loss(q, k, v, mask):
        out = jfa.flash_attention(q, k, v, mask=mask, causal=causal, block_q=bq, block_k=bk, interpret=True)
        return jnp.sum(out * w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, mask)))
    tq, tk, tv, tm = (torch.from_numpy(a).requires_grad_() for a in (q, k, v, mask))
    out = fa.flash_attention(tq, tk, tv, tm, causal=causal, block_q=bq, block_k=bk)
    (out * torch.from_numpy(w)).sum().backward()
    for name, g, ww in zip(("dq", "dk", "dv", "dmask"), (tq.grad, tk.grad, tv.grad, tm.grad), want):
        _scaled_close(g.numpy(), ww, name)


@pytest.mark.parametrize("pad_value", [-1e30, F32_MIN], ids=["neg1e30", "f32min"])
def test_fully_masked_rows(pad_value):
    """A row whose every key is padding gives out = 0 exactly, lse = 1e30,
    and no gradient into its q, k or v, for the package's -1e30 and the
    f32 min that DistilBERT's encoder adds; the other row matches JAX."""
    q, k, v, mask = _inputs(6, 16, pad_value)
    qf, kf, vf = _fold(q), _fold(k), _fold(v)
    out, lse = fa.flash_attention_reference(
        *(torch.from_numpy(a) for a in (qf, kf, vf, mask)), False, 8, 8, 0.25
    )
    assert torch.all(out[:H] == 0.0) and torch.all(lse[:H] == 1e30)
    assert torch.isfinite(out).all()
    want_out, want_lse = _jax_kernel(qf, kf, vf, mask, False, 8, 8)
    _scaled_close(out.numpy(), want_out, "out")
    _lse_close(lse.numpy(), want_lse)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (fa.flash_attention(tq, tk, tv, torch.from_numpy(mask), block_q=8, block_k=8) ** 2).sum().backward()
    for g in (tq.grad, tk.grad, tv.grad):
        assert torch.all(g[0] == 0.0)
    assert torch.any(tv.grad[1] != 0.0)


def _padded(seed, t, keys, d=16, h=2):
    """Folded q, k, v ((B*H, T, D), B = len(keys)) and a (B, T) mask that is
    0 on the keys ``keys[i]`` of row i and finfo(f32).min elsewhere."""
    rng = np.random.RandomState(seed)
    b = len(keys)
    qf, kf, vf = (rng.randn(b * h, t, d).astype(np.float32) for _ in range(3))
    mask = np.full((b, t), F32_MIN, np.float32)
    for i, k in enumerate(keys):
        mask[i, k] = 0.0
    return qf, kf, vf, mask


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_all_padding_key_blocks_contribute_nothing(causal):
    """Skipping a 64-key block that holds only padding is exact: replacing
    K and V in every such block by other finite values leaves the plain
    forward's out and lse bitwise unchanged, and the JAX kernel agrees."""
    t, h, block = 256, 2, 64
    qf, kf, vf, mask = _padded(7, t, [slice(0, 42), slice(0, 100)], h=h)
    empty = (mask.reshape(2, t // block, block) <= -1e29).all(-1).repeat(h, 0)  # (BH, blocks)
    assert empty.sum() == 2 * (3 + 2)
    other = np.random.RandomState(8)
    kf2, vf2 = kf.copy(), vf.copy()
    for bh, j in zip(*np.nonzero(empty)):
        rows = slice(j * block, (j + 1) * block)
        kf2[bh, rows] = 100.0 * other.randn(block, kf.shape[2])
        vf2[bh, rows] = 100.0 * other.randn(block, kf.shape[2])
    run = lambda k, v: fa.flash_attention_reference(
        *(torch.from_numpy(a) for a in (qf, k, v, mask)), causal, block, block, 0.25
    )
    (out, lse), (out2, lse2) = run(kf, vf), run(kf2, vf2)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    want_out, want_lse = _jax_kernel(qf, kf2, vf2, mask, causal, block, block)
    _scaled_close(out.numpy(), want_out, "out")
    _lse_close(lse.numpy(), want_lse)


def test_left_padding_and_lone_key_match_jax_kernel():
    """Real keys only at the end of a row (left padding), and one real key
    in the middle of an otherwise padded block: the plain forward against
    the JAX kernel."""
    qf, kf, vf, mask = _padded(9, 128, [slice(100, 128), [45], slice(60, 128)])
    want_out, want_lse = _jax_kernel(qf, kf, vf, mask, False, 32, 32)
    out, lse = fa.flash_attention_reference(
        *(torch.from_numpy(a) for a in (qf, kf, vf, mask)), False, 32, 32, 0.25
    )
    _scaled_close(out.numpy(), want_out, "out")
    _lse_close(lse.numpy(), want_lse)


def test_wrapper_refuses_blocks_that_do_not_divide_t():
    x = torch.zeros((1, 24, 2, 8))
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention(x, x, x, block_q=16, block_k=16)
