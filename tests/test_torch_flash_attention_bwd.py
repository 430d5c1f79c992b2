"""K5's kernel routes on the CPU, where the kernels cannot run: their
rounding, emulated in PyTorch, against the JAX package; the wrapper's
backward dispatch and the checks it makes before a launch; and the
arithmetic of the backward's bound in ``chip_smoke.py``.

On bf16 heads the CUDA kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``) take S = q.k and dP = dO.v as exact bf16
products summed in fp32 (scale applied after the sum), and feed the fp32 P
and dS to the tensor cores split into two bf16 parts, hi = bf16(x) and
lo = bf16(x - hi). ``_route_forward`` and ``_route_backward`` do the same
in fp32 PyTorch, with the forward's online softmax over key tiles; held to
the JAX Pallas kernel in interpret mode (out, lse) and to ``jax.vjp`` of
``flash_attention`` (dq, dk, dv, on the JAX forward's out and lse) within
the tolerance the card holds the kernels to: 1e-5 * max(1, max|JAX|) plus
1 bf16 ulp of the element, lse within 1e-5 relative. With one bf16 part
the same check fails: the second part is what the tolerance needs.

On fp32 heads with D <= 64 the backward's products are 3xTF32 warpgroup
products (``csrc/wgmma_tf32.cuh``): the tensor cores take an fp32 operand's
top 19 bits (its TF32 value, the low 13 bits ignored, as the card's
self-test found), so each operand is hi = that value and lo = the TF32 value
of x - hi, and a product is lo.hi + hi.lo + hi.hi. ``_tf32_route_backward``
does the same in fp32 PyTorch, held to ``jax.vjp`` within
1e-5 * max(1, max|JAX|); with the hi.hi pass alone it misses that bound.
"""

import functools
import importlib
import importlib.util
import os

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
TOL = 1e-5
B, T, H, D = 2, 64, 2, 16
TILE = 16  # keys per tile of the emulated online softmax, and the JAX blocks
F32_MIN = float(np.finfo(np.float32).min)

CASES = {  # causal, padded
    "causal": (True, False),
    "padded": (False, True),
    "padded_causal": (True, True),
}


def _parts(x, n):
    """x as n bf16 parts (each widened to fp32): hi, then what is left."""
    parts, rest = [], x
    for _ in range(n):
        part = rest.to(BF16).float()
        parts.append(part)
        rest = rest - part
    return parts


def _split_mm(a, b, n):
    """a @ b with fp32 a split into n bf16 parts and b exact in bf16: one
    product per part, summed in fp32."""
    return sum(p @ b for p in _parts(a, n))


def _valid(maskh, causal, t, j0, j1):
    valid = (maskh[:, None, j0:j1] > -1e29).expand(maskh.shape[0], t, j1 - j0)
    if causal:
        valid = valid & (torch.arange(t)[:, None] >= torch.arange(j0, j1)[None])[None]
    return valid


def _route_forward(q, k, v, mask, causal, n_parts):
    """The bf16 forward kernel's rounding on folded bf16 heads: out (bf16)
    and lse (fp32)."""
    bh, t, d = q.shape
    maskh = mask.repeat_interleave(bh // mask.shape[0], 0)
    q32, k32, v32 = q.float(), k.float(), v.float()
    m = torch.full((bh, t, 1), -1e30)
    l = torch.zeros((bh, t, 1))
    acc = torch.zeros((bh, t, d))
    for j in range(0, t, TILE):
        s = (q32 @ k32[:, j : j + TILE].transpose(1, 2)) * d**-0.5 + maskh[:, None, j : j + TILE]
        valid = _valid(maskh, causal, t, j, j + TILE)
        new_m = torch.maximum(m, torch.where(valid, s, -1e30).amax(-1, keepdim=True))
        corr = torch.exp(m - new_m)
        p = torch.where(valid, torch.exp(s - new_m), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _split_mm(p, v32[:, j : j + TILE], n_parts)
        m = new_m
    out = (acc / l.clamp_min(1e-37)).to(BF16)
    return out, torch.where(l > 0, m + torch.log(l.clamp_min(1e-37)), 1e30)[..., 0]


def _route_backward(q, k, v, mask, out, lse, do, causal, n_parts):
    """The bf16 backward kernel's rounding: dq, dk, dv in bf16."""
    bh, t, d = q.shape
    maskh = mask.repeat_interleave(bh // mask.shape[0], 0)
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    scale = d**-0.5
    delta = (do32 * out.float()).sum(-1)
    s = (q32 @ k32.transpose(1, 2)) * scale + maskh[:, None, :]
    p = torch.where(_valid(maskh, causal, t, 0, t), torch.exp(s - lse[..., None]), 0.0)
    ds = p * (do32 @ v32.transpose(1, 2) - delta[..., None])
    dq = _split_mm(ds, k32, n_parts) * scale
    dk = _split_mm(ds.transpose(1, 2), q32, n_parts) * scale
    dv = _split_mm(p.transpose(1, 2), do32, n_parts)
    return dq.to(BF16), dk.to(BF16), dv.to(BF16)


def _inputs(seed, padded):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(4))
    mask = np.zeros((B, T), np.float32)
    if padded:
        mask[0, 50:] = -1e30
        mask[1, 40:] = F32_MIN
    return q, k, v, do, mask


def _fold(x):
    """A JAX (B, T, H, D) array as folded (B*H, T, D) torch heads, keeping
    its dtype (bf16 stays bf16)."""
    t = torch.from_numpy(np.array(x.astype(jnp.float32)))
    if x.dtype == jnp.bfloat16:
        t = t.to(BF16)
    return t.permute(0, 2, 1, 3).reshape(B * H, T, D)


def _unfold(x):
    return x.reshape(B, H, T, D).permute(0, 2, 1, 3)


def _tf32(x):
    """x's TF32 value as the tensor cores take it: the low 13 bits of each
    fp32 bit pattern cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_mm(a, b, passes):
    """a @ b as the fp32 route's products: lo_a.hi_b + hi_a.lo_b + hi_a.hi_b
    with hi = _tf32(x) and lo = _tf32(x - hi) (3 passes), or hi_a.hi_b (1)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tf32_route_backward(q, k, v, mask, out, lse, do, causal, passes):
    """The fp32 backward kernels' products on folded fp32 heads: dq, dk, dv."""
    bh, t, d = q.shape
    maskh = mask.repeat_interleave(bh // mask.shape[0], 0)
    scale = d**-0.5
    delta = (do * out).sum(-1)
    s = _tf32_mm(q, k.transpose(1, 2), passes) * scale + maskh[:, None, :]
    p = torch.where(_valid(maskh, causal, t, 0, t), torch.exp(s - lse[..., None]), 0.0)
    ds = p * (_tf32_mm(do, v.transpose(1, 2), passes) - delta[..., None])
    dq = _tf32_mm(ds, k, passes) * scale
    dk = _tf32_mm(ds.transpose(1, 2), q, passes) * scale
    dv = _tf32_mm(p.transpose(1, 2), do, passes)
    return dq, dk, dv


def _jax_kernel_bf16(jq, jk, jv, mask, causal):
    """The Pallas ``_flash_kernel`` in interpret mode on (B, T, H, D) inputs
    of bf16 (or fp32): (out in their dtype, lse fp32), folded."""
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(B * H, T, D)  # noqa: E731
    kernel = functools.partial(jfa._flash_kernel, TILE, TILE, T, causal, 1.0 / D**0.5)
    out, lse = pl.pallas_call(
        kernel,
        grid=(B * H, T // TILE),
        in_specs=[
            pl.BlockSpec((1, TILE, D), lambda i, j: (i, j, 0)),
            pl.BlockSpec((1, T, D), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((1, T, D), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((1, T), lambda i, j: (i // H, 0)),
        ],
        out_specs=[
            pl.BlockSpec((1, TILE, D), lambda i, j: (i, j, 0)),
            pl.BlockSpec((1, TILE), lambda i, j: (i, j)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((B * H, T, D), jq.dtype),
            jax.ShapeDtypeStruct((B * H, T), jnp.float32),
        ],
        interpret=True,
    )(fold(jq), fold(jk), fold(jv), jnp.asarray(mask))
    return out, torch.from_numpy(np.array(lse))


def _bf16_ulp(x):
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), (e - 8).clamp_min(-133))


def _within(got, want):
    """Each element within TOL * max(1, max|want|) plus 1 bf16 ulp of want's."""
    err = (got.float() - want.float()).abs()
    return bool((err <= TOL * max(1.0, want.float().abs().max().item()) + _bf16_ulp(want)).all())


def _lse_within(got, want):
    return bool(((got - want).abs() <= TOL * want.abs().clamp_min(1.0)).all())


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_route_forward_matches_jax_kernel(case):
    """The bf16 forward's rounding (exact bf16 q.k, P in two bf16 parts)
    against the Pallas kernel on the same bf16 inputs."""
    causal, padded = CASES[case]
    q, k, v, _, mask = _inputs(11, padded)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want_out, want_lse = _jax_kernel_bf16(jq, jk, jv, mask, causal)
    qf, kf, vf = _fold(jq), _fold(jk), _fold(jv)
    out, lse = _route_forward(qf, kf, vf, torch.from_numpy(mask), causal, 2)
    want_out = torch.from_numpy(np.array(want_out.astype(jnp.float32))).to(BF16)
    assert out.dtype == BF16 and _within(out, want_out)
    assert _lse_within(lse, want_lse)
    # one bf16 P keeps 8 bits: out misses the tolerance
    assert not _within(_route_forward(qf, kf, vf, torch.from_numpy(mask), causal, 1)[0], want_out)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_route_backward_matches_jax_vjp(case):
    """The bf16 backward's rounding (exact bf16 S and dP, P and dS in two
    bf16 parts) on the JAX forward's out and lse against ``jax.vjp`` of
    ``flash_attention`` with the same cotangent."""
    causal, padded = CASES[case]
    q, k, v, do, mask = _inputs(12, padded)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, do))

    def attn(q, k, v):
        return jfa.flash_attention(q, k, v, jnp.asarray(mask), causal=causal, block_q=TILE, block_k=TILE, interpret=True)

    out, vjp = jax.vjp(attn, jq, jk, jv)
    want = [torch.from_numpy(np.array(g.astype(jnp.float32))).to(BF16) for g in vjp(jdo)]
    _, lse = _jax_kernel_bf16(jq, jk, jv, mask, causal)
    args = (_fold(jq), _fold(jk), _fold(jv), torch.from_numpy(mask), _fold(out), lse, _fold(jdo), causal)
    got = [_unfold(g) for g in _route_backward(*args, 2)]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == BF16 and _within(g, w), name
    one_part = [_unfold(g) for g in _route_backward(*args, 1)]
    assert not all(_within(g, w) for g, w in zip(one_part, want))


@pytest.mark.parametrize("case", list(CASES))
def test_tf32_route_backward_matches_jax_vjp(case):
    """The fp32 backward's 3xTF32 products (hi the TF32 value the tensor
    cores take, lo the TF32 value of the rest) on the JAX forward's out and
    lse against ``jax.vjp`` of ``flash_attention`` on fp32 inputs, within
    1e-5 * max(1, max|JAX|); one TF32 pass alone misses that bound."""
    causal, padded = CASES[case]
    q, k, v, do, mask = _inputs(14, padded)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))

    def attn(q, k, v):
        return jfa.flash_attention(q, k, v, jnp.asarray(mask), causal=causal, block_q=TILE, block_k=TILE, interpret=True)

    out, vjp = jax.vjp(attn, jq, jk, jv)
    want = [torch.from_numpy(np.array(g)) for g in vjp(jdo)]
    _, lse = _jax_kernel_bf16(jq, jk, jv, mask, causal)
    args = (_fold(jq), _fold(jk), _fold(jv), torch.from_numpy(mask), _fold(out), lse, _fold(jdo), causal)

    def within(g, w):
        return bool(((g - w).abs() <= TOL * max(1.0, w.abs().max().item())).all())

    got = [_unfold(g) for g in _tf32_route_backward(*args, 3)]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and within(g, w), name
    one_pass = [_unfold(g) for g in _tf32_route_backward(*args, 1)]
    assert not all(within(g, w) for g, w in zip(one_pass, want))


def test_vjp_runs_the_plain_backward_on_cpu_and_refuses_other_devices():
    rng = np.random.RandomState(13)
    qf, kf, vf, do = (torch.from_numpy(rng.randn(4, 32, 8).astype(np.float32)) for _ in range(4))
    mask = torch.zeros((2, 32))
    mask[1, 20:] = -1e30
    out, lse = fa.flash_attention_fwd(qf, kf, vf, mask, True, 16, 16, 8**-0.5)
    got = fa.flash_attention_vjp(qf, kf, vf, mask, out, lse, do, True, 16, 8**-0.5, True)
    want = fa.flash_attention_bwd(qf, kf, vf, mask, out, lse, do, True, 16, 8**-0.5, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fa.flash_attention_vjp(qf, kf, vf, mask, out, lse, do, True, 16, 8**-0.5, False)[3] is None
    meta = [x.to("meta") for x in (qf, kf, vf, mask, out, lse, do)]
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_vjp(*meta, True, 16, 8**-0.5, False)


def _bwd_operands(dtype=torch.float32, **dtypes):
    x = {name: torch.zeros((4, 16, 8), dtype=dtypes.get(name, dtype)) for name in ("q", "k", "v", "out", "do")}
    return x["q"], x["k"], x["v"], torch.zeros((2, 16)), x["out"], torch.zeros((4, 16)), x["do"]


@pytest.mark.parametrize(
    "dtypes",
    [{"dtype": torch.float16}, {"k": torch.float32, "dtype": BF16}, {"do": BF16}, {"out": BF16, "do": BF16}],
    ids=["fp16", "mixed_heads", "do_of_another_dtype", "out_and_do_of_another_dtype"],
)
def test_backward_kernel_refuses_dtypes_before_launching(dtypes):
    """The checks run before anything is built or launched, so they hold on
    the CPU too: fp16, a mix of fp32 and bf16 heads, and a dO (or out and
    dO) of another dtype than the heads raise TypeError."""
    launches = {k: v.launches for k, v in fa.BWD_KERNELS.items()}
    with pytest.raises(TypeError):
        fa._launch_bwd(*_bwd_operands(**dtypes), False, 0.3, False)
    assert {k: v.launches for k, v in fa.BWD_KERNELS.items()} == launches


def test_backward_kernel_refuses_shapes_before_launching():
    q, k, v, mask, out, lse, do = _bwd_operands()
    with pytest.raises(ValueError, match="differ"):
        fa._launch_bwd(q, k, v, mask, out, lse, do[:, :8], False, 0.3, False)
    with pytest.raises(ValueError, match="lse"):
        fa._launch_bwd(q, k, v, mask, out, lse[:, :8], do, False, 0.3, False)
    with pytest.raises(TypeError, match="mask"):
        fa._launch_bwd(q, k, v, mask.double(), out, lse, do, False, 0.3, False)
    big = torch.zeros((4, 16, 160))
    with pytest.raises(ValueError, match="head dim"):
        fa._launch_bwd(big, big, big, mask, big, lse, big, False, 0.3, False)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_backward_bound_at_gpt2_small():
    """One GPT-2 small step's 12 causal backwards at (16 x 12, 1024, 64):
    five products of 2 D FLOP over T (T + 1) / 2 pairs a head, 7.74e11
    FLOP; q, k, v, out, dO read and dq, dk, dv written once, 2.43 GB in
    bf16 with the fp32 mask and lse; 0.78 ms at the bf16 peak (operations),
    4.69 ms at 3xTF32 in fp32."""
    cs = _chip_smoke()
    nbytes, ops = cs.attention_bwd_work(16, 1024, 12, 64, 12, elem_bytes=2, causal=True)
    assert ops == 12 * 5 * 2 * 64 * 192 * 1024 * 1025 // 2 and round(ops / 1e9) == 774
    assert nbytes == 12 * (2 * 8 * 192 * 1024 * 64 + 4 * (16 * 1024 + 192 * 1024)) and round(nbytes / 1e7) == 243
    ms, by = cs.attention_bwd_bound(16, 1024, 12, 64, 12, flops=cs.BF16_FLOPS, elem_bytes=2, causal=True)
    assert by == "operations" and round(ms, 2) == 0.78
    ms, by = cs.attention_bwd_bound(16, 1024, 12, 64, 12, causal=True)
    assert by == "operations" and round(ms, 2) == 4.69
    # with padding, the real keys: k and v read for them only, pairs to them only
    nbytes, ops = cs.attention_bwd_work(2, 256, 3, 64, 1, keys=300, elem_bytes=4)
    assert ops == 5 * 2 * 64 * 3 * 256 * 300
    assert nbytes == 4 * (6 * 6 * 256 * 64 + 2 * 3 * 64 * 300) + 4 * (2 * 256 + 6 * 256)
