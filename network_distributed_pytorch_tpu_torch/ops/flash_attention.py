"""Flash attention (K5): the CUDA kernels, forward and backward, their
plain versions and the wrapper.

Replaces the JAX package's ``ops/flash_attention.py``: ``_flash_kernel``,
the Pallas TPU kernel behind ``flash_attention``, becomes
``csrc/flash_attention.cu``, and ``_flash_bwd_chunked``, its ``custom_vjp``
backward (a ``lax.scan`` in the JAX package), becomes
``csrc/flash_attention_bwd.cu`` (each source's header says how it is laid
out on Hopper and what bounds it). Exact softmax attention over folded
``(B*H, T, D)`` heads with scale ``1/sqrt(D)`` applied to q, an additive
``(B, T)`` key mask shared over heads, and the per-row log-sum-exp.

- :func:`flash_attention_reference` is the forward's plain version,
  ``_flash_kernel`` step by step over ``(block_q, block_k)`` tiles;
- :func:`flash_attention_bwd` is the backward's plain version,
  ``_flash_bwd_chunked`` as PyTorch tensor code, one K block at a time, so
  the ``(T, T)`` scores never exist whole;
- :func:`flash_attention_fwd` and :func:`flash_attention_vjp` are the
  forward and the backward on folded heads: the kernel on CUDA tensors,
  the plain version on CPU tensors, nothing else;
- :func:`flash_attention` is the public wrapper with the JAX signature and
  ``(B, T, H, D)`` layout, differentiable through a
  ``torch.autograd.Function``.

Mask values at or below ``_MASK_PAD`` are padding and are excluded by a
validity flag, never by exp underflow: a padding value of ``-1e30`` ties the
running-max start, and ``finfo(f32).min`` plus a score can round to -inf.
A fully masked row gives out = 0 and lse = ``_LSE_EMPTY``.

On CUDA the kernels take q, k and v all fp32 or all bf16 (the mask stays
fp32; the backward's out and dO in the heads' dtype) and raise
``TypeError`` on any other dtype or a mix; bf16 heads are read as bf16 by
the kernels, never copied to fp32 first, and ``out`` and the gradients come
back in their dtype, ``lse`` and the mask's gradient in fp32, as the JAX
functions give them. The plain versions widen every tile to fp32 and round
``out`` and each gradient to its input's dtype once, at the end; so do the
kernels. The folding transposes stay torch copies.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_NEG_INF = -1e30  # running-max start; finite, so m - new_m stays finite
_LSE_EMPTY = 1e30  # lse of a fully masked row: exp(s - 1e30) == 0
_MASK_PAD = -1e29  # additive mask values at or below this are padding
MAX_HEAD_DIM = 128

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F]
# one entry of the kernel per dtype of q, k and v; each counts its launches
# by kind: "causal" or "masked" (not causal, the mask given or zero)
KERNELS = {
    torch.float32: _build.Kernel("flash_attention", "flash_attention", "flash_attention_fwd_f32", _ARGS),
    torch.bfloat16: _build.Kernel("flash_attention_bf16", "flash_attention", "flash_attention_fwd_bf16", _ARGS),
}
KERNEL = KERNELS[torch.float32]
KERNEL_BF16 = KERNELS[torch.bfloat16]
# q, k, v, mask, out, lse, do, dq, dk, dv, the (BH, T) fp32 scratch of
# rowsum(dO * out), the (BH, T) fp32 per-head column sums of dS (or null:
# no mask gradient); bh, T, D, H, causal; scale
_BWD_ARGS = [_P] * 12 + [_I] * 5 + [_F]
# the backward, one entry per dtype (three launches behind each, counted as
# one), by kind as the forward
BWD_KERNELS = {
    torch.float32: _build.Kernel("flash_attention_bwd", "flash_attention_bwd", "flash_attention_bwd_f32", _BWD_ARGS),
    torch.bfloat16: _build.Kernel(
        "flash_attention_bwd_bf16", "flash_attention_bwd", "flash_attention_bwd_bf16", _BWD_ARGS
    ),
}


# ---- plain versions ------------------------------------------------------


def flash_attention_reference(
    qf: torch.Tensor,
    kf: torch.Tensor,
    vf: torch.Tensor,
    mask: torch.Tensor,
    causal: bool,
    block_q: int,
    block_k: int,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_flash_kernel`` over every (head, q block): ``qf``, ``kf``, ``vf``
    are ``(BH, T, D)``, ``mask`` is ``(B, T)`` with head ``bh`` reading row
    ``bh // H``. Returns ``out`` (BH, T, D) in q's dtype and ``lse``
    (BH, T) fp32."""
    bh, t, d = qf.shape
    h = bh // mask.shape[0]
    maskh = mask.float().repeat_interleave(h, dim=0)  # (BH, T)
    n_blocks = t // block_k
    rows = torch.arange(block_q, device=qf.device)[:, None]
    cols = torch.arange(block_k, device=qf.device)[None, :]
    outs, lses = [], []
    for qi in range(t // block_q):
        q = qf[:, qi * block_q : (qi + 1) * block_q].float() * scale
        # causal: K blocks strictly past this Q block's last row are skipped
        hi = min(-(-(qi + 1) * block_q // block_k), n_blocks) if causal else n_blocks
        m = torch.full((bh, block_q, 1), _NEG_INF, device=qf.device)
        l = torch.zeros((bh, block_q, 1), device=qf.device)
        acc = torch.zeros((bh, block_q, d), device=qf.device)
        for j in range(hi):
            ks = slice(j * block_k, (j + 1) * block_k)
            k_blk, v_blk = kf[:, ks].float(), vf[:, ks].float()
            s = torch.bmm(q, k_blk.transpose(1, 2))  # (BH, block_q, block_k)
            mask_blk = maskh[:, ks][:, None, :]
            valid = (mask_blk > _MASK_PAD).expand(bh, block_q, block_k)
            s = s + mask_blk
            if causal:
                keep = qi * block_q + rows >= j * block_k + cols
                valid = valid & keep
                s = torch.where(keep, s, _NEG_INF)
            blk_max = torch.where(valid, s, _NEG_INF).amax(-1, keepdim=True)
            new_m = torch.maximum(m, blk_max)
            correction = torch.exp(m - new_m)
            p = torch.where(valid, torch.exp(s - new_m), 0.0)
            l = l * correction + p.sum(-1, keepdim=True)
            acc = acc * correction + torch.bmm(p, v_blk)
            m = new_m
        outs.append(acc / l.clamp_min(1e-37))
        lses.append(torch.where(l > 0, m + torch.log(l.clamp_min(1e-37)), _LSE_EMPTY)[..., 0])
    return torch.cat(outs, 1).to(qf.dtype), torch.cat(lses, 1)


def flash_attention_bwd(
    qf: torch.Tensor,
    kf: torch.Tensor,
    vf: torch.Tensor,
    mask: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool,
    block_k: int,
    scale: float,
    need_dmask: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """``_flash_bwd_chunked``: per K block, recompute ``P = exp(S - lse)``
    with padded keys forced to 0, then ``dV = P^T dO``,
    ``dS = P * (dO V^T - D)``, ``dQ += dS K``, ``dK = dS^T Q`` and the
    mask's gradient, ``dS`` summed over heads and q rows (None unless
    ``need_dmask``). Shapes are the folded ``(BH, T, D)``."""
    bh, t, d = qf.shape
    b = mask.shape[0]
    h = bh // b
    q32, k32, v32, do32 = qf.float(), kf.float(), vf.float(), do.float()
    delta = (do32 * out.float()).sum(-1)  # (BH, T)
    maskh = mask.repeat_interleave(h, dim=0)
    q_pos = torch.arange(t, device=qf.device)[:, None]
    k_off = torch.arange(block_k, device=qf.device)[None, :]
    dq = torch.zeros_like(q32)
    dmask = torch.zeros_like(mask) if need_dmask else None
    dks, dvs = [], []
    for j in range(t // block_k):
        ks = slice(j * block_k, (j + 1) * block_k)
        k_blk, v_blk, m_blk = k32[:, ks], v32[:, ks], maskh[:, ks]
        s = torch.bmm(q32, k_blk.transpose(1, 2)) * scale + m_blk[:, None, :]
        if causal:
            s = s + torch.where(q_pos >= j * block_k + k_off, 0.0, _NEG_INF)[None]
        p = torch.exp(s - lse[:, :, None])  # (BH, T, block_k)
        p = torch.where((m_blk > _MASK_PAD)[:, None, :], p, 0.0)
        dp = torch.bmm(do32, v_blk.transpose(1, 2))
        ds = p * (dp - delta[:, :, None])
        dq = dq + torch.bmm(ds, k_blk) * scale
        dks.append(torch.bmm(ds.transpose(1, 2), q32) * scale)
        dvs.append(torch.bmm(p.transpose(1, 2), do32))
        if need_dmask:
            dmask[:, ks] = ds.reshape(b, h, t, block_k).sum((1, 2)).to(mask.dtype)
    dk, dv = torch.cat(dks, 1), torch.cat(dvs, 1)
    return dq.to(qf.dtype), dk.to(kf.dtype), dv.to(vf.dtype), dmask


# ---- the kernels ---------------------------------------------------------


def _check(name, qf, kf, vf, mask, *others):
    """What both kernels need of their operands: one CUDA device; q, k, v
    (and ``others``, the backward's out and dO) all fp32 or all bf16, of one
    (BH, T, D) shape; an fp32 (B, T) mask; D <= 128; int indexing."""
    devices = {x.device for x in (qf, kf, vf, mask, *others)}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on {sorted(map(str, devices))}; need one CUDA device")
    what = "q, k, v, out, do" if others else "q, k, v"
    dtypes = tuple(x.dtype for x in (qf, kf, vf, *others))
    if qf.dtype not in KERNELS or len(set(dtypes)) != 1:
        raise TypeError(f"{name}: the CUDA kernel takes {what} all float32 or all bfloat16, got {dtypes}")
    if mask.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes a float32 mask, got {mask.dtype}")
    bh, t, d = qf.shape
    shapes = [tuple(x.shape) for x in (qf, kf, vf, *others)]
    if len(set(shapes)) != 1:
        raise ValueError(f"{name}: {what} shapes {shapes} differ")
    if mask.dim() != 2 or mask.shape[1] != t or bh % mask.shape[0]:
        raise ValueError(f"{name}: mask {tuple(mask.shape)} does not fit {bh} heads of length {t}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {MAX_HEAD_DIM}")
    if bh * t * d >= 2**31:
        raise ValueError(f"{name}: {bh} x {t} x {d} is too large for the kernel's int indexing")


def _launch(qf, kf, vf, mask, causal: bool, scale: float):
    _check("flash_attention", qf, kf, vf, mask)
    bh, t, d = qf.shape
    qf, kf, vf, mask = (x.contiguous() for x in (qf, kf, vf, mask))
    out = torch.empty_like(qf)
    lse = torch.empty((bh, t), dtype=torch.float32, device=qf.device)
    if out.numel():
        KERNELS[qf.dtype].launch(
            qf.device, qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), bh, t, d, bh // mask.shape[0], int(causal), scale,
            kind="causal" if causal else "masked",
        )
    return out, lse


def _launch_bwd(qf, kf, vf, mask, out, lse, do, causal: bool, scale: float, need_dmask: bool):
    name = "flash_attention backward"
    if do.dtype != out.dtype:
        raise TypeError(f"{name}: do is {do.dtype}, out {out.dtype}; the CUDA kernel takes them of one dtype")
    _check(name, qf, kf, vf, mask, out, do)
    bh, t, d = qf.shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != (bh, t) or lse.device != qf.device:
        raise ValueError(
            f"{name}: lse must be float32 ({bh}, {t}) on {qf.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}"
        )
    qf, kf, vf, mask, out, lse, do = (x.contiguous() for x in (qf, kf, vf, mask, out, lse, do))
    dq, dk, dv = (torch.empty_like(qf) for _ in range(3))
    delta = torch.empty((bh, t), dtype=torch.float32, device=qf.device)
    part = torch.zeros((bh, t), dtype=torch.float32, device=qf.device) if need_dmask else None
    if dq.numel():
        BWD_KERNELS[qf.dtype].launch(
            qf.device, qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), mask.data_ptr(), out.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            part.data_ptr() if need_dmask else None, bh, t, d, bh // mask.shape[0], int(causal), scale,
            kind="causal" if causal else "masked",
        )
    dmask = part.view(mask.shape[0], bh // mask.shape[0], t).sum(1) if need_dmask else None
    return dq, dk, dv, dmask


def wgmma_tf32_selftest(a: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    """``a @ b`` on one warpgroup by the backward library's TF32 self-test
    (``flash_bwd_wgmma_tf32_selftest``; ``csrc/flash_attention_bwd.cu`` gives
    the modes: 0 and 1 one pass from shared memory or registers, 2 and 3 the
    fp32 kernels' 3xTF32 products): ``a`` (64, k) and ``b`` (k, 64) fp32 on
    one CUDA device. A check of the fp32 backward's building blocks, on no
    path of the port."""
    k = a.shape[1]
    if a.dtype != torch.float32 or b.dtype != torch.float32 or a.device.type != "cuda" or b.device != a.device:
        raise ValueError("wgmma_tf32_selftest: a and b must be float32 on one CUDA device")
    if tuple(a.shape) != (64, k) or tuple(b.shape) != (k, 64) or k not in ((64,) if mode == 2 else (8, 32, 64, 128)):
        raise ValueError(f"wgmma_tf32_selftest: shapes {tuple(a.shape)}, {tuple(b.shape)} for mode {mode}")
    fn = _build.load("flash_attention_bwd").flash_bwd_wgmma_tf32_selftest
    fn.argtypes = [_P, _P, _P, _I, _I, _P]
    fn.restype = _I
    a, b = a.contiguous(), b.contiguous()
    c = torch.full((64, 64), float("nan"), device=a.device)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), k, mode, torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"wgmma_tf32_selftest: CUDA launch failed with error {err}")
    return c


def flash_attention_fwd(qf, kf, vf, mask, causal: bool, block_q: int, block_k: int, scale: float):
    """The forward on folded heads, ``(out, lse)``: the plain version on CPU
    tensors, the kernel on CUDA tensors (its own 64 x 64 tiles; the results
    agree with the plain version's up to fp32 summation order, before a bf16
    ``out``'s one rounding)."""
    if qf.device.type == "cpu":
        return flash_attention_reference(qf, kf, vf, mask, causal, block_q, block_k, scale)
    if qf.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {qf.device}")
    return _launch(qf, kf, vf, mask, causal, scale)


def flash_attention_vjp(qf, kf, vf, mask, out, lse, do, causal: bool, block_k: int, scale: float, need_dmask: bool):
    """The backward on folded heads, ``(dq, dk, dv, dmask)`` (dmask None
    unless ``need_dmask``): the plain version on CPU tensors, the kernel on
    CUDA tensors (its own 64-row tiles; the results agree with the plain
    version's up to fp32 summation order, before a bf16 gradient's one
    rounding)."""
    if qf.device.type == "cpu":
        return flash_attention_bwd(qf, kf, vf, mask, out, lse, do, causal, block_k, scale, need_dmask)
    if qf.device.type != "cuda":
        raise ValueError(f"flash_attention backward: unsupported device {qf.device}")
    return _launch_bwd(qf, kf, vf, mask, out, lse, do, causal, scale, need_dmask)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qf, kf, vf, mask, causal, block_q, block_k, scale):
        out, lse = flash_attention_fwd(qf, kf, vf, mask, causal, block_q, block_k, scale)
        ctx.save_for_backward(qf, kf, vf, mask, out, lse)
        ctx.causal, ctx.block_k, ctx.scale = causal, block_k, scale
        return out

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, mask, out, lse = ctx.saved_tensors
        dq, dk, dv, dmask = flash_attention_vjp(
            qf, kf, vf, mask, out, lse, do, ctx.causal, ctx.block_k, ctx.scale, ctx.needs_input_grad[3]
        )
        return dq, dk, dv, dmask, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Exact attention without the score matrix. ``q``, ``k``, ``v`` are
    ``(B, T, H, D)``; ``mask`` an optional ``(B, T)`` additive key mask
    (0 = attend, very negative = padding). Returns ``(B, T, H, D)`` in q's
    dtype; differentiable in q, k, v and the mask."""
    b, t, h, d = q.shape
    block_q, block_k = min(block_q, t), min(block_k, t)
    if t % block_q or t % block_k:
        raise ValueError(
            f"T={t} must divide into blocks ({block_q}, {block_k}); pad the"
            " sequence (and mask the pads) first"
        )
    scale = 1.0 / float(d) ** 0.5

    def fold(x):  # (B, T, H, D) -> (B*H, T, D)
        return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()

    if mask is None:
        mask = torch.zeros((b, t), dtype=torch.float32, device=q.device)
    mask = mask.to(torch.float32)
    out = _FlashAttention.apply(fold(q), fold(k), fold(v), mask, causal, block_q, block_k, scale)
    return out.reshape(b, h, t, d).permute(0, 2, 1, 3)
