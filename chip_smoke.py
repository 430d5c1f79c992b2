#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. the card (``nvidia-smi``), torch and CUDA versions, and the build of
   every CUDA kernel of the port (one ``nvcc`` per source, started together);
2. with TF32 off, each kernel against its plain PyTorch version on the card:
   the Gram-Schmidt kernel (K1) at every (g, n, r) shape group of the
   ResNet path (ResNet-152, rank 4) and of the DistilBERT path
   (``distilbert_base``, rank 16, n = 30522 for the word table), a ragged
   n = 100, r in {1, 8, 32} at n = 4608, (1, 30522, 32) (the streaming
   route), (1, 30523, 16), (1, 17, 16) and (25, 768, 16), with the route
   and cluster size of each and the device time of each DistilBERT group;
   the fused PowerSGD kernels
   (K2a, K2b, K3, K4) at every (g, n, m, r) shape group, a ragged
   (3, 100, 37, 8), a clipped (1, 2, 3, 2), m % 4 in {1, 2, 3} and r in
   {1, 8, 32} at n = 4608, m = 512 (r = 32 takes K3's two-launch route),
   with K3's P-hat held to K1's output bit for bit and a second launch of
   K2a, K2b and K3 to the first's bits at every shape; flash attention (K5) at
   DistilBERT's full width (B 16, T 256, H 12, D 64) with the synthetic-IMDb
   padding, without a mask, causal, with fully masked rows (-1e30 and
   finfo(f32).min), at D = 128, against the plain version's
   block_q != block_k, with left padding (real keys only in the last tile),
   one real key inside a padded tile and at T = 100; NaN in K and V of
   every all-padding tile must leave out and lse bitwise unchanged (those
   tiles are skipped, not read); one step's launches timed with the IMDb
   mask and without one, each beside SDPA on the same inputs;
3. the main paths through a one-rank NCCL group, 2 warm-up and 5 timed
   steps, then 3 steps under ``torch.profiler``, each with the launch
   counts set to 0 just before it and read just after:
   ``powersgd_cifar10.run`` with preset ``full`` (ResNet-152, ImageNet
   stem, width 64, global batch 512, PowerSGD rank 4) on the
   ``compress_impl="xla"`` path (K1) and on the fused ``"pallas"`` path
   (K2a, K3, K4); ``powersgd_imdb.run`` with preset ``full``
   (``distilbert_base``, batch 16, max_len 256, rank 16: K5 and K1);
   ``exact_cifar10.run`` with preset ``full`` (ResNet-50, ImageNet stem,
   width 64, global batch 256, exact DDP: no kernel of the port) under four
   reducer layouts (one packed payload, 25 MiB buckets, 4 chunks, the ring),
   with the bits and collectives of each, the layouts' parameters after two
   steps held equal bit for bit, one profiled step (busy time, NCCL) and the
   accuracy on the test split; ``imdb_baseline.run`` with preset ``full``
   (``distilbert_base``, batch 16, max_len 256, one process: K5) under
   Nesterov SGD and AdamW; and ``launch bare_init`` in a process of its own;
4. two steps from the same weights and batches, deterministic cuDNN: plain
   Gram-Schmidt against the kernel; fused against xla; fused against xla
   with one extra power iteration (K2b's path); the small ResNet on the card
   against the same two steps on the CPU; DistilBERT with flash attention
   (K5) against ``attn_impl="einsum"`` on the card; the tiny DistilBERT
   on the card against the CPU; and the IMDb baseline, under either
   optimizer, with flash attention against einsum on the card;
5. one ``{"kernels": [...]}`` line: each kernel's launches on its paths, its
   time for one main-path step (CUDA events, ``ms``, and the profiler's
   device time, ``device_ms``), the plain version's, one PyTorch call's
   where one computes the same function (events and device time) and the
   least time the card could take; before it, the xla path's library calls
   for the same work (CUDA events and device time).

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the port beside this script, it prints no result and exits 1.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor-core) FLOP/s
# and dense TF32 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
# K5 computes each fp32 product as three TF32 tensor-core products (3xTF32)
FP32_AS_3XTF32_FLOPS = TF32_FLOPS / 3

GS_TOL = 1e-5  # fp32 sums in another order; entries of P-hat are at most 1
# the fused kernels: P-hat as GS_TOL; P, Q, out and mem are sums of up to n
# or m products in another order, held to FUSED_TOL * max(1, max|plain|);
# M = G + E is one rounded add and must be bitwise equal
FUSED_TOL = 1e-5
PARAM_TOL = 1e-5  # the same, carried through two updates of lr 0.001
# cuDNN against PyTorch's CPU convolutions, fp32 without TF32: sums in
# another order, through a ResNet-18 and two PowerSGD steps
SMALL_TOL = 1e-4

# flash attention: out within ATTN_TOL * max(1, max|plain|) and lse within
# ATTN_TOL relative (fp32 sums over the keys in another order: the kernel
# in 64-key tiles, the plain version in block_k tiles); a fully masked row
# exactly 0 with lse 1e30
ATTN_TOL = 1e-5
# DistilBERT two-step checks (flash against einsum on the card, the tiny
# model on the card against the CPU): parameters and losses. At PowerSGD
# rank 1 every leaf is held to IMDB_TOL. At the slice's rank 16 every leaf
# whose first-step gradient has at least the rank r that the reducer gives
# it is held to IMDB_TOL; the others (the 2-label classifier, whose gradient
# has rank 1 < r = 2) get normalised rounding noise as P-hat's extra columns,
# which differs between any two summation orders, so there every leaf and
# the losses are held to IMDB_RANK16_TOL, set from the H100's readings
# (flash against einsum: 8.4e-6 in the parameters, 3.6e-6 in the losses)
IMDB_TOL = 1e-5
IMDB_RANK16_TOL = 5e-5

MAIN_STEPS, WARMUP_STEPS = 7, 2
FUSED_REPS = 10  # profiled calls per fused kernel's device time: K2b and torch.bmm have read 2.4 % apart, near the 2 % noise
PROFILE_STEPS = 3
# distilbert_base at batch 16, max_len 256: folded heads and launches per step
IMDB_B, IMDB_T, IMDB_H, IMDB_D, IMDB_LAYERS = 16, 256, 12, 64, 6
IMDB_BITS = 61_969_600  # the JAX reducer's payload bits per step over distilbert_base, rank 16
# exact DDP: every fp32 gradient of ResNet-50 (23,528,522) and of
# distilbert_base (66,955,010) once a step
EXACT_BITS = 752_912_704
BASELINE_BITS = 2_142_560_320
# the exact reducer's layouts on the main path and the collectives of each
# (25 MiB is torch DDP's default bucket cap)
EXACT_LAYOUTS = {
    "monolithic": ({}, 1),
    "bucketed": ({"bucket_bytes": 25 << 20}, 4),
    "chunked": ({"comm_chunks": 4}, 4),
    "ring": ({"comm_strategy": "ring"}, 1),
}
EXACT_PROFILE_STEPS = 1
TEXT_EVAL_BATCH = 64  # evaluate_text_classifier's batch
# Adam moves a parameter at most about lr a step (|m-hat| / sqrt(v-hat) is
# at most 1.0014 in two steps): the bound on two runs' difference where its
# gradient is zero in exact arithmetic, per step and lr
ADAM_NOISE_BOUND = 2.01


def fail(msg: str) -> None:
    sys.stderr.write(f"chip_smoke: {msg}\n")
    sys.exit(1)


def emit(obj) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def cuda_ms(fn, reps: int = 50) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls, by CUDA
    events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, part=None, reps=10):
    """Device time of the kernels whose name holds ``part`` (every kernel
    where ``part`` is None) in one call of ``fn()``, by ``torch.profiler``
    over ``reps`` calls after three warm-up calls; None where the profiler
    saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and (part is None or part in e.key)
    )
    return us / 1e3 / reps if us > 0 else None


def bound(nbytes, ops, flops=FP32_FLOPS):
    """The least time for ``nbytes`` of device memory traffic and ``ops``
    fp32 operations at ``flops`` per second: the larger of the two."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gs_ops(g, n, r):
    # per column i: norm 2n, scale n, then 4n for each of the r-i-1 later columns
    return g * (3 * n * r + 4 * n * r * (r - 1) // 2)


def gs_bound(shapes):
    """Bytes (one read and one write of every P) and fp32 operations of the
    Gram-Schmidt of every (g, n, r) in ``shapes``."""
    return bound(sum(2 * g * n * r * 4 for g, n, r in shapes), sum(gs_ops(*s) for s in shapes))


def fused_bounds(shapes):
    """The least time of each fused kernel over every (g, n, m, r) in
    ``shapes``: fp32 bytes with each input read once and each output
    written once, and fp32 operations (a multiply-add counts 2)."""
    work = {}

    def add(name, nbytes, ops):
        b, o = work.get(name, (0, 0))
        work[name] = (b + nbytes, o + ops)

    for g, n, m, r in shapes:
        nm, nr, mr = g * n * m, g * n * r, g * m * r
        add("ef_compress", 4 * (3 * nm + mr + nr), nm + 2 * nm * r)  # G, E, Q in; M, P out
        add("compress", 4 * (nm + mr + nr), 2 * nm * r)  # M, Q in; P out
        add("orthogonalize_project", 4 * (nm + 2 * nr + mr), gs_ops(g, n, r) + 2 * nm * r)  # P, M in; P-hat, Q out
        add("decompress_residual", 4 * (3 * nm + nr + mr), 2 * nm * r + nm)  # P, Q, M in; out, mem out
    return {name: (bound(*w), w[0]) for name, w in work.items()}


def attention_bound(b, t, h, d, launches, keys=None, flops=FP32_AS_3XTF32_FLOPS):
    """The least time of ``launches`` non-causal flash-attention forwards
    over (B*H, T, D) fp32 heads, ``keys`` of whose B T keys the mask lets
    through (None: every key). A padded key adds nothing to the function's
    result, so only the real keys' rows of k and v are counted: bytes are q
    and the (B, T) mask read once, k and v read once for each real key, out
    and lse written once; operations are 4 H T D (q.k and p.v) for each real
    key, at ``flops`` per second (K5 does its fp32 products as 3xTF32 on
    the tensor cores)."""
    keys = b * t if keys is None else keys
    nbytes = 4 * (2 * b * h * t * d + 2 * h * d * keys + b * t + b * h * t)
    return bound(launches * nbytes, launches * 4 * h * t * d * keys, flops)


def attention_bounds(b, t, h, d, launches, keys=None):
    """``attention_bound`` at 3xTF32 (the peak K5's products run at) and at
    the fp32 SIMT peak, by name."""
    (ms, by), (simt_ms, simt_by) = (
        attention_bound(b, t, h, d, launches, keys, flops) for flops in (FP32_AS_3XTF32_FLOPS, FP32_FLOPS)
    )
    return {
        "bound_ms": ms, "bound_by": by, "bound_ops_peak": "3xTF32 tensor cores, 495/3 TFLOP/s",
        "bound_ms_fp32_simt": simt_ms, "bound_by_fp32_simt": simt_by,
    }


def attention_tiles(mask, t, h, q_rows=128, keys=64):
    """The (head, block of ``q_rows`` q rows, tile of ``keys`` keys) triples
    of one non-causal K5 launch over the (B, T) ``mask``: all of them, and
    those it skips because no key of the tile is valid."""
    import torch

    n_tiles, n_blocks = -(-t // keys), -(-t // q_rows)
    padded = torch.full((mask.shape[0], n_tiles * keys), -1e30, device=mask.device)
    padded[:, :t] = mask
    empty = (padded.view(mask.shape[0], n_tiles, keys) <= -1e29).all(-1)  # (B, tiles)
    return h * n_blocks * mask.shape[0] * n_tiles, h * n_blocks * int(empty.sum())


def check_flash_attention(fa, dev, gen, imdb_mask):
    """K5 against its plain version on the same inputs, case by case; fails
    past ATTN_TOL or where a fully masked row is not exactly 0 / 1e30; then,
    on the IMDb-padding case, fails unless NaN in K and V of every 64-key
    tile that holds only padding leaves out and lse bitwise unchanged.
    ``imdb_mask`` is the (16, 256) additive mask of the first synthetic-IMDb
    batch. Returns the errors and the full-width inputs."""
    import torch

    f32_min = torch.finfo(torch.float32).min
    full = (IMDB_B, IMDB_T, IMDB_H, IMDB_D)
    rows_masked = torch.zeros((4, IMDB_T))
    rows_masked[0, :] = -1e30
    rows_masked[1, :] = f32_min
    rows_masked[2, 100:] = -1e30
    # real keys only in the last tile: 1 to 64 of them at the end of each row
    left = torch.full((IMDB_B, IMDB_T), f32_min)
    # one real key in the middle of tile i % 4 of row i, the rest padding
    lone = torch.full((IMDB_B, IMDB_T), f32_min)
    for i in range(IMDB_B):
        left[i, IMDB_T - 1 - (i * 13) % 64 :] = 0.0
        lone[i, 64 * (i % 4) + 30] = 0.0
    t100 = torch.zeros((IMDB_B, 100))
    t100[:, 70:] = f32_min
    t100[1::2, 20:] = f32_min
    cases = {  # (b, t, h, d), mask, causal, block_q, block_k of the plain version
        "imdb_padding": (full, imdb_mask, False, 128, 128),
        "no_mask": (full, torch.zeros((IMDB_B, IMDB_T)), False, 128, 128),
        "causal": (full, imdb_mask, True, 128, 128),
        "fully_masked_rows": ((4, IMDB_T, IMDB_H, IMDB_D), rows_masked, False, 128, 128),
        "d128": ((2, IMDB_T, 4, 128), imdb_mask[:2], True, 128, 128),
        "block_q64_block_k128": (full, imdb_mask, True, 64, 128),
        "left_padding": (full, left, False, 128, 128),
        "lone_middle_key": (full, lone, False, 128, 128),
        "t100": ((IMDB_B, 100, IMDB_H, IMDB_D), t100, False, 100, 100),
    }
    report, kept = {}, None
    for name, ((b, t, h, d), mask, causal, bq, bk) in cases.items():
        q, k, v = (torch.randn((b * h, t, d), generator=gen).to(dev) for _ in range(3))
        mask = mask.to(dev)
        out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, bq, bk, d**-0.5)
        want_out, want_lse = fa.flash_attention_reference(q, k, v, mask, causal, bq, bk, d**-0.5)
        torch.cuda.synchronize()
        err = (out - want_out).abs().max().item()
        lse_err = ((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max().item()
        tol = ATTN_TOL * max(1.0, want_out.abs().max().item())
        if not (math.isfinite(err) and err <= tol and math.isfinite(lse_err) and lse_err <= ATTN_TOL):
            fail(f"flash_attention {name}: max |kernel - plain| out {err} (tol {tol}), lse {lse_err} (tol {ATTN_TOL})")
        empty = (mask <= -1e29).all(dim=1).repeat_interleave(h)  # fully masked heads
        if empty.any():
            for o, l, who in ((out, lse, "kernel"), (want_out, want_lse, "plain")):
                if not (bool((o[empty] == 0).all()) and bool((l[empty] == 1e30).all())):
                    fail(f"flash_attention {name}: {who}'s fully masked rows are not 0 / 1e30")
        report[name] = {
            "shape": [b, t, h, d], "causal": causal, "plain_blocks": [bq, bk], "max_abs_err": err,
            "lse_max_rel_err": lse_err, "fully_masked_heads": int(empty.sum().item()),
        }
        if name == "imdb_padding":
            kept = (q, k, v, mask)
    # NaN in K and V of every all-padding tile of the IMDb case
    q, k, v, mask = kept
    empty = (mask.view(IMDB_B, IMDB_T // 64, 64) <= -1e29).all(-1).repeat_interleave(IMDB_H, 0)
    poison = empty.repeat_interleave(64, 1)[..., None]  # (BH, T, 1)
    clean = fa.flash_attention_fwd(q, k, v, mask, False, 128, 128, IMDB_D**-0.5)
    dirty = fa.flash_attention_fwd(
        q, *(torch.where(poison, float("nan"), x) for x in (k, v)), mask, False, 128, 128, IMDB_D**-0.5
    )
    torch.cuda.synchronize()
    if not (torch.equal(clean[0], dirty[0]) and torch.equal(clean[1], dirty[1])):
        fail("flash_attention: NaN in the all-padding tiles of K and V changed out or lse")
    report["imdb_padding"]["nan_poisoned_tiles"] = int(empty.sum())
    report["imdb_padding"]["nan_poisoned_bitwise_equal"] = True
    return report, kept


def check_fused_kernels(ps, gs, shapes, dev, gen, keep):
    """Each fused kernel against its plain version on the same inputs at
    every (g, n, m, r) in ``shapes``; fails past the tolerances. Returns the
    errors and K3's route per shape, and the inputs of the shapes in
    ``keep``. Each kernel's inputs are its plain predecessor's outputs. Fails
    unless K3's P-hat is K1's (``gs.gram_schmidt``) bit for bit, and unless a
    second launch of K2a, K2b and K3 on the same inputs gives the first's
    bits."""
    import torch

    report, kept = {}, {}
    for shape in shapes:
        g, n, m, r = shape
        x = {
            "grads": torch.randn((g, n, m), generator=gen).to(dev),
            "resid": torch.randn((g, n, m), generator=gen).to(dev),
            "q": torch.randn((g, m, r), generator=gen).to(dev),
        }
        got = {}
        got["m"], got["p"] = ps.fused_ef_compress(x["grads"], x["q"], x["resid"])
        x["m"], x["p"] = ps.ef_compress_reference(x["grads"], x["q"], x["resid"])
        got["p2"] = ps.fused_ef_compress(x["m"], x["q"])[1]
        want = {"m": x["m"], "p": x["p"], "p2": ps.compress_reference(x["m"], x["q"])}
        got["phat"], got["qn"] = ps.fused_orthogonalize_project(x["p"], x["m"])
        route = ps.ORTHOGONALIZE_PROJECT.last_route
        x["phat"], x["qn"] = ps.orthogonalize_project_reference(x["p"], x["m"])
        want["phat"], want["qn"] = x["phat"], x["qn"]
        got["out"], got["mem"] = ps.fused_decompress_residual(x["phat"], x["qn"], x["m"])
        want["out"], want["mem"] = ps.decompress_residual_reference(x["phat"], x["qn"], x["m"])
        k1_phat = gs.gram_schmidt(x["p"])
        again = {}
        again["m"], again["p"] = ps.fused_ef_compress(x["grads"], x["q"], x["resid"])
        again["p2"] = ps.fused_ef_compress(x["m"], x["q"])[1]
        again["phat"], again["qn"] = ps.fused_orthogonalize_project(x["p"], x["m"])
        torch.cuda.synchronize()
        if not torch.equal(got["m"], want["m"]):
            fail(f"ef_compress {shape}: M is not bitwise G + E")
        if not torch.equal(got["phat"], k1_phat):
            fail(f"orthogonalize_project {shape} ({route}): P-hat is not K1's bit for bit")
        for key, value in again.items():
            if not torch.equal(value, got[key]):
                fail(f"fused kernels {shape}: a second launch changed the bits of {key}")
        errs = {}
        for key in ("p", "p2", "phat", "qn", "out", "mem"):
            err = (got[key] - want[key]).abs().max().item()
            tol = FUSED_TOL if key == "phat" else FUSED_TOL * max(1.0, want[key].abs().max().item())
            if not math.isfinite(err) or err > tol:
                fail(f"fused kernels {shape}: max |kernel - plain| of {key} = {err} > {tol}")
            errs[key] = err
        report[str(shape)] = {
            "route": route, "phat_equals_k1": True, "second_launch_bitwise_equal": True,
            "ef_compress": {"m": 0.0, "p": errs["p"]},
            "compress": {"p": errs["p2"]},
            "orthogonalize_project": {"phat": errs["phat"], "q": errs["qn"]},
            "decompress_residual": {"out": errs["out"], "mem": errs["mem"]},
        }
        if shape in keep:
            kept[shape] = x
    return report, kept


def profile_main_path(dev, experiment, cfg, arrays, kernels, steps=PROFILE_STEPS, build=None):
    """Where a main-path step's time goes: ``torch.profiler`` over ``steps``
    steps of ``experiment``'s full preset with ``cfg`` on the data
    ``arrays`` through a one-rank NCCL group, after one warm-up step;
    ``build(group)`` makes the model, step and state where
    ``experiment.build`` does not take a group. ``kernels`` maps each port
    kernel to a part of its device function's name. NCCL's kernels are
    summed apart. Device numbers are None where the profiler saw no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )

    group = initialize_distributed(DistributedConfig(), dev)
    try:
        model, step, state = (build or (lambda g: experiment.build(cfg, "full", dev, g)))(group)
        batches = [
            tuple(torch.from_numpy(a).to(dev) for a in b)
            for b in accumulated_batches(arrays, cfg, 1 + steps)(0)
        ]
        state, loss = step(state, batches[0])
        loss.item()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches[1:]:
                state, loss = step(state, b)
                loss.item()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        del model, step, state
    finally:
        shutdown_distributed()
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / steps
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:10]
    seen = busy_ms > 0
    per_kernel = {}
    for name, part in kernels.items():
        evs = [e for e in device if part in e.key]
        total_us, count = sum(e.self_device_time_total for e in evs), sum(e.count for e in evs)
        per_kernel[name] = {
            "launches_per_step": count / steps,
            "device_ms_per_step": total_us / 1e3 / steps if seen else None,
            "device_us_per_launch": total_us / max(count, 1) if seen else None,
        }
    nccl = [e for e in device if "nccl" in e.key.lower()]
    return {
        "phase": "profile", "experiment": experiment.__name__.rsplit(".", 1)[-1],
        "compress_impl": cfg.compress_impl, "steps": steps,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms if seen else None,
        "device_idle_share": 1 - busy_ms / wall_ms if seen else None,
        "kernels": per_kernel,
        "nccl_ms_per_step": sum(e.self_device_time_total for e in nccl) / 1e3 / steps if seen else None,
        "nccl_kernels": [
            {"name": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / steps, "calls_per_step": e.count / steps}
            for e in nccl
        ],
        "top_kernels": [
            {
                "name": e.key[:90],
                "ms_per_step": e.self_device_time_total / 1e3 / steps,
                "calls_per_step": e.count / steps,
            }
            for e in top
        ],
    }


def main_path_record(name, result, cfg, peak, model="resnet152"):
    """The ``main_path`` line of one run of ``powersgd_cifar10.run`` or
    ``exact_cifar10.run`` (``model``); fails on a non-finite loss."""
    import statistics

    losses = result["losses"]
    if len(losses) != MAIN_STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"{name} losses {losses}")
    timed_ms = result["device_time_ms"][WARMUP_STEPS:]
    p50_ms = statistics.median(timed_ms)
    return {
        "phase": name, "model": model, "stem": "imagenet", "width": 64,
        "global_batch": cfg.global_batch_size, "world_size": result["num_devices"], "losses": losses,
        "timed_steps": len(timed_ms), "step_device_ms": timed_ms,
        "step_device_ms_p50": p50_ms,
        "step_host_s_p50": statistics.median(result["step_time_s"][WARMUP_STEPS:]),
        "images_per_s": cfg.global_batch_size / (p50_ms / 1e3),
        "peak_memory_bytes": peak, "bits_per_step": result["bits_per_step"],
    }


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from network_distributed_pytorch_tpu_torch.data.cifar10 import load_cifar10_or_synthetic
        from network_distributed_pytorch_tpu_torch.data.imdb import prepare_imdb
        from network_distributed_pytorch_tpu_torch.experiments import (
            exact_cifar10,
            imdb_baseline,
            powersgd_cifar10,
            powersgd_imdb,
        )
        from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches
        from network_distributed_pytorch_tpu_torch.ops import _build
        from network_distributed_pytorch_tpu_torch.ops import flash_attention as fa
        from network_distributed_pytorch_tpu_torch.ops import gram_schmidt as gs
        from network_distributed_pytorch_tpu_torch.ops import powersgd as ps
        from network_distributed_pytorch_tpu_torch.ops.orthogonalize import orthogonalize
        from network_distributed_pytorch_tpu_torch.parallel.mesh import (
            DistributedConfig,
            initialize_distributed,
            shutdown_distributed,
        )
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")

    # ---- 1. the card and the build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    emit({
        "phase": "setup", "nvidia_smi": smi, "python": sys.version.split()[0],
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "kernel_build_s": build_s, "libraries": [os.path.basename(p) for p in libs],
    })
    dev = torch.device("cuda", 0)

    # ---- 2. each kernel against its plain version ------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    def reducer_groups(experiment, cfg):
        """(g, n, m, r) of every shape group of ``experiment``'s full preset."""
        model, step, _ = experiment.build(cfg, "full", dev, group=None)
        params = list(model.parameters())
        metas = step.reducer._metas(params)
        return [
            (len(poss), metas[poss[0]].n, metas[poss[0]].m, metas[poss[0]].r)
            for poss in step.reducer._shape_groups(metas)
        ]

    group_shapes = reducer_groups(powersgd_cifar10, powersgd_cifar10.default_config())
    imdb_cfg = powersgd_imdb.default_config()
    imdb_cfg.global_batch_size = IMDB_B
    imdb_group_shapes = reducer_groups(powersgd_imdb, imdb_cfg)
    main_shapes = [(g, n, r) for g, n, _, r in group_shapes]
    imdb_shapes = [(g, n, r) for g, n, _, r in imdb_group_shapes]
    extra_shapes = [
        (3, 100, 4), (1, 4608, 1), (1, 4608, 8), (1, 4608, 32),
        (1, 30522, 32), (1, 30523, 16), (1, 17, 16), (25, 768, 16),
    ]
    gen = torch.Generator().manual_seed(0)
    errs, routes = {}, {}
    inputs = {}
    for shape in main_shapes + imdb_shapes + extra_shapes:
        x = torch.randn(shape, generator=gen).to(dev)
        got = gs.gram_schmidt(x)
        routes[str(shape)] = {"route": gs.KERNEL.last_route, "cluster": gs.KERNEL.last_cluster}
        want = orthogonalize(x)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not math.isfinite(err) or err > GS_TOL:
            fail(f"gram_schmidt {shape}: max |kernel - plain| = {err} > {GS_TOL}")
        errs[str(shape)] = err
        inputs[shape] = x
    word_table, streamed = routes[str((1, 30522, 16))], routes[str((1, 30522, 32))]
    if word_table["route"] != "on_chip" or word_table["cluster"] < 2:
        fail(f"gram_schmidt (1, 30522, 16) took {word_table}, not P on chip over a cluster of CTAs")
    if streamed["route"] != "streaming":
        fail(f"gram_schmidt (1, 30522, 32) took {streamed}, not the streaming route")
    main_inputs = [inputs[s] for s in main_shapes]
    gs_ms = cuda_ms(lambda: [gs.gram_schmidt(x) for x in main_inputs])
    plain_ms = cuda_ms(lambda: [orthogonalize(x) for x in main_inputs], reps=10)
    bound_ms, bound_by = gs_bound(main_shapes)
    per_group_ms = {
        str(s): cuda_ms(lambda x=inputs[s]: gs.gram_schmidt(x)) for s in main_shapes
    }
    main_err = max(errs[str(s)] for s in main_shapes + imdb_shapes)
    # the DistilBERT path's six groups, (30522, 16) among them
    imdb_inputs = [inputs[s] for s in imdb_shapes]
    gs_imdb = {
        "groups": len(imdb_shapes), "max_abs_err": max(errs[str(s)] for s in imdb_shapes),
        "ms_per_step": cuda_ms(lambda: [gs.gram_schmidt(x) for x in imdb_inputs]),
        "device_ms_per_step": device_ms(lambda: [gs.gram_schmidt(x) for x in imdb_inputs], "gram_schmidt_kernel"),
        "plain_ms_per_step": cuda_ms(lambda: [orthogonalize(x) for x in imdb_inputs], reps=5),
        "ms_per_group": {str(s): cuda_ms(lambda x=inputs[s]: gs.gram_schmidt(x)) for s in imdb_shapes},
        "device_ms_per_group": {
            str(s): device_ms(lambda x=inputs[s]: gs.gram_schmidt(x), "gram_schmidt_kernel") for s in imdb_shapes
        },
    }
    gs_imdb["bound_ms"], gs_imdb["bound_by"] = gs_bound(imdb_shapes)
    gs_device_ms = device_ms(lambda: [gs.gram_schmidt(x) for x in main_inputs], "gram_schmidt_kernel")
    emit({
        "phase": "gram_schmidt", "tolerance": GS_TOL, "max_abs_err": errs, "route_and_cluster": routes,
        "main_path_groups": len(main_shapes), "ms_per_step": gs_ms, "device_ms_per_step": gs_device_ms,
        "plain_ms_per_step": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "ms_per_group": per_group_ms, "imdb_path": gs_imdb,
    })
    del inputs, main_inputs, imdb_inputs

    # flash attention at DistilBERT's width, with the first synthetic-IMDb
    # batch's padding (about 214 of 256 keys per row)
    imdb_full, imdb_val, _ = prepare_imdb(max_len=IMDB_T, seed=imdb_cfg.seed)
    imdb_arrays = [imdb_full["input_ids"], imdb_full["attention_mask"], imdb_full["labels"]]
    first_amask = torch.from_numpy(next(accumulated_batches(imdb_arrays, imdb_cfg)(0))[1])
    imdb_mask = torch.where(first_amask > 0, 0.0, torch.finfo(torch.float32).min)
    attn_report, (aq, ak, av, amask) = check_flash_attention(fa, dev, gen, imdb_mask)
    scale = IMDB_D**-0.5
    sdpa_q, sdpa_k, sdpa_v = (x.view(IMDB_B, IMDB_H, IMDB_T, IMDB_D) for x in (aq, ak, av))
    launches_before = fa.KERNEL.launches

    def attention_row(mask):
        """One DistilBERT step's IMDB_LAYERS forwards over ``mask``: the
        kernel, its plain version and SDPA given the same additive mask."""
        sdpa_mask = mask[:, None, None, :]
        kernel = lambda: [fa.flash_attention_fwd(aq, ak, av, mask, False, 128, 128, scale) for _ in range(IMDB_LAYERS)]
        library = lambda: [
            torch.nn.functional.scaled_dot_product_attention(sdpa_q, sdpa_k, sdpa_v, attn_mask=sdpa_mask)
            for _ in range(IMDB_LAYERS)
        ]
        walked, skipped = attention_tiles(mask, IMDB_T, IMDB_H)
        # the mask's real keys: the work the function needs on this data
        valid_keys = int((mask > -1e29).sum())
        return {
            "ms": cuda_ms(kernel, reps=20),
            "device_ms": device_ms(kernel, "flash_fwd_kernel"),
            "plain_ms": cuda_ms(
                lambda: [fa.flash_attention_reference(aq, ak, av, mask, False, 128, 128, scale) for _ in range(IMDB_LAYERS)],
                reps=5,
            ),
            "library_ms": cuda_ms(library, reps=20),
            "library_device_ms": device_ms(library),
            **attention_bounds(IMDB_B, IMDB_T, IMDB_H, IMDB_D, IMDB_LAYERS, keys=valid_keys),
            "bound_ms_all_keys": attention_bound(IMDB_B, IMDB_T, IMDB_H, IMDB_D, IMDB_LAYERS)[0],
            "mean_valid_keys_per_row": valid_keys / IMDB_B,
            "tiles_walked_per_launch": walked - skipped, "tiles_skipped_per_launch": skipped,
        }

    attn_row = attention_row(amask)
    attn_row["max_abs_err"] = max(r["max_abs_err"] for r in attn_report.values())
    no_mask_row = attention_row(torch.zeros_like(amask))
    emit({
        "phase": "flash_attention", "tolerance": ATTN_TOL, "cases": attn_report,
        "launches_per_step": IMDB_LAYERS, "per_step": attn_row, "per_step_no_mask": no_mask_row,
        "us_per_launch": attn_row["ms"] * 1e3 / IMDB_LAYERS,
        "timing_launches": fa.KERNEL.launches - launches_before,
    })
    del aq, ak, av, amask, sdpa_q, sdpa_k, sdpa_v

    # the fused kernels, at every main-path shape group and a few others
    extra_groups = [
        (3, 100, 37, 8), (1, 2, 3, 2), (2, 70, 7, 3), (2, 50, 10, 4), (2, 5, 256, 4),
        (1, 4608, 512, 1), (1, 4608, 512, 8), (1, 4608, 512, 32),
    ]
    report, kept = check_fused_kernels(ps, gs, group_shapes + extra_groups, dev, gen, set(group_shapes))
    if report[str((1, 4608, 512, 32))]["route"] != "two_launch":
        fail("orthogonalize_project at r = 32, n = 4608 did not take the two-launch route")
    main_x = [kept[s] for s in group_shapes]
    timed = {  # name: (kernel, plain version, one PyTorch call or None, the xla path's calls)
        "ef_compress": (
            lambda x: ps.fused_ef_compress(x["grads"], x["q"], x["resid"]),
            lambda x: ps.ef_compress_reference(x["grads"], x["q"], x["resid"]),
            None,
            lambda x: torch.bmm(x["grads"] + x["resid"], x["q"]),
        ),
        "compress": (
            lambda x: ps.fused_ef_compress(x["m"], x["q"]),
            lambda x: ps.compress_reference(x["m"], x["q"]),
            lambda x: torch.bmm(x["m"], x["q"]),
            lambda x: torch.bmm(x["m"], x["q"]),
        ),
        "orthogonalize_project": (
            lambda x: ps.fused_orthogonalize_project(x["p"], x["m"]),
            lambda x: ps.orthogonalize_project_reference(x["p"], x["m"]),
            None,
            lambda x: torch.bmm(x["m"].transpose(1, 2), gs.gram_schmidt(x["p"])),
        ),
        "decompress_residual": (
            lambda x: ps.fused_decompress_residual(x["phat"], x["qn"], x["m"]),
            lambda x: ps.decompress_residual_reference(x["phat"], x["qn"], x["m"]),
            None,
            lambda x: (lambda out: (out, x["m"] - out))(torch.bmm(x["phat"], x["qn"].transpose(1, 2))),
        ),
    }

    def step_ms(fn, reps):
        return cuda_ms(lambda: [fn(x) for x in main_x], reps=reps)

    bounds = fused_bounds(group_shapes)
    device_fn = {  # a part of each kernel's device function name
        "ef_compress": "ef_compress_kernel", "compress": "ef_compress_kernel",
        "orthogonalize_project": "orthogonalize_project_kernel",
        "decompress_residual": "decompress_residual_kernel",
    }
    fused_rows = {}
    for name, (kernel, plain, library, _) in timed.items():
        (b_ms, b_by), nbytes = bounds[name]
        fused_rows[name] = {
            "max_abs_err": max(max(report[str(s)][name].values()) for s in group_shapes),
            "ms": step_ms(kernel, 20), "plain_ms": step_ms(plain, 5),
            "device_ms": device_ms(lambda: [kernel(x) for x in main_x], device_fn[name], reps=FUSED_REPS),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
            "library_ms": step_ms(library, 20) if library is not None else None,
            "library_device_ms": (
                device_ms(lambda: [library(x) for x in main_x], reps=FUSED_REPS) if library is not None else None
            ),
        }
    xla_ms = {name: step_ms(xla, 20) for name, (_, _, _, xla) in timed.items()}
    xla_device_ms = {
        name: device_ms(lambda xla=xla: [xla(x) for x in main_x], reps=FUSED_REPS) for name, (_, _, _, xla) in timed.items()
    }
    # each redesigned kernel's device time per shape group, and torch.bmm's for K2b's work
    per_group = {
        str(s): {
            **{
                name: device_ms(lambda x=x, k=timed[name][0]: k(x), device_fn[name], reps=FUSED_REPS)
                for name in ("ef_compress", "compress", "orthogonalize_project")
            },
            "torch_bmm": device_ms(lambda x=x: torch.bmm(x["m"], x["q"]), reps=FUSED_REPS),
        }
        for s, x in zip(group_shapes, main_x)
    }
    emit({
        "phase": "fused_kernels", "tolerance": FUSED_TOL, "main_path_groups": len(group_shapes),
        "per_shape": report, "per_step": fused_rows, "device_ms_per_group": per_group,
    })
    del kept, main_x
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default

    # ---- 3. the main paths: ResNet xla and fused, DistilBERT ---------------------
    all_kernels = (gs.KERNEL, *ps.KERNELS, fa.KERNEL)
    device_fns = {  # a part of each kernel's device function name
        "gram_schmidt": "gram_schmidt_kernel", "ef_compress": "ef_compress_kernel",
        "orthogonalize_project": "orthogonalize_project_kernel",
        "decompress_residual": "decompress_residual_kernel", "flash_attention": "flash_fwd_kernel",
    }
    images, labels, _ = load_cifar10_or_synthetic(train=True)
    results = {}
    launches = {}
    profiles = {}

    def drive(name, run, want, kernel_free=False):
        """``run()`` with every launch count set to 0 just before it and
        read just after; fails unless they are ``want`` (all 0 only where
        the path is ``kernel_free``)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for k in all_kernels:
            k.launches = 0
        result = run()
        launches[name] = {k.name: k.launches for k in all_kernels}
        full_want = {k.name: want.get(k.name, 0) for k in all_kernels}
        if launches[name] != full_want or not (kernel_free or any(full_want.values())):
            fail(f"{name} launched {launches[name]}, expected {full_want}")
        results[name] = result
        return result, torch.cuda.max_memory_allocated(dev)

    for impl in ("xla", "pallas"):
        cfg = powersgd_cifar10.default_config()
        cfg.training_epochs = 1
        cfg.compress_impl = impl
        expected = MAIN_STEPS * len(group_shapes)
        want = (
            {"gram_schmidt": expected} if impl == "xla" else
            {"ef_compress": expected, "orthogonalize_project": expected, "decompress_residual": expected}
        )
        result, peak = drive(
            impl, lambda: powersgd_cifar10.run(cfg, preset="full", device=dev, max_steps_per_epoch=MAIN_STEPS), want
        )
        record = main_path_record("main_path" if impl == "xla" else "main_path_fused", result, cfg, peak)
        record.update(
            compress_impl=cfg.compress_impl, reducer_rank=cfg.reducer_rank,
            shape_groups=result["shape_groups"], launches=launches[impl],
        )
        emit(record)
        profiles[impl] = profile_main_path(dev, powersgd_cifar10, cfg, [images, labels], {
            k: device_fns[k] for k in ("gram_schmidt", "ef_compress", "orthogonalize_project", "decompress_residual")
        })
        emit(profiles[impl])
    if results["pallas"]["bits_per_step"] != results["xla"]["bits_per_step"]:
        fail(f"bits per step: fused {results['pallas']['bits_per_step']} != xla {results['xla']['bits_per_step']}")

    # DistilBERT/IMDb: flash attention once per layer and K1 once per shape
    # group in every step
    cfg = powersgd_imdb.default_config()
    cfg.training_epochs = 1
    result, peak = drive(
        "imdb", lambda: powersgd_imdb.run(cfg, preset="full", device=dev, max_steps_per_epoch=MAIN_STEPS),
        {"gram_schmidt": MAIN_STEPS * len(imdb_shapes), "flash_attention": MAIN_STEPS * IMDB_LAYERS},
    )
    losses = result["losses"]
    if len(losses) != MAIN_STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"imdb losses {losses}")
    if result["bits_per_step"] != IMDB_BITS + 32 or result["shape_groups"] != len(imdb_shapes):
        fail(f"imdb bits per step {result['bits_per_step']} (want {IMDB_BITS} + 32), groups {result['shape_groups']}")
    timed_ms = result["device_time_ms"][WARMUP_STEPS:]
    p50_ms = statistics.median(timed_ms)
    emit({
        "phase": "main_path_imdb", "model": "distilbert_base", "global_batch": result["global_batch"],
        "max_len": result["max_len"], "reducer_rank": result["reducer_rank"],
        "world_size": result["num_devices"], "losses": losses, "timed_steps": len(timed_ms),
        "step_device_ms": timed_ms, "step_device_ms_p50": p50_ms,
        "step_host_s_p50": statistics.median(result["step_time_s"][WARMUP_STEPS:]),
        "sequences_per_s": result["global_batch"] / (p50_ms / 1e3), "peak_memory_bytes": peak,
        "bits_per_step": result["bits_per_step"], "shape_groups": result["shape_groups"],
        "launches": launches["imdb"],
    })
    imdb_cfg = powersgd_imdb.default_config()
    imdb_cfg.global_batch_size = IMDB_B
    profiles["imdb"] = profile_main_path(dev, powersgd_imdb, imdb_cfg, imdb_arrays, {
        k: device_fns[k] for k in ("gram_schmidt", "flash_attention")
    })
    emit(profiles["imdb"])

    # exact DDP of ResNet-50 under each reducer layout: no kernel of the port
    # runs, every gradient rides NCCL (a world of one)
    exact = {}
    for layout, (fields, collectives) in EXACT_LAYOUTS.items():
        cfg = exact_cifar10.default_config()
        for k, v in fields.items():
            setattr(cfg, k, v)
        result, peak = drive(
            f"exact_{layout}",
            lambda: exact_cifar10.run(
                cfg, preset="full", device=dev, max_steps_per_epoch=MAIN_STEPS, eval_after=layout == "monolithic"
            ),
            {}, kernel_free=True,
        )
        record = main_path_record(f"exact_{layout}", result, cfg, peak, model="resnet50")
        if result["bits_per_step"] != EXACT_BITS + 32 or result["n_collectives"] != collectives:
            fail(
                f"exact {layout}: {result['bits_per_step']} bits per step (want {EXACT_BITS} + 32),"
                f" {result['n_collectives']} collectives (want {collectives})"
            )
        exact[layout] = {**record, "reducer": fields, "n_collectives": collectives}
    # the layouts' parameters after two steps from the same weights and
    # batches, with deterministic cuDNN: bit for bit, since every layout
    # reduces the same values over one rank
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    group = initialize_distributed(DistributedConfig(), dev)
    try:
        first = None
        for layout, (fields, _) in EXACT_LAYOUTS.items():
            cfg = exact_cifar10.default_config()
            for k, v in fields.items():
                setattr(cfg, k, v)
            model, step, state = exact_cifar10.build(cfg, "full", dev, group)
            for batch in accumulated_batches([images, labels], cfg, max_steps_per_epoch=2)(0):
                state, loss = step(state, tuple(torch.from_numpy(a).to(dev) for a in batch))
            params = {k: v.detach().clone() for k, v in state.params.items()}
            del model, step, state
            if first is None:
                first = params
            elif not all(torch.equal(params[k], first[k]) for k in first):
                fail(f"exact {layout}: parameters after 2 steps differ from the monolithic layout's")
        del first, params
    finally:
        shutdown_distributed()
        torch.backends.cudnn.deterministic = False
    profiles["exact"] = profile_main_path(
        dev, exact_cifar10, exact_cifar10.default_config(), [images, labels], {}, steps=EXACT_PROFILE_STEPS
    )
    emit({
        "phase": "main_path_exact", "model": "resnet50", "parameters": 23_528_522, "leaves": 161,
        "layouts": exact, "params_after_2_steps_bitwise_equal": True,
        "eval_accuracy": results["exact_monolithic"]["eval_accuracy"],
        "eval_note": "synthetic CIFAR-10 test split, 7 steps from random weights: a number, not a target",
        "profile": profiles["exact"],
    })

    # the single-node IMDb baseline: one process, no group, K5 in each layer
    # of every training step and of every evaluation batch
    eval_batches = -(-len(imdb_val["labels"]) // TEXT_EVAL_BATCH)
    baseline = {}
    for opt in imdb_baseline.OPTIMIZERS:
        cfg = imdb_baseline.default_config(opt)
        cfg.training_epochs = 1
        result, peak = drive(
            f"imdb_baseline_{opt}",
            lambda: imdb_baseline.run(
                cfg, preset="full", device=dev, max_steps_per_epoch=MAIN_STEPS, optimizer_name=opt, eval_after=True
            ),
            {"flash_attention": (MAIN_STEPS + eval_batches) * IMDB_LAYERS},
        )
        losses = result["losses"]
        if len(losses) != MAIN_STEPS or not all(math.isfinite(v) for v in losses):
            fail(f"imdb_baseline {opt} losses {losses}")
        if result["bits_per_step"] != BASELINE_BITS:
            fail(f"imdb_baseline {opt}: {result['bits_per_step']} bits per step, want {BASELINE_BITS}")
        timed_ms = result["device_time_ms"][WARMUP_STEPS:]
        p50_ms = statistics.median(timed_ms)
        baseline[opt] = {
            "epochs_of_the_reference": imdb_baseline.OPTIMIZERS[opt], "learning_rate": cfg.learning_rate,
            "losses": losses, "timed_steps": len(timed_ms), "step_device_ms": timed_ms,
            "step_device_ms_p50": p50_ms,
            "step_host_s_p50": statistics.median(result["step_time_s"][WARMUP_STEPS:]),
            "sequences_per_s": result["global_batch"] / (p50_ms / 1e3), "peak_memory_bytes": peak,
            "bits_per_step": result["bits_per_step"], "launches": launches[f"imdb_baseline_{opt}"],
            "flash_launches_training": MAIN_STEPS * IMDB_LAYERS,
            "flash_launches_eval": eval_batches * IMDB_LAYERS, "eval_sequences": len(imdb_val["labels"]),
            "eval_accuracy": result["eval_accuracy"],
        }
    baseline_cfg = imdb_baseline.default_config()
    profiles["imdb_baseline"] = profile_main_path(
        dev, imdb_baseline, baseline_cfg, imdb_arrays, {"flash_attention": device_fns["flash_attention"]},
        build=lambda group: imdb_baseline.build(baseline_cfg, "full", dev),  # one process: no group
    )
    emit({
        "phase": "main_path_imdb_baseline", "model": "distilbert_base", "global_batch": IMDB_B, "max_len": IMDB_T,
        "world_size": 1, "optimizers": baseline, "profile_sgd_nesterov": profiles["imdb_baseline"],
        "eval_note": "synthetic IMDb validation split, 7 steps from random weights: a number, not a target",
    })

    # bare_init through the launcher, in a process of its own
    launched = subprocess.run(
        [sys.executable, "-m", "network_distributed_pytorch_tpu_torch.launch", "bare_init"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=300,
    )
    lines = launched.stdout.strip().splitlines()
    summary = json.loads(lines[-1]) if launched.returncode == 0 and lines else None
    if summary is None or summary.get("num_devices") != 1 or summary.get("backend") != "nccl":
        fail(f"launch bare_init exited {launched.returncode}: {launched.stdout[-2000:]} {launched.stderr[-2000:]}")
    emit({"phase": "bare_init", "summary": summary})

    # ---- 4. two steps against two steps ---------------------------------------
    # with deterministic cuDNN and no TF32, so that only what is compared differs
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False

    def two_steps(cfg, preset, device, n_power_iterations=0):
        model, step, state = powersgd_cifar10.build(cfg, preset, device, group=None)
        step.reducer.n_power_iterations = n_power_iterations
        losses = []
        for batch in accumulated_batches([images, labels], cfg, max_steps_per_epoch=2)(0):
            state, loss = step(state, tuple(torch.from_numpy(a).to(device) for a in batch))
            losses.append(loss.item())
        return losses, {k: v.detach().cpu() for k, v in state.params.items()}

    def max_diff(a, b):
        return max((a[k] - b[k]).abs().max().item() for k in a)

    def full_config(**fields):
        cfg = powersgd_cifar10.default_config()
        for k, v in fields.items():
            setattr(cfg, k, v)
        return cfg

    # the main path with the plain Gram-Schmidt against the kernel
    finals = {impl: two_steps(full_config(orthogonalize_impl=impl), "full", dev)[1] for impl in ("eager", "cuda")}
    diff = max_diff(finals["eager"], finals["cuda"])
    if not math.isfinite(diff) or diff > PARAM_TOL:
        fail(f"params after 2 steps, eager vs cuda Gram-Schmidt: max diff {diff} > {PARAM_TOL}")
    emit({"phase": "eager_vs_cuda", "steps": 2, "max_param_diff": diff, "tolerance": PARAM_TOL})

    # the fused main path against xla; then with one extra power iteration,
    # whose second round runs K2b
    for phase, extra_rounds in (("fused_vs_xla", 0), ("fused_vs_xla_power_iteration", 1)):
        finals = {}
        for impl in ("xla", "pallas"):
            for k in ps.KERNELS:
                k.launches = 0
            finals[impl] = two_steps(full_config(compress_impl=impl), "full", dev, extra_rounds)[1]
        counts = {k.name: k.launches for k in ps.KERNELS}
        groups = results["pallas"]["shape_groups"]
        want = {
            "ef_compress": 2 * groups, "compress": 2 * groups * extra_rounds,
            "orthogonalize_project": 2 * groups * (1 + extra_rounds), "decompress_residual": 2 * groups,
        }
        if counts != want:
            fail(f"{phase}: fused launches {counts}, expected {want}")
        if extra_rounds:
            launches["pallas"]["compress"] = counts["compress"]
            compress_by_path = {phase: counts["compress"]}
        diff = max_diff(finals["xla"], finals["pallas"])
        if not math.isfinite(diff) or diff > PARAM_TOL:
            fail(f"params after 2 steps, {phase}: max diff {diff} > {PARAM_TOL}")
        emit({
            "phase": phase, "steps": 2, "n_power_iterations": extra_rounds, "fused_launches": counts,
            "max_param_diff": diff, "tolerance": PARAM_TOL,
        })

    # a small input against the CPU path, which the CPU tests hold against
    # the JAX package: the small preset at global batch 16, on the card and
    # on the CPU, from the same seed and batches
    cfg = full_config(global_batch_size=16)
    (cpu_losses, cpu_params), (gpu_losses, gpu_params) = (
        two_steps(cfg, "small", torch.device("cpu")), two_steps(cfg, "small", dev)
    )
    diff = max_diff(cpu_params, gpu_params)
    loss_diff = max(abs(a - b) for a, b in zip(cpu_losses, gpu_losses))
    if not (math.isfinite(diff) and diff <= SMALL_TOL and loss_diff <= SMALL_TOL):
        fail(f"small preset, cuda vs cpu: params {diff}, losses {loss_diff} > {SMALL_TOL}")
    emit({
        "phase": "cuda_vs_cpu", "preset": "small", "global_batch": 16, "steps": 2,
        "losses_cuda": gpu_losses, "losses_cpu": cpu_losses,
        "max_param_diff": diff, "max_loss_diff": loss_diff, "tolerance": SMALL_TOL,
    })

    # DistilBERT: flash attention (the kernel) against einsum attention on
    # the card at full width; then the tiny model on the card against the CPU
    imdb_small, _, _ = prepare_imdb(max_len=64, vocab_size=1024, seed=imdb_cfg.seed)

    def imdb_two_steps(preset, device, arrays, **fields):
        """Losses and parameters after two steps, and the names of the
        compressed leaves whose gradient on the first batch has a rank below
        the reducer's r for them."""
        cfg = powersgd_imdb.default_config()
        cfg.global_batch_size = IMDB_B
        for k, v in fields.items():
            setattr(cfg, k, v)
        model, step, state = powersgd_imdb.build(cfg, preset, device, group=None)
        batches = [
            tuple(torch.from_numpy(a).to(device) for a in batch)
            for batch in accumulated_batches(arrays, cfg, max_steps_per_epoch=2)(0)
        ]
        names, leaves = zip(*model.named_parameters())
        powersgd_imdb.sequence_classifier_loss()(model, batches[0]).backward()
        deficient = sorted(
            names[m.leaf_index] for m in step.reducer._metas(list(leaves))
            if int(torch.linalg.matrix_rank(leaves[m.leaf_index].grad)) < m.r
        )
        losses = []
        for batch in batches:  # the step sets every .grad to None first
            state, loss = step(state, batch)
            losses.append(loss.item())
        return losses, {k: v.detach().cpu() for k, v in state.params.items()}, deficient

    small_arrays = [imdb_small["input_ids"], imdb_small["attention_mask"], imdb_small["labels"]]
    for phase, preset, arrays, sides in (
        ("imdb_flash_vs_einsum", "full", imdb_arrays,
         ((dev, {"attn_impl": "flash"}), (dev, {"attn_impl": "einsum"}))),
        ("imdb_cuda_vs_cpu", "small", small_arrays, ((dev, {}), (torch.device("cpu"), {}))),
    ):
        record = {"phase": phase, "preset": preset, "global_batch": IMDB_B, "steps": 2, "tolerance_full_rank_leaves": IMDB_TOL}
        for rank in (1, powersgd_imdb.default_config().reducer_rank):
            before = fa.KERNEL.launches
            (losses_a, params_a, deficient), (losses_b, params_b, _) = (
                imdb_two_steps(preset, device, arrays, reducer_rank=rank, **fields) for device, fields in sides
            )
            if rank == 1 and deficient:
                fail(f"{phase} at rank 1: leaves of gradient rank 0: {deficient}")
            full_rank = {k: v for k, v in params_a.items() if k not in deficient}
            diff_full_rank = max_diff(full_rank, params_b)
            diff = max_diff(params_a, params_b)
            loss_diff = max(abs(a - b) for a, b in zip(losses_a, losses_b))
            tol = IMDB_TOL if rank == 1 else IMDB_RANK16_TOL
            if not (math.isfinite(diff) and diff_full_rank <= IMDB_TOL and diff <= tol and loss_diff <= tol):
                fail(
                    f"{phase} at rank {rank}: params {diff_full_rank} over the leaves of full gradient rank"
                    f" (tol {IMDB_TOL}), {diff} over all and losses {loss_diff} (tol {tol})"
                )
            record[f"rank_{rank}"] = {
                "losses": [losses_a, losses_b], "max_param_diff_full_rank_leaves": diff_full_rank,
                "max_param_diff": diff, "max_loss_diff": loss_diff, "tolerance_all_leaves_and_losses": tol,
                "rank_deficient_leaves": deficient, "flash_launches": fa.KERNEL.launches - before,
            }
        emit(record)

    # the IMDb baseline: flash attention (K5) against einsum on the card, two
    # steps from the same weights. Exact gradients: every leaf to IMDB_TOL,
    # but for AdamW the attention's key biases, whose gradient is zero in
    # exact arithmetic (a softmax does not change when all of a query's
    # scores move together): Adam scales their rounding noise up to about lr
    # a step, so there they are held to Adam's bound
    def baseline_two_steps(opt, attn_impl):
        cfg = imdb_baseline.default_config(opt)
        cfg.attn_impl = attn_impl
        model, step, state = imdb_baseline.build(cfg, "full", dev, opt)
        losses = []
        for batch in accumulated_batches(imdb_arrays, cfg, max_steps_per_epoch=2)(0):
            state, loss = step(state, tuple(torch.from_numpy(a).to(dev) for a in batch))
            losses.append(loss.item())
        return losses, {k: v.detach().cpu() for k, v in state.params.items()}

    record = {"phase": "imdb_baseline_flash_vs_einsum", "preset": "full", "global_batch": IMDB_B, "steps": 2,
              "tolerance": IMDB_TOL}
    for opt in imdb_baseline.OPTIMIZERS:
        before = fa.KERNEL.launches
        (losses_a, params_a), (losses_b, params_b) = (baseline_two_steps(opt, impl) for impl in ("flash", "einsum"))
        flash_launches = fa.KERNEL.launches - before
        noise = {k for k in params_a if k.endswith("attention.k_lin.bias")} if opt == "adamw" else set()
        bound = ADAM_NOISE_BOUND * imdb_baseline.default_config(opt).learning_rate * 2
        diff = max_diff({k: v for k, v in params_a.items() if k not in noise}, params_b)
        noise_diff = max_diff({k: params_a[k] for k in noise}, params_b) if noise else 0.0
        loss_diff = max(abs(a - b) for a, b in zip(losses_a, losses_b))
        if flash_launches != 2 * IMDB_LAYERS:
            fail(f"imdb_baseline {opt}: flash attention launched {flash_launches} times in 2 steps")
        if not (math.isfinite(diff) and diff <= IMDB_TOL and loss_diff <= IMDB_TOL and noise_diff <= bound):
            fail(
                f"imdb_baseline {opt}, flash vs einsum: params {diff}, losses {loss_diff} (tol {IMDB_TOL}),"
                f" key biases {noise_diff} (bound {bound})"
            )
        record[opt] = {
            "losses": [losses_a, losses_b], "max_param_diff": diff, "max_loss_diff": loss_diff,
            "key_bias_leaves": len(noise), "max_key_bias_diff": noise_diff, "key_bias_bound": bound,
            "flash_launches": flash_launches,
        }
    emit(record)

    # ---- 5. the kernels ------------------------------------------------------
    # what the xla path runs for the same work, as a yardstick for later work
    emit({"phase": "xla_yardstick", "ms_per_step": xla_ms, "device_ms_per_step": xla_device_ms})
    source = "network_distributed_pytorch_tpu_torch/csrc/powersgd.cu"
    pallas = "network_distributed_pytorch_tpu/ops/pallas_powersgd.py"
    replaces = {  # the Pallas kernel bodies
        "ef_compress": f"{pallas}:78", "compress": f"{pallas}:88",
        "orthogonalize_project": f"{pallas}:96", "decompress_residual": f"{pallas}:121",
    }
    kernels = [{
        "name": "gram_schmidt",
        "route": "cuda",
        "source": "network_distributed_pytorch_tpu_torch/csrc/gram_schmidt.cu",
        "replaces": "network_distributed_pytorch_tpu/ops/pallas_orthogonalize.py:28",
        # on both paths that run it: ResNet (xla pipeline) and DistilBERT
        "launches": launches["xla"]["gram_schmidt"] + launches["imdb"]["gram_schmidt"],
        "launches_by_path": {"resnet152_xla": launches["xla"]["gram_schmidt"], "distilbert_imdb": launches["imdb"]["gram_schmidt"]},
        "max_abs_err": main_err,
        "ms": gs_ms,
        "device_ms": gs_device_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this sequential Gram-Schmidt
        "library_device_ms": None,
        "device_ms_in_path_profile": profiles["xla"]["kernels"]["gram_schmidt"]["device_ms_per_step"],
        # ms, device_ms, plain_ms and bound_ms above are one ResNet step's; one DistilBERT step's:
        "distilbert_imdb": {
            **{k: gs_imdb[k] for k in ("ms_per_step", "device_ms_per_step", "plain_ms_per_step", "bound_ms", "bound_by")},
            "device_ms_in_path_profile": profiles["imdb"]["kernels"]["gram_schmidt"]["device_ms_per_step"],
            "device_ms_per_group": gs_imdb["device_ms_per_group"],
        },
        "route_and_cluster": routes,
    }]
    for name, row in fused_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces[name],
            "launches": launches["pallas"][name],
            # K2b runs only with an extra power iteration: its launches come from that phase
            **({"launches_by_path": compress_by_path} if name == "compress" else {}),
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "device_ms": row["device_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "library_device_ms": row["library_device_ms"],
        })
    k5_paths = {
        "distilbert_imdb": "imdb",
        **{f"imdb_baseline_{opt}": f"imdb_baseline_{opt}" for opt in imdb_baseline.OPTIMIZERS},
    }
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "network_distributed_pytorch_tpu_torch/csrc/flash_attention.cu",
        "replaces": "network_distributed_pytorch_tpu/ops/flash_attention.py:76",
        # on every path that runs it: PowerSGD DistilBERT and the single-node baseline
        "launches": sum(launches[path]["flash_attention"] for path in k5_paths.values()),
        "launches_by_path": {name: launches[path]["flash_attention"] for name, path in k5_paths.items()},
        "max_abs_err": attn_row["max_abs_err"],
        # one step's launches on the first IMDb batch's mask; SDPA given the same additive mask
        **{k: v for k, v in attn_row.items() if k != "max_abs_err"},
        "device_ms_in_path_profile": profiles["imdb"]["kernels"]["flash_attention"]["device_ms_per_step"],
        "device_ms_in_baseline_profile": profiles["imdb_baseline"]["kernels"]["flash_attention"]["device_ms_per_step"],
        "no_mask": no_mask_row,
    })
    emit({"kernels": kernels})
    # the card's name and power limit, exactly as nvidia-smi gives them
    sys.stdout.write(smi + "\n")
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })


if __name__ == "__main__":
    main()
