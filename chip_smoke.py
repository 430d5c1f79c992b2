#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. the card (``nvidia-smi``), torch and CUDA versions, and the build of
   every CUDA kernel of the port (one ``nvcc`` per source, started together);
2. with TF32 off, each kernel against its plain PyTorch version on the card:
   the Gram-Schmidt kernel (K1) at every (g, n, r) shape group of the main
   path (ResNet-152, rank 4), a ragged n = 100 and r in {1, 8, 32} at
   n = 4608; the fused PowerSGD kernels (K2a, K2b, K3, K4) at every
   (g, n, m, r) shape group, a ragged (3, 100, 37, 8), a clipped
   (1, 2, 3, 2) and r in {1, 8, 32} at n = 4608, m = 512 (r = 32 takes K3's
   two-launch route);
3. the main path, ``powersgd_cifar10.run`` with preset ``full`` (ResNet-152,
   ImageNet stem, width 64, global batch 512, PowerSGD rank 4) through a
   one-rank NCCL group, 2 warm-up and 5 timed steps, then 3 steps under
   ``torch.profiler``: once on the ``compress_impl="xla"`` path (K1) and
   once on the fused ``"pallas"`` path (K2a, K3, K4), each with the launch
   counts set to 0 just before it and read just after;
4. two steps from the same weights and batches, deterministic cuDNN: plain
   Gram-Schmidt against the kernel; fused against xla; fused against xla
   with one extra power iteration (K2b's path); and the small preset on the
   card against the same two steps on the CPU;
5. one ``{"kernels": [...]}`` line: each kernel's launches on its path, its
   time for one main-path step, the plain version's, one PyTorch call's
   where one computes the same function, and the least time the card could
   take; before it, the xla path's library calls for the same work.

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

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

GS_TOL = 1e-5  # fp32 sums in another order; entries of P-hat are at most 1
# the fused kernels: P-hat as GS_TOL; P, Q, out and mem are sums of up to n
# or m products in another order, held to FUSED_TOL * max(1, max|plain|);
# M = G + E is one rounded add and must be bitwise equal
FUSED_TOL = 1e-5
PARAM_TOL = 1e-5  # the same, carried through two updates of lr 0.001
# cuDNN against PyTorch's CPU convolutions, fp32 without TF32: sums in
# another order, through a ResNet-18 and two PowerSGD steps
SMALL_TOL = 1e-4

MAIN_STEPS, WARMUP_STEPS = 7, 2
PROFILE_STEPS = 3


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


def device_ms(fn, part, reps=3):
    """Device time of the kernels whose name holds ``part`` in one call of
    ``fn()``, by ``torch.profiler`` over ``reps`` calls after a warm-up;
    None where the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and part in e.key
    )
    return us / 1e3 / reps if us > 0 else None


def bound(nbytes, ops):
    """The least time for ``nbytes`` of device memory traffic and ``ops``
    fp32 operations: the larger of the two over the card's peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
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


def check_fused_kernels(ps, shapes, dev, gen, keep):
    """Each fused kernel against its plain version on the same inputs at
    every (g, n, m, r) in ``shapes``; fails past the tolerances. Returns the
    errors and K3's route per shape, and the inputs of the shapes in
    ``keep``. Each kernel's inputs are its plain predecessor's outputs."""
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
        torch.cuda.synchronize()
        if not torch.equal(got["m"], want["m"]):
            fail(f"ef_compress {shape}: M is not bitwise G + E")
        errs = {}
        for key in ("p", "p2", "phat", "qn", "out", "mem"):
            err = (got[key] - want[key]).abs().max().item()
            tol = FUSED_TOL if key == "phat" else FUSED_TOL * max(1.0, want[key].abs().max().item())
            if not math.isfinite(err) or err > tol:
                fail(f"fused kernels {shape}: max |kernel - plain| of {key} = {err} > {tol}")
            errs[key] = err
        report[str(shape)] = {
            "route": route,
            "ef_compress": {"m": 0.0, "p": errs["p"]},
            "compress": {"p": errs["p2"]},
            "orthogonalize_project": {"phat": errs["phat"], "q": errs["qn"]},
            "decompress_residual": {"out": errs["out"], "mem": errs["mem"]},
        }
        if shape in keep:
            kept[shape] = x
    return report, kept


def profile_main_path(dev, cfg, kernels):
    """Where a main-path step's time goes: ``torch.profiler`` over
    PROFILE_STEPS steps of the full preset with ``cfg`` through a one-rank
    NCCL group, after one warm-up step; ``kernels`` maps each port kernel to
    a part of its device function's name. Device numbers are None where the
    profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from network_distributed_pytorch_tpu_torch.data.cifar10 import load_cifar10_or_synthetic
    from network_distributed_pytorch_tpu_torch.experiments import powersgd_cifar10
    from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )

    group = initialize_distributed(DistributedConfig(), dev)
    try:
        model, step, state = powersgd_cifar10.build(cfg, "full", dev, group)
        images, labels, _ = load_cifar10_or_synthetic(train=True)
        batches = [
            tuple(torch.from_numpy(a).to(dev) for a in b)
            for b in accumulated_batches([images, labels], cfg, 1 + PROFILE_STEPS)(0)
        ]
        state, loss = step(state, batches[0])
        loss.item()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches[1:]:
                state, loss = step(state, b)
                loss.item()
            wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        del model, step, state
    finally:
        shutdown_distributed()
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / PROFILE_STEPS
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:10]
    seen = busy_ms > 0
    per_kernel = {}
    for name, part in kernels.items():
        evs = [e for e in device if part in e.key]
        total_us, count = sum(e.self_device_time_total for e in evs), sum(e.count for e in evs)
        per_kernel[name] = {
            "launches_per_step": count / PROFILE_STEPS,
            "device_ms_per_step": total_us / 1e3 / PROFILE_STEPS if seen else None,
            "device_us_per_launch": total_us / max(count, 1) if seen else None,
        }
    return {
        "phase": "profile", "compress_impl": cfg.compress_impl, "steps": PROFILE_STEPS,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms if seen else None,
        "device_idle_share": 1 - busy_ms / wall_ms if seen else None,
        "kernels": per_kernel,
        "top_kernels": [
            {
                "name": e.key[:90],
                "ms_per_step": e.self_device_time_total / 1e3 / PROFILE_STEPS,
                "calls_per_step": e.count / PROFILE_STEPS,
            }
            for e in top
        ],
    }


def main_path_record(name, result, cfg, peak):
    """The ``main_path`` line of one run of ``powersgd_cifar10.run``; fails
    on a non-finite loss."""
    import statistics

    losses = result["losses"]
    if len(losses) != MAIN_STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"{name} losses {losses}")
    timed_ms = result["device_time_ms"][WARMUP_STEPS:]
    p50_ms = statistics.median(timed_ms)
    return {
        "phase": name, "compress_impl": cfg.compress_impl, "model": "resnet152",
        "stem": "imagenet", "width": 64, "global_batch": cfg.global_batch_size,
        "reducer_rank": cfg.reducer_rank, "world_size": result["num_devices"], "losses": losses,
        "timed_steps": len(timed_ms), "step_device_ms": timed_ms,
        "step_device_ms_p50": p50_ms,
        "step_host_s_p50": statistics.median(result["step_time_s"][WARMUP_STEPS:]),
        "images_per_s": cfg.global_batch_size / (p50_ms / 1e3),
        "peak_memory_bytes": peak, "bits_per_step": result["bits_per_step"],
        "shape_groups": result["shape_groups"],
    }


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from network_distributed_pytorch_tpu_torch.data.cifar10 import load_cifar10_or_synthetic
        from network_distributed_pytorch_tpu_torch.experiments import powersgd_cifar10
        from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches
        from network_distributed_pytorch_tpu_torch.ops import _build
        from network_distributed_pytorch_tpu_torch.ops import gram_schmidt as gs
        from network_distributed_pytorch_tpu_torch.ops import powersgd as ps
        from network_distributed_pytorch_tpu_torch.ops.orthogonalize import orthogonalize
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
    cfg = powersgd_cifar10.default_config()
    model, step, _ = powersgd_cifar10.build(cfg, "full", dev, group=None)
    params = list(model.parameters())
    reducer = step.reducer
    metas = reducer._metas(params)
    group_shapes = [
        (len(poss), metas[poss[0]].n, metas[poss[0]].m, metas[poss[0]].r)
        for poss in reducer._shape_groups(metas)
    ]
    main_shapes = [(g, n, r) for g, n, _, r in group_shapes]
    del model, step, params
    extra_shapes = [(3, 100, 4), (1, 4608, 1), (1, 4608, 8), (1, 4608, 32)]
    gen = torch.Generator().manual_seed(0)
    errs = {}
    inputs = {}
    for shape in main_shapes + extra_shapes:
        x = torch.randn(shape, generator=gen).to(dev)
        got = gs.gram_schmidt(x)
        want = orthogonalize(x)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not math.isfinite(err) or err > GS_TOL:
            fail(f"gram_schmidt {shape}: max |kernel - plain| = {err} > {GS_TOL}")
        errs[str(shape)] = err
        inputs[shape] = x
    main_inputs = [inputs[s] for s in main_shapes]
    gs_ms = cuda_ms(lambda: [gs.gram_schmidt(x) for x in main_inputs])
    plain_ms = cuda_ms(lambda: [orthogonalize(x) for x in main_inputs], reps=10)
    bound_ms, bound_by = gs_bound(main_shapes)
    per_group_ms = {
        str(s): cuda_ms(lambda x=inputs[s]: gs.gram_schmidt(x)) for s in main_shapes
    }
    main_err = max(errs[str(s)] for s in main_shapes)
    emit({
        "phase": "gram_schmidt", "tolerance": GS_TOL, "max_abs_err": errs,
        "main_path_groups": len(main_shapes), "ms_per_step": gs_ms,
        "device_ms_per_step": device_ms(lambda: [gs.gram_schmidt(x) for x in main_inputs], "gram_schmidt_kernel"),
        "plain_ms_per_step": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "ms_per_group": per_group_ms,
    })
    del inputs, main_inputs

    # the fused kernels, at every main-path shape group and a few others
    extra_groups = [(3, 100, 37, 8), (1, 2, 3, 2), (1, 4608, 512, 1), (1, 4608, 512, 8), (1, 4608, 512, 32)]
    report, kept = check_fused_kernels(ps, group_shapes + extra_groups, dev, gen, set(group_shapes))
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
            "device_ms": device_ms(lambda: [kernel(x) for x in main_x], device_fn[name]),
            "bound_ms": b_ms, "bound_by": b_by, "bound_bytes": nbytes,
            "library_ms": step_ms(library, 20) if library is not None else None,
        }
    xla_ms = {name: step_ms(xla, 20) for name, (_, _, _, xla) in timed.items()}
    emit({
        "phase": "fused_kernels", "tolerance": FUSED_TOL, "main_path_groups": len(group_shapes),
        "per_shape": report, "per_step": fused_rows,
    })
    del kept, main_x
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default

    # ---- 3. the main path, xla and fused ----------------------------------------
    results = {}
    launches = {}
    for impl in ("xla", "pallas"):
        cfg = powersgd_cifar10.default_config()
        cfg.training_epochs = 1
        cfg.compress_impl = impl
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for k in (gs.KERNEL, *ps.KERNELS):
            k.launches = 0
        result = powersgd_cifar10.run(cfg, preset="full", device=dev, max_steps_per_epoch=MAIN_STEPS)
        launches[impl] = {k.name: k.launches for k in (gs.KERNEL, *ps.KERNELS)}
        peak = torch.cuda.max_memory_allocated(dev)
        results[impl] = result
        groups = result["shape_groups"]
        expected = MAIN_STEPS * groups
        want = (
            {"gram_schmidt": expected, "ef_compress": 0, "compress": 0, "orthogonalize_project": 0, "decompress_residual": 0}
            if impl == "xla" else
            {"gram_schmidt": 0, "ef_compress": expected, "compress": 0, "orthogonalize_project": expected, "decompress_residual": expected}
        )
        if expected <= 0 or launches[impl] != want:
            fail(f"{impl} main path launched {launches[impl]}, expected {want}")
        record = main_path_record("main_path" if impl == "xla" else "main_path_fused", result, cfg, peak)
        record["launches"] = launches[impl]
        emit(record)
        emit(profile_main_path(dev, cfg, {
            "gram_schmidt": "gram_schmidt_kernel", "ef_compress": "ef_compress_kernel",
            "orthogonalize_project": "orthogonalize_project_kernel",
            "decompress_residual": "decompress_residual_kernel",
        }))
    if results["pallas"]["bits_per_step"] != results["xla"]["bits_per_step"]:
        fail(f"bits per step: fused {results['pallas']['bits_per_step']} != xla {results['xla']['bits_per_step']}")

    # ---- 4. two steps against two steps ---------------------------------------
    # with deterministic cuDNN and no TF32, so that only what is compared differs
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    images, labels, _ = load_cifar10_or_synthetic(train=True)

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

    # ---- 5. the kernels ------------------------------------------------------
    # what the xla path runs for the same work, as a yardstick for later work
    emit({"phase": "xla_yardstick", "ms_per_step": xla_ms})
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
        "launches": launches["xla"]["gram_schmidt"],
        "max_abs_err": main_err,
        "ms": gs_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this sequential Gram-Schmidt
    }]
    for name, row in fused_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces[name],
            "launches": launches["pallas"][name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
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
