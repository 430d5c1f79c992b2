#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. the card (``nvidia-smi``), torch and CUDA versions, and the build of
   every CUDA kernel of the port (one ``nvcc`` per source, started together);
2. the Gram-Schmidt kernel against its plain PyTorch version on the card, at
   every (g, n, r) shape group of the main path (ResNet-152, rank 4), a
   ragged n = 100 and r in {1, 8, 32} at n = 4608, with TF32 off;
3. the main path: ``powersgd_cifar10.run`` with preset ``full`` (ResNet-152,
   ImageNet stem, width 64, global batch 512, PowerSGD rank 4) through a
   one-rank NCCL group, 2 warm-up and 5 timed steps, then 3 steps under
   ``torch.profiler``; 2 steps with the plain Gram-Schmidt against 2 with
   the kernel, from the same weights and batches; and 2 steps of the small
   preset on the card against the same 2 on the CPU;
4. one ``{"kernels": [...]}`` line: each kernel's launches on the main path,
   its time, the plain version's, and the least time the card could take.

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


def gs_bound(shapes):
    """Bytes (one read and one write of every P) and fp32 operations of the
    Gram-Schmidt of every (g, n, r) in ``shapes``; the least time is the
    larger of the two over the card's peaks."""
    nbytes = sum(2 * g * n * r * 4 for g, n, r in shapes)
    # per column i: norm 2n, scale n, then 4n for each of the r-i-1 later columns
    ops = sum(g * (3 * n * r + 4 * n * r * (r - 1) // 2) for g, n, r in shapes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def profile_main_path(dev):
    """Where a main-path step's time goes: ``torch.profiler`` over
    PROFILE_STEPS steps of the full preset through a one-rank NCCL group,
    after one warm-up step. Device numbers are None where the profiler saw
    no device activity."""
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

    cfg = powersgd_cifar10.default_config()
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
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        del model, step, state
    finally:
        shutdown_distributed()
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / PROFILE_STEPS
    gs = [e for e in kernels if "gram_schmidt" in e.key]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    seen = busy_ms > 0
    return {
        "phase": "profile", "steps": PROFILE_STEPS, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms if seen else None,
        "device_idle_share": 1 - busy_ms / wall_ms if seen else None,
        "gram_schmidt_device_ms_per_step": (
            sum(e.self_device_time_total for e in gs) / 1e3 / PROFILE_STEPS if seen else None
        ),
        "gram_schmidt_device_us_per_launch": (
            sum(e.self_device_time_total for e in gs) / max(sum(e.count for e in gs), 1) if seen else None
        ),
        "top_kernels": [
            {
                "name": e.key[:90],
                "ms_per_step": e.self_device_time_total / 1e3 / PROFILE_STEPS,
                "calls_per_step": e.count / PROFILE_STEPS,
            }
            for e in top
        ],
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

    # ---- 2. the Gram-Schmidt kernel against its plain version ------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = powersgd_cifar10.default_config()
    model, step, _ = powersgd_cifar10.build(cfg, "full", dev, group=None)
    params = list(model.parameters())
    reducer = step.reducer
    metas = reducer._metas(params)
    main_shapes = [
        (len(poss), metas[poss[0]].n, metas[poss[0]].r) for poss in reducer._shape_groups(metas)
    ]
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
        "plain_ms_per_step": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "ms_per_group": per_group_ms,
    })
    del inputs, main_inputs
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default

    # ---- 3. the main path ----------------------------------------------------
    cfg = powersgd_cifar10.default_config()
    cfg.training_epochs = 1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gs.KERNEL.launches = 0
    result = powersgd_cifar10.run(
        cfg, preset="full", device=dev, max_steps_per_epoch=MAIN_STEPS
    )
    launches = gs.KERNEL.launches
    peak = torch.cuda.max_memory_allocated(dev)
    losses = result["losses"]
    if len(losses) != MAIN_STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"main path losses {losses}")
    expected = MAIN_STEPS * result["shape_groups"]
    if launches <= 0 or launches != expected:
        fail(f"gram_schmidt launched {launches} times on the main path, expected {expected}")
    timed_ms = result["device_time_ms"][WARMUP_STEPS:]
    host_s = result["step_time_s"][WARMUP_STEPS:]
    p50_ms = statistics.median(timed_ms)
    emit({
        "phase": "main_path", "model": "resnet152", "stem": "imagenet", "width": 64,
        "global_batch": cfg.global_batch_size, "reducer_rank": cfg.reducer_rank,
        "world_size": result["num_devices"], "losses": losses,
        "timed_steps": len(timed_ms), "step_device_ms": timed_ms,
        "step_device_ms_p50": p50_ms, "step_host_s_p50": statistics.median(host_s),
        "images_per_s": cfg.global_batch_size / (p50_ms / 1e3),
        "peak_memory_bytes": peak, "bits_per_step": result["bits_per_step"],
        "shape_groups": result["shape_groups"], "gram_schmidt_launches": launches,
    })

    emit(profile_main_path(dev))

    # the same 2 steps twice, with deterministic cuDNN and no TF32, so that
    # only what is compared differs
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    images, labels, _ = load_cifar10_or_synthetic(train=True)

    def two_steps(cfg, preset, device):
        model, step, state = powersgd_cifar10.build(cfg, preset, device, group=None)
        losses = []
        for batch in accumulated_batches([images, labels], cfg, max_steps_per_epoch=2)(0):
            state, loss = step(state, tuple(torch.from_numpy(a).to(device) for a in batch))
            losses.append(loss.item())
        return losses, {k: v.detach().cpu() for k, v in state.params.items()}

    def max_diff(a, b):
        return max((a[k] - b[k]).abs().max().item() for k in a)

    # the main path with the plain Gram-Schmidt against the kernel
    finals = {}
    for impl in ("eager", "cuda"):
        cfg = powersgd_cifar10.default_config()
        cfg.orthogonalize_impl = impl
        finals[impl] = two_steps(cfg, "full", dev)[1]
    diff = max_diff(finals["eager"], finals["cuda"])
    if not math.isfinite(diff) or diff > PARAM_TOL:
        fail(f"params after 2 steps, eager vs cuda Gram-Schmidt: max diff {diff} > {PARAM_TOL}")
    emit({"phase": "eager_vs_cuda", "steps": 2, "max_param_diff": diff, "tolerance": PARAM_TOL})

    # a small input against the CPU path, which the CPU tests hold against
    # the JAX package: the small preset at global batch 16, on the card and
    # on the CPU, from the same seed and batches
    cfg = powersgd_cifar10.default_config()
    cfg.global_batch_size = 16
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

    # ---- 4. the kernels ------------------------------------------------------
    emit({"kernels": [{
        "name": "gram_schmidt",
        "route": "cuda",
        "source": "network_distributed_pytorch_tpu_torch/csrc/gram_schmidt.cu",
        "replaces": "network_distributed_pytorch_tpu/ops/pallas_orthogonalize.py:28",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": gs_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this sequential Gram-Schmidt
    }]})
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
