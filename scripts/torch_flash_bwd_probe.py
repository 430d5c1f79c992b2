#!/usr/bin/env python3
"""K5's backward kernels timed alone, one kernel at a time, so that two
versions of the port can be compared in turns on one card.

Run from the root of the repository on a machine with a CUDA card::

    python3 scripts/torch_flash_bwd_probe.py [--root DIR] [--reps N] [--dtype {bfloat16,float32}]
        [--gpt2-steps N]

``--root`` imports the port from another checkout (for instance an older
commit unpacked with ``git archive`` into a git-ignored directory), whose
kernels it builds there; the script itself may be newer than that checkout.
On random heads of ``--dtype`` (bf16 unless asked) from a fixed seed, each
case's forward kernel gives out and lse, and the backward then runs
``launches`` times a step:

- ``gpt2_causal``: GPT-2 small's causal heads (B 16, T 1024, H 12, D 64),
  12 launches a step;
- ``imdb_mask``: DistilBERT-base's heads (B 16, T 256, H 12, D 64) with 42
  real keys a row, 6 launches a step.

For each it reports the ``torch.profiler`` device time a step of every
kernel whose name holds ``flash_bwd`` (the Dr pre-pass, dK/dV and dQ
separately), their sum, CUDA events around the step (host enqueue
included), and the device time of SDPA's backward on the same inputs (the
gradient of its output in q, k, v, its forward excluded). On fp32, where
the checkout has the TF32 self-test (``wgmma_tf32_selftest``), it also
reports what the tensor cores take of an fp32 operand and how far 3xTF32
chains of 3, 12, 24 and 48 passes into one accumulator stray from the same
passes summed in fp64 (``tf32_facts``). With ``--gpt2-steps N`` it also
takes N + 2 training steps of GPT-2 small in ``--dtype`` (``gpt_lm``'s
full preset, T 1024, global batch 16, PowerSGD rank 4, a one-rank NCCL
group) and reports each of the last N steps' device time (CUDA events
around the step), their median, and the device's busy time a step over
them (``torch.profiler``). It prints one JSON line, then the card's name
and power limit. Without a CUDA device it prints no result and
exits 1.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# b, t, h, d, causal, real keys a row (None: all), launches a step
CASES = {
    "gpt2_causal": (16, 1024, 12, 64, True, None, 12),
    "imdb_mask": (16, 256, 12, 64, False, 42, 6),
}


def fail(msg: str) -> None:
    sys.stderr.write(f"torch_flash_bwd_probe: {msg}\n")
    sys.exit(1)


def kernel_ms(fn, part, reps):
    """Device time of each kernel whose name holds ``part`` (name -> ms) in
    one call of ``fn()``, by ``torch.profiler`` over ``reps`` calls after
    three warm-up calls."""
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
    return {
        e.key: e.self_device_time_total / 1e3 / reps
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and part in e.key and e.self_device_time_total > 0
    }


def events_ms(fn, reps):
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


def _tf32(x):
    """x's TF32 value as the tensor cores take it: each fp32's low 13 bits cleared."""
    import torch

    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_facts(fa, dev) -> dict:
    """Stage 0 of the fp32 route, from the backward library's self-test:
    whether an fp32 operand is taken truncated (its low 13 bits ignored) or
    rounded, from A in shared memory (mode 0) and in registers (mode 1); and
    for chains of 3 k / 8 passes (k = 8, 32, 64, 128) of the kernels' 3xTF32
    product on unit normal (64, k) and (k, 64) operands, the largest error
    against the same three TF32 passes summed in fp64 (the accumulation's
    own drift) and against the fp64 product, each over max |a @ b|, the
    largest of five seeds."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    a = torch.from_numpy((1.0 + rng.randint(1, 2**13, (64, 64)) * 2.0**-23).astype(np.float32)).to(dev)
    eye = torch.eye(64, device=dev)
    facts = {}
    for mode, name in ((0, "a_shared"), (1, "a_registers")):
        c = fa.wgmma_tf32_selftest(a, eye, mode)
        torch.cuda.synchronize()
        facts[f"truncates_{name}"] = bool(torch.equal(c, _tf32(a)))
    for k in (8, 32, 64, 128):
        drift, total = 0.0, 0.0
        for seed in range(5):
            gen = torch.Generator().manual_seed(seed)
            x, y = torch.randn((64, k), generator=gen).to(dev), torch.randn((k, 64), generator=gen).to(dev)
            c = fa.wgmma_tf32_selftest(x, y, 3).double()
            xh, yh = _tf32(x), _tf32(y)
            xl, yl = _tf32(x - xh), _tf32(y - yh)
            passes = xl.double() @ yh.double() + xh.double() @ yl.double() + xh.double() @ yh.double()
            exact = x.double() @ y.double()
            top = exact.abs().max().item()
            drift = max(drift, (c - passes).abs().max().item() / top)
            total = max(total, (c - exact).abs().max().item() / top)
        facts[f"chain_{3 * k // 8}"] = {"drift_rel": drift, "err_vs_fp64_rel": total}
    return facts


def gpt2_steps(dev, dtype: str, steps: int) -> dict:
    """GPT-2 small's training step in ``dtype``, as the module docstring
    says: two warm-up steps, then ``steps`` timed and profiled."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from network_distributed_pytorch_tpu_torch.experiments import gpt_lm
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )

    b, t = 16, 1024
    cfg = gpt_lm.default_config()
    cfg.global_batch_size, cfg.compute_dtype = b, dtype
    group = initialize_distributed(DistributedConfig(), dev)
    try:
        model, step, state = gpt_lm.build(cfg, "full", t, "powersgd", dev, group)
        batches = [
            tuple(torch.from_numpy(a).to(dev) for a in batch)
            for batch in gpt_lm.synthetic_lm_batches(model.config.vocab_size, b, t, 2 + steps, cfg.seed)
        ]
        for batch in batches[:2]:
            state, loss = step(state, batch)
            loss.item()
        torch.cuda.synchronize()
        times = []
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for batch in batches[2:]:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                state, loss = step(state, batch)
                end.record()
                loss.item()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
        busy = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        del model, step, state
    finally:
        shutdown_distributed()
    p50, busy_ms = statistics.median(times), busy / 1e3 / steps
    return {"step_device_ms": times, "step_device_ms_p50": p50, "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1 - busy_ms / p50}


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT, help="the checkout whose port is timed")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--gpt2-steps", type=int, default=0, help="GPT-2 small training steps to time (0: none)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this probe needs a CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from network_distributed_pytorch_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    dtype = getattr(torch, args.dtype)
    report = {"root": root, "reps": args.reps, "dtype": args.dtype}
    if dtype == torch.float32 and hasattr(fa, "wgmma_tf32_selftest"):
        report["tf32_facts"] = tf32_facts(fa, dev)
    for name, (b, t, h, d, causal, keys, launches) in CASES.items():
        q, k, v, do = (torch.randn((b * h, t, d), generator=gen).to(dev, dtype) for _ in range(4))
        mask = torch.zeros((b, t))
        if keys is not None:
            mask[:, keys:] = torch.finfo(torch.float32).min
        mask = mask.to(dev)
        scale = d**-0.5
        out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, 128, 128, scale)

        def step():
            for _ in range(launches):
                fa.flash_attention_vjp(q, k, v, mask, out, lse, do, causal, 128, scale, False)

        sq, sk, sv = (x.view(b, h, t, d).detach().requires_grad_() for x in (q, k, v))
        sdpa_mask = None if keys is None else (mask > -1e29).view(b, 1, 1, t)
        sout = torch.nn.functional.scaled_dot_product_attention(sq, sk, sv, attn_mask=sdpa_mask, is_causal=causal)

        def library():
            for _ in range(launches):
                torch.autograd.grad(sout, (sq, sk, sv), do.view(b, h, t, d), retain_graph=True)

        per_kernel = kernel_ms(step, "flash_bwd", args.reps)
        report[name] = {
            "shape": [b, t, h, d], "causal": causal, "real_keys": keys or t, "launches_per_step": launches,
            "device_ms_by_kernel": per_kernel, "device_ms": sum(per_kernel.values()),
            "events_ms": events_ms(step, args.reps),
            "sdpa_backward_device_ms": sum(kernel_ms(library, "", args.reps).values()),
        }
        del sq, sk, sv, sout
    if args.gpt2_steps:
        report["gpt2_step"] = gpt2_steps(dev, args.dtype, args.gpt2_steps)
    print(json.dumps(report))
    print(smi)


if __name__ == "__main__":
    main()
