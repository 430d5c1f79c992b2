#!/usr/bin/env python3
"""K5's bf16 backward kernels timed alone, one kernel at a time, so that two
versions of the port can be compared in turns on one card.

Run from the root of the repository on a machine with a CUDA card::

    python3 scripts/torch_flash_bwd_probe.py [--root DIR] [--reps N]

``--root`` imports the port from another checkout (for instance an older
commit unpacked with ``git archive`` into a git-ignored directory), whose
kernels it builds there; the script itself may be newer than that checkout.
On random bf16 heads from a fixed seed, each case's forward kernel gives out
and lse, and the backward then runs ``launches`` times a step:

- ``gpt2_causal``: GPT-2 small's causal heads (B 16, T 1024, H 12, D 64),
  12 launches a step;
- ``imdb_mask``: DistilBERT-base's heads (B 16, T 256, H 12, D 64) with 42
  real keys a row, 6 launches a step.

For each it reports the ``torch.profiler`` device time a step of every
kernel whose name holds ``flash_bwd`` (the Dr pre-pass, dK/dV and dQ
separately), their sum, CUDA events around the step (host enqueue
included), and the device time of SDPA's backward on the same inputs (the
gradient of its output in q, k, v, its forward excluded). It prints one
JSON line, then the card's name and power limit. Without a CUDA device it
prints no result and exits 1.
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


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT, help="the checkout whose port is timed")
    ap.add_argument("--reps", type=int, default=5)
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
    report = {"root": root, "reps": args.reps}
    for name, (b, t, h, d, causal, keys, launches) in CASES.items():
        q, k, v, do = (torch.randn((b * h, t, d), generator=gen).to(dev, torch.bfloat16) for _ in range(4))
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
    print(json.dumps(report))
    print(smi)


if __name__ == "__main__":
    main()
