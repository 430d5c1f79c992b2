"""Loader-throughput smoke of the port: one epoch of the host data plane.

Drives the port's ingestion stack end to end on a synthetic uint8
CIFAR-shaped dataset: the native loader (``native.NativeBatchLoader``, its
numpy fallback where the C++ library cannot build or
``NDP_TPU_NO_NATIVE=1``) feeding a small step on the device through
``data.loader.device_prefetch`` (pinned slots and a side stream on a card),
and writes the measured rates as JSON: the loader's own epoch rate, the
staged rate of the ``LoaderEvent``, the share of the loop spent blocked in
the fetch, and whether every staged batch's labels arrived (a sum a batch
on the device against the host's). It exits 1 when no sample moved, when
a batch arrived wrong, or when the native path did not run on a card.

Machine output goes to ``--json-out`` (or stdout when omitted); human
lines go to stderr.

Usage::

    python3 scripts/torch_loader_smoke.py [--device cuda] [--n 2048] [--batch 64] [--depth 2] [--json-out F]
    python3 scripts/torch_loader_smoke.py --device cpu
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--n", type=int, default=2048)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--depth", type=int, default=2)
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from network_distributed_pytorch_tpu_torch.data.loader import device_prefetch, epoch_order
    from network_distributed_pytorch_tpu_torch.native import NativeBatchLoader, native_available
    from network_distributed_pytorch_tpu_torch.observe import MemorySink, Telemetry
    from network_distributed_pytorch_tpu_torch.observe.spans import recording

    device = torch.device(args.device)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, size=(args.n, 32, 32, 3)).astype(np.uint8)
    y = rng.randint(0, 10, size=(args.n,)).astype(np.int32)
    loader = NativeBatchLoader(x, y, args.batch, seed=0, depth=args.depth)

    # the loader's own epoch rate, whichever path this machine runs
    for _ in loader.epoch(0):  # warm-up: the library's build or load, first touch
        pass
    t0 = time.perf_counter()
    count = 0
    for bx, _ in loader.epoch(0):
        count += len(bx)
    rate = count / (time.perf_counter() - t0)

    # the overlapped leg: a small step on the device consuming the staged
    # batches, timing only the blocked fetch (the loader's share of the loop)
    feat = int(np.prod(x.shape[1:]))
    w = torch.from_numpy(rng.randn(feat, 64).astype(np.float32) * 0.01).to(device)
    label_sums = []
    sink = MemorySink()
    wait_s, steps = 0.0, 0
    t_loop = time.perf_counter()
    with recording(Telemetry([sink])):
        it = device_prefetch(loader.epoch(1), device, depth=args.depth, label="loader_smoke")
        while True:
            t1 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            wait_s += time.perf_counter() - t1
            bx, by = batch
            out = torch.tanh(bx.reshape(bx.shape[0], -1) @ w).sum()
            label_sums.append(by.sum())
            float(out)  # the step's result on the host: the consumer waits for it
            steps += 1
    total = time.perf_counter() - t_loop
    order = epoch_order(args.n, args.batch, seed=0, epoch=1)
    want = [int(y[idx].sum()) for idx in np.split(order[: steps * args.batch], steps)] if steps else []
    labels_ok = [int(s) for s in label_sums] == want
    (event,) = sink.of_kind("loader") or [{}]
    native = bool(native_available()) and bool(loader.last_stats and loader.last_stats["native"])

    out = {
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "native": native,
        "n": args.n,
        "batch": args.batch,
        "prefetch_depth": args.depth,
        "samples_per_s": rate,
        "staged_samples_per_s": event.get("samples_per_s"),
        "staging_wait_s": event.get("wait_s"),
        "overlapped_steps": steps,
        "data_load_share": wait_s / total if total > 0 else None,
        "consumer_wait_s": loader.last_stats["consumer_wait_s"],
        "labels_ok": labels_ok,
    }
    doc = json.dumps(out, indent=2, sort_keys=True)
    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            f.write(doc + "\n")
    else:
        sys.stdout.write(doc + "\n")

    tier = "native" if native else "numpy fallback"
    sys.stderr.write(
        f"# torch_loader_smoke: {tier} loader moved {count} samples at {rate:,.0f}/s; staged on {device} at"
        f" {out['staged_samples_per_s'] or 0:,.0f}/s, fetch share {out['data_load_share']}\n"
    )
    if not rate > 0 or steps == 0 or not (out["staged_samples_per_s"] or 0) > 0:
        sys.stderr.write("# torch_loader_smoke: FAIL: the pipeline moved no data\n")
        return 1
    if not labels_ok:
        sys.stderr.write("# torch_loader_smoke: FAIL: a staged batch's labels are not the host's\n")
        return 1
    if device.type == "cuda" and not native:
        sys.stderr.write("# torch_loader_smoke: FAIL: the native loader did not run on the card's machine\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
