#!/usr/bin/env python3
"""Fully-sharded data parallelism (ZeRO-3) of ``exact_cifar10`` across four
cards, held against exact DDP on the same cards.

Run from the root of the repository on a machine with four CUDA cards::

    torchrun --nproc-per-node 4 scripts/torch_fsdp_cards.py [--out FILE]

(``--device cpu --preset small`` runs the same checks on four Gloo ranks
with ResNet-18 at batch 16.) Preset ``full`` is ``exact_cifar10``'s:
ResNet-50 with the ImageNet stem, global batch 256 (64 a rank), SGD with
momentum 0.9. Every rank builds the model from one seed and takes its
slice of the same batches. It prints one JSON line a check on rank 0:

- two steps under deterministic cuDNN: FSDP's unsharded parameters
  against DDP's, held to ``TOL`` of ``max(1, max|DDP|)`` of each leaf (a
  reduce-scatter and an all-reduce sum four ranks in other orders), with
  the losses; chunked FSDP (K = 4) against monolithic, bit for bit or the
  largest difference (NCCL may cut a buffer into channels by its size, and
  a sum of four terms can round by the order the cut gives);
- each strategy's 5 timed steps after 2 warm-up ones (CUDA events), the
  bits a step by kind as recorded (FSDP: 1,505,825,568 at world 4, two of
  them the padding of the 10-way head's bias), each rank's peak memory
  (the largest over the ranks) and the bytes of its training state, and
  one profiled step on rank 0, the ranks entering it together: the NCCL
  kernels' time (which holds the wait for the other ranks, each slowed
  by its profiler) and the compute stream's busy time and idle share.

The card's name and power limit come from ``nvidia-smi``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TOL = 1e-5
FSDP_BITS_AT_4 = 1_505_825_568
CHUNKS = 4
WARMUP, TIMED = 2, 5


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--preset", choices=["full", "small"], default="full")
    p.add_argument("--out", default=None, help="also write the records here, one JSON line each")
    args = p.parse_args()

    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from network_distributed_pytorch_tpu_torch.data.cifar10 import load_cifar10_or_synthetic
    from network_distributed_pytorch_tpu_torch.experiments import exact_cifar10
    from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches, local_shard
    from network_distributed_pytorch_tpu_torch.parallel.comm import record_collectives
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )

    rank, world = int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))
    if world != 4:
        sys.exit(f"run under torchrun --nproc-per-node 4 (world {world})")
    on_cuda = args.device == "cuda"
    if on_cuda and not torch.cuda.is_available():
        sys.exit("CUDA is not available: pass --device cpu")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) if on_cuda else torch.device("cpu")
    if on_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    group = initialize_distributed(
        DistributedConfig(process_id=rank, num_processes=world, coordinator_address="env://"), dev
    )
    records = []

    def emit(record):
        if rank == 0:
            records.append(record)
            sys.stdout.write(json.dumps(record) + "\n")
            sys.stdout.flush()

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    def worst_over_ranks(value):
        t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.item()

    try:
        cfg = exact_cifar10.default_config()
        if args.preset == "small":
            cfg.global_batch_size = 16
        images, labels, _ = load_cifar10_or_synthetic(train=True)
        batches = [
            tuple(torch.from_numpy(a).to(dev) for a in local_shard(b, rank, world))
            for b in accumulated_batches([images, labels], cfg, max_steps_per_epoch=WARMUP + TIMED + 1)(0)
        ]

        def build(strategy, chunks=None):
            cfg.comm_chunks = chunks
            model, step, state = exact_cifar10.build(cfg, args.preset, dev, group, strategy=strategy)
            return model, step, state

        def state_bytes(state):
            tensors = []
            for field in ("params", "momenta", "memories", "model_state", "param_shards", "opt_shards"):
                value = getattr(state, field, None)
                if isinstance(value, dict):
                    tensors += list(value.values())
            return sum(t.numel() * t.element_size() for t in tensors)

        # ---- two steps from the same weights, deterministic cuDNN -------------------
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        finals, losses = {}, {}
        for name, strategy, chunks in (("ddp", "ddp", None), ("fsdp", "fsdp", None), ("fsdp_chunked", "fsdp", CHUNKS)):
            _, step, state = build(strategy, chunks)
            losses[name] = []
            for b in batches[:2]:
                state, loss = step(state, b)
                losses[name].append(loss.item())
            finals[name] = step.unshard(state) if strategy == "fsdp" else {
                k: v.detach().clone() for k, v in state.params.items()
            }
            del step, state
        worst, leaf = 0.0, None
        for k, want in finals["ddp"].items():
            d = (finals["fsdp"][k] - want).abs().max().item() / max(1.0, want.abs().max().item())
            if d > worst:
                worst, leaf = d, k
        worst = worst_over_ranks(worst)
        chunk_diff = worst_over_ranks(max((finals["fsdp_chunked"][k] - v).abs().max().item() for k, v in finals["fsdp"].items()))
        loss_diff = max(abs(a - b) for a, b in zip(losses["fsdp"], losses["ddp"]))
        ok = worst <= TOL and loss_diff <= TOL
        emit({
            "check": "fsdp_vs_ddp_after_2_steps", "ok": ok, "max_rel_param_diff": worst, "leaf_rank0": leaf,
            "loss_diff": loss_diff, "losses": losses, "tolerance": TOL,
            "chunked_vs_monolithic_max_abs_diff": chunk_diff, "chunked_vs_monolithic_bitwise": chunk_diff == 0.0,
        })
        del finals
        torch.backends.cudnn.deterministic = False

        # ---- timing, bits, memory and NCCL, one strategy at a time ----------------------
        for name, strategy, chunks in (("ddp", "ddp", None), ("fsdp", "fsdp", None), ("fsdp_chunked", "fsdp", CHUNKS)):
            if on_cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            _, step, state = build(strategy, chunks)
            held = state_bytes(state)
            times = []
            with record_collectives() as recorded:
                state, loss = step(state, batches[0])
            loss.item()
            for i, b in enumerate(batches[1 : WARMUP + TIMED]):
                if on_cuda:
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                state, loss = step(state, b)
                if on_cuda:
                    end.record()
                loss.item()
                if i + 1 >= WARMUP and on_cuda:
                    times.append(start.elapsed_time(end))
            sync()
            peak = torch.cuda.max_memory_allocated(dev) if on_cuda else None
            busy = nccl = wall = None
            if on_cuda:
                dist.barrier()  # the ranks enter the profiled step together
                sync()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    state, loss = step(state, batches[WARMUP + TIMED])
                    loss.item()
                    wall = (time.perf_counter() - t0) * 1e3
                device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
                busy = sum(e.self_device_time_total for e in device) / 1e3
                nccl = sum(e.self_device_time_total for e in device if "nccl" in e.key.lower()) / 1e3
            by_kind = {}
            for r in recorded:
                by_kind.setdefault(r.kind, [0, 0])
                by_kind[r.kind][0] += 1
                by_kind[r.kind][1] += 8 * r.payload_bytes
            bits = sum(v[1] for v in by_kind.values())
            if strategy == "fsdp" and args.preset == "full" and bits != FSDP_BITS_AT_4:
                ok = False
            p50 = statistics.median(times) if times else None
            emit({
                "check": f"timing_{name}", "comm_chunks": chunks, "step_ms_p50": p50, "step_ms": times,
                "images_per_s": cfg.global_batch_size / (p50 / 1e3) if p50 else None,
                "bits_per_step": bits, "collectives_by_kind": {k: v[0] for k, v in by_kind.items()},
                "bits_by_kind": {k: v[1] for k, v in by_kind.items()},
                "peak_memory_bytes_max_over_ranks": worst_over_ranks(peak) if on_cuda else None,
                # NCCL's kernels run on their own stream and hold the wait for the
                # other ranks: the compute stream's busy time is the rest
                "state_bytes_rank0": held, "profiled_step_wall_ms": wall, "profiled_step_nccl_ms": nccl,
                "profiled_step_compute_busy_ms": busy - nccl if on_cuda else None,
                "profiled_step_compute_idle_share": 1 - (busy - nccl) / wall if on_cuda else None,
            })
            del step, state

        smi = None
        if on_cuda and rank == 0:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True).stdout.strip().splitlines()
        emit({"all_ok": bool(ok), "world": world, "device": args.device, "preset": args.preset, "nvidia_smi": smi})
        if rank == 0 and args.out:
            with open(args.out, "w") as f:
                for r in records:
                    f.write(json.dumps(r) + "\n")
    finally:
        shutdown_distributed()
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
