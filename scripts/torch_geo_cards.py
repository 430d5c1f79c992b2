#!/usr/bin/env python3
"""The two-level geo-resilient round and the adaptive loop across four
cards.

Run from the root of the repository on a machine with four CUDA cards::

    torchrun --nproc-per-node 4 scripts/torch_geo_cards.py [--out FILE]

(``--device cpu --preset small`` runs the same checks on four Gloo ranks
with ResNet-18 at batch 16.) It prints one JSON line a check on rank 0:

- ``geo_partition``: ``make_hierarchical_train_fn`` on ResNet-152 (preset
  ``full``: ``powersgd_cifar10``'s model, global batch 128, 32 a rank: 24
  steps of the 4,096 synthetic images) over
  the ranks as a 2 x 2 grid (two sites of two), PowerSGD rank 4 across the
  sites, ``sync_every`` 4, for 6 rounds: never partitioned, and with a
  ``comm_partition`` of rank 0's edge from round 2, healed at round 4. An
  ``OuterSyncDriver`` decides each round from the injector's flag, agreed
  over the ranks (one int32 max), so every rank runs the same round: sync,
  sync, local, local, then the rejoin. Held: within a site the copies are
  equal bit for bit during the partition and the sites differ; after the
  rejoin every copy is equal bit for bit; the last round's mean loss within
  the JAX package's bound of the never-partitioned run's (``2 x + 1e-3``).
- ``adaptive_stall``: ``exact_cifar10`` (ResNet-50, batch 256) with
  ``adaptive_comm`` at world 4 for 2 epochs of 4 steps, a 1 s
  ``comm_stall`` on rank 2 only at step 2: each rank's failures, its
  decisions and final rung, the wall time of the run, and whether every
  rank picked the same rung.

The card's name and power limit come from ``nvidia-smi``.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, ROUNDS, PARTITION_AT, HEAL_AT = 4, 6, 2, 4
ADAPTIVE_STEPS, STALL_S, STALL_RANK = 4, 1.0, 2


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--preset", choices=["full", "small"], default="full")
    p.add_argument("--out", default=None, help="also write the records here, one JSON line each")
    args = p.parse_args()

    import torch
    import torch.distributed as dist

    from network_distributed_pytorch_tpu_torch.data.cifar10 import load_cifar10_or_synthetic
    from network_distributed_pytorch_tpu_torch.experiments import exact_cifar10, powersgd_cifar10
    from network_distributed_pytorch_tpu_torch.experiments.common import (
        accumulated_batches,
        image_classifier_loss,
        local_shard,
    )
    from network_distributed_pytorch_tpu_torch.parallel import comm
    from network_distributed_pytorch_tpu_torch.parallel.hierarchical import (
        make_hierarchical_groups,
        make_hierarchical_train_fn,
    )
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )
    from network_distributed_pytorch_tpu_torch.parallel.reducers import PowerSGDReducer
    from network_distributed_pytorch_tpu_torch.resilience import (
        ChaosPlan,
        CommFaultInjector,
        FaultSpec,
        OuterSyncDriver,
        PartitionPolicy,
    )

    rank, world = int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))
    if world != 4:
        sys.exit(f"run under torchrun --nproc-per-node 4 (world {world})")
    on_cuda = args.device == "cuda"
    if on_cuda and not torch.cuda.is_available():
        sys.exit("CUDA is not available: pass --device cpu")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) if on_cuda else torch.device("cpu")
    if on_cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    group = initialize_distributed(
        DistributedConfig(process_id=rank, num_processes=world, coordinator_address="env://"), dev
    )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[:1] if on_cuda else ["cpu"]
    records = []

    def emit(record):
        if rank == 0:
            records.append(record)
            sys.stdout.write(json.dumps(record) + "\n")
            sys.stdout.flush()

    def gathered(value):
        out = [None] * world
        dist.all_gather_object(out, value)
        return out

    def same_on_every_rank(tensors):
        """The names of the tensors whose bits differ from rank 0's."""
        differ = []
        for name, t in tensors.items():
            ref = t.detach().clone()
            dist.broadcast(ref, 0)
            if not bool(torch.equal(ref, t.detach())):
                differ.append(name)
        return sorted(set(sum(gathered(differ), [])))

    try:
        images, labels, _ = load_cifar10_or_synthetic(train=True)
        # ---- geo_partition -------------------------------------------------------
        hcfg = powersgd_cifar10.default_config()
        hcfg.global_batch_size = 16 if args.preset == "small" else 128
        steps = list(accumulated_batches([images, labels], hcfg, max_steps_per_epoch=H * ROUNDS)(0))
        if len(steps) < H * ROUNDS:
            sys.exit(f"{len(steps)} batches of {hcfg.global_batch_size} for {ROUNDS} rounds of {H}")
        rounds = [
            [tuple(torch.from_numpy(a).to(dev) for a in local_shard(b, rank, world)) for b in steps[i * H:(i + 1) * H]]
            for i in range(ROUNDS)
        ]
        groups = make_hierarchical_groups(2, group)
        site_ranks = tuple(dist.get_process_group_ranks(groups[0]))

        def run(partitioned):
            model = powersgd_cifar10.build_model(args.preset, dev, seed=hcfg.seed)
            reducer = PowerSGDReducer(random_seed=hcfg.seed, compression_rank=hcfg.reducer_rank)
            fn = make_hierarchical_train_fn(
                image_classifier_loss(), model, inner_learning_rate=0.05, sync_every=H, outer_reducer=reducer,
                groups=groups, group=group, outer_async=False,
            )
            state = fn.init_state()
            faults = [
                FaultSpec(kind="comm_partition", step=PARTITION_AT, rank=0,
                          payload={"edge": [0, 2], "max_sleep_s": 0.02}),
                FaultSpec(kind="comm_heal", step=HEAL_AT, rank=0),
            ] if partitioned else []
            injector = CommFaultInjector(ChaosPlan(faults), rank=rank)
            policy = PartitionPolicy(max_local_steps=4 * H, rank=rank)
            # the flag is rank 0's alone: the ranks agree on it, so that every
            # rank runs the same round
            driver = OuterSyncDriver(
                policy, probes=[lambda: bool(comm.agree(int(injector.partitioned), group, "max", kind="partition"))],
                edge_probe=lambda: (0, 2),
            )
            comm.add_fence_hook(injector)
            kinds, losses, site_equal, all_equal, round_ms = [], [], [], [], []
            try:
                for i, batches in enumerate(rounds):
                    injector.advance(i)
                    sync = driver.should_sync(step=i)
                    if on_cuda:
                        torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    state, round_losses = fn(state, batches, local=not sync)
                    losses.append(round_losses.tolist())
                    if on_cuda:
                        torch.cuda.synchronize(dev)
                    round_ms.append((time.perf_counter() - t0) * 1e3)
                    if sync:
                        driver.note_sync(step=i)
                    else:
                        driver.note_local(H, step=i)
                    kinds.append("sync" if sync else "local")
                    differ = same_on_every_rank(state.params)
                    all_equal.append(not differ)
                    # within a site: against the site's first rank
                    w = {k: v.detach().clone() for k, v in state.params.items()}
                    for k, v in w.items():
                        dist.broadcast(v, site_ranks[0], group=groups[0])
                    mine = all(torch.equal(w[k], state.params[k]) for k in w)
                    site_equal.append(all(gathered(mine)))
            finally:
                comm.remove_fence_hook(injector)
            return {
                "rounds": kinds, "losses": losses, "site_copies_equal": site_equal, "every_copy_equal": all_equal,
                "round_ms": round_ms, "events": [e.phase for e in policy.events],
                "bits_per_round": fn.bits_per_round, "local_bits_per_round": fn.local_bits_per_round,
            }

        oracle = run(False)
        part = run(True)
        final = sum(part["losses"][-1]) / H
        final_oracle = sum(oracle["losses"][-1]) / H
        mean_losses = gathered((final, final_oracle))
        final = sum(a for a, _ in mean_losses) / world
        final_oracle = sum(b for _, b in mean_losses) / world
        want_rounds = ["sync", "sync", "local", "local", "sync", "sync"]
        held = (
            part["rounds"] == want_rounds and oracle["rounds"] == ["sync"] * ROUNDS
            and all(part["site_copies_equal"])
            and not any(part["every_copy_equal"][i] for i in (2, 3))
            and all(part["every_copy_equal"][i] for i in (0, 1, 4, 5)) and all(oracle["every_copy_equal"])
            and final <= 2.0 * final_oracle + 1e-3
        )
        emit({
            "check": "geo_partition", "preset": args.preset, "grid": "2 x 2", "sync_every": H,
            "global_batch": hcfg.global_batch_size, "partitioned": part, "never_partitioned": oracle,
            "final_mean_loss": final, "final_mean_loss_never_partitioned": final_oracle,
            "bound": "final <= 2 x never-partitioned + 1e-3", "held": held, "nvidia_smi": smi,
        })

        # ---- adaptive_stall --------------------------------------------------------
        root = tempfile.mkdtemp(prefix="geo_cards_")
        cfg = exact_cifar10.default_config()
        cfg.training_epochs, cfg.log_every, cfg.num_processes, cfg.process_id = 2, 0, world, rank
        if args.preset == "small":
            cfg.global_batch_size = 16
        cfg.adaptive_comm = True
        # every rank loads the same plan, each from its own copy
        cfg.chaos_plan = os.path.join(root, "plan.json")
        cfg.event_log = os.path.join(root, "events.jsonl")
        ChaosPlan([FaultSpec(kind="comm_stall", step=2, rank=STALL_RANK, payload={"stall_seconds": STALL_S})]).save(
            cfg.chaos_plan
        )
        t0 = time.perf_counter()
        summary = exact_cifar10.run(cfg, preset=args.preset, device=dev, max_steps_per_epoch=ADAPTIVE_STEPS)
        wall = time.perf_counter() - t0
        with open(cfg.event_log) as f:
            events = [json.loads(line) for line in f]
        mine = {
            "rank": rank, "final_rung": summary["final_rung"], "policy_decisions": summary["policy_decisions"],
            "steps": summary["steps"], "wall_s": wall,
            "failures": [(e["kind"], e.get("label"), e.get("step")) for e in events if e.get("event") == "failure"],
            "policy": [(e["rung_before"], e["rung_after"], e["epoch"]) for e in events if e.get("event") == "policy"],
            "step_ms": [round(e["step_time_s"] * 1e3, 3) for e in events if e.get("event") == "step"],
        }
        per_rank = gathered(mine)
        emit({
            "check": "adaptive_stall", "preset": args.preset, "world": world, "stall_rank": STALL_RANK,
            "stall_s": STALL_S, "per_rank": per_rank,
            "same_rung_on_every_rank": len({r["final_rung"] for r in per_rank}) == 1
                                       and len({tuple(map(tuple, r["policy"])) for r in per_rank}) == 1,
            "nvidia_smi": smi,
        })
        shutil.rmtree(root, ignore_errors=True)
    finally:
        shutdown_distributed()
    if rank == 0 and args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
