"""The bandwidth study's record, fed by the card: the JAX package's
``scripts/bandwidth_artifact.py`` on the port.

The reference exists to compare data-parallel training over in-node links
and 1, 10 and 100 GbE, and reports no number. This script writes that
table from measurements on both sides of the projection, one phase at a
time:

- **structure**: the port's ``experiments/bandwidth_study.run`` (preset
  small: ResNet-18 at width 16, CIFAR stem, global batch 256) on 8 Gloo
  ranks on the CPU, which the script spawns: each configuration's
  collectives and bytes as ``parallel.comm.record_collectives`` saw them at
  the projected world of 8 (the hierarchical row included). The structure
  of the 8-rank program does not depend on the device; its CPU timings are
  kept only as the fallback of a row the card does not time.
- **chip**: on the card, each flat row's per-worker compute time (the
  study's batch 256 over 8 workers: 32 images), local SGD's and DiLoCo's
  time an inner step, by CUDA events after a warm-up step or round; and
  the flagship's step (``experiments/powersgd_cifar10`` at preset full:
  ResNet-152, ImageNet stem, global batch 512, PowerSGD rank 4) in fp32
  and bf16, by the host clock after a warm-up step.
- **project**: the ring model of ``utils/bandwidth.py`` (``t = 2 (W - 1) / W
  * B / beta + n_coll * latency``) at W = 8 over each fabric: a row's
  projected step is its compute time plus the modelled time of its bits at
  8 workers; an avoidance row's collectives are amortised over its
  ``sync_every`` inner steps. The full-preset row joins the flagship's card
  step times to the bits of exact DDP and PowerSGD rank 4 on ResNet-152.
  ``speedup_vs_exact`` refuses a ratio between rows timed on different
  sources. The ``NVLink4(H100)`` row is the data sheet's rate, not a
  measurement.

Each phase merges into ``--out`` (default ``artifacts/TORCH_BANDWIDTH.json``)
as it goes. Every time in the record stands beside the card's name and
power limit as ``nvidia-smi`` gives them.

Usage:
    python3 scripts/torch_bandwidth_artifact.py structure   # 8 Gloo ranks on the CPU
    python3 scripts/torch_bandwidth_artifact.py chip        # on the card (--device cuda, the default)
    python3 scripts/torch_bandwidth_artifact.py project     # combine and print the table
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "artifacts", "TORCH_BANDWIDTH.json")

# the flat rows the card times; the avoidance rows are timed too, an inner
# step each. Only the hierarchical row keeps its CPU timing: its two levels
# of groups do not exist on one card, and speedup_vs_exact leaves it out
CHIP_CONFIGS = ("exact", "powersgd_r1", "powersgd_r2", "powersgd_r4", "topk_1pct", "signsgd", "qsgd_int8")
N_WORKERS = 8  # the projected world
STUDY_BATCH = 256  # the study's global batch
SEED = 714
CARD_SOURCE, CPU_SOURCE = "card", "cpu-mesh fallback"
# the flagship's card runs of the full-preset row: name -> compute dtype
FULL_PRESET_RUNS = {"powersgd_cifar10_full_bf16": "bfloat16", "powersgd_cifar10_full_fp32": "float32"}
FULL_PRESET_BATCH = 512
STRUCTURE_RANKS, STRUCTURE_TIMEOUT_S = N_WORKERS, 3000.0  # the structure's Gloo ranks, and their wall limit
STRUCTURE_RANK_ENV = "TORCH_BANDWIDTH_ARTIFACT_RANK_OUT"


def _load() -> dict:
    try:
        with open(OUT) as f:
            return json.load(f)
    except (OSError, ValueError):  # the first phase makes it
        return {}


def _save(art: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(OUT)), exist_ok=True)
    tmp = OUT + ".tmp"
    with open(tmp, "w") as f:
        json.dump(art, f, indent=1)
    os.replace(tmp, OUT)


def card_provenance(device) -> dict:
    """The card's name (torch's), its name and power limit as ``nvidia-smi``
    gives them, and torch's version."""
    import torch

    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return {
        "device": torch.cuda.get_device_name(device), "nvidia_smi": lines[device.index or 0],
        "torch": torch.__version__, "platform": "gpu",
    }


# ---- structure ----------------------------------------------------------------


def structure_record(study: dict) -> dict:
    """The ``structure`` section from a ``bandwidth_study.run`` result: the
    port's names ``collectives`` / ``collectives_per_round`` and
    ``recorded_bits_per_step`` / ``recorded_bits_per_round`` in place of the
    JAX record's ``hlo_collectives`` and ``audited_bits_per_step``."""
    where = "the CPU" if study["device"] == "cpu" else study["device"]
    return {
        "source": f"{study['num_devices']} rank(s) of the study on {where} (the collective structure does not depend"
        " on the device; these timings are a fallback only)",
        "num_devices": study["num_devices"],
        "projected_workers": study["projected_workers"],
        "global_batch": study["global_batch"],
        "results": study["results"],
    }


def _structure_rank() -> None:
    """One rank of the structure phase (the script run with
    ``STRUCTURE_RANK_ENV`` set by :func:`phase_structure`): the study at
    preset small over the ranks' Gloo group; rank 0 writes the result."""
    import torch

    from network_distributed_pytorch_tpu_torch.experiments import bandwidth_study
    from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    cfg = ExperimentConfig(
        process_id=rank, num_processes=world, coordinator_address=os.environ["TORCH_BANDWIDTH_ARTIFACT_INIT"]
    )
    out = bandwidth_study.run(
        cfg, preset="small", device="cpu", global_batch=int(os.environ["TORCH_BANDWIDTH_ARTIFACT_BATCH"]),
        project_workers=N_WORKERS,
    )
    if rank == 0:
        with open(os.environ[STRUCTURE_RANK_ENV], "w") as f:
            json.dump(out, f)


def phase_structure() -> dict:
    """Run the study at ``STUDY_BATCH`` on ``STRUCTURE_RANKS`` Gloo ranks on
    the CPU (processes of this script) and keep its collectives and bits,
    and its CPU timings as the fallback."""
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "study.json")
        env = {
            **os.environ, STRUCTURE_RANK_ENV: result, "WORLD_SIZE": str(STRUCTURE_RANKS),
            "TORCH_BANDWIDTH_ARTIFACT_BATCH": str(STUDY_BATCH),
            "TORCH_BANDWIDTH_ARTIFACT_INIT": "file://" + os.path.join(tmp, "rendezvous"), "OMP_NUM_THREADS": "1",
        }
        procs = [
            subprocess.Popen([sys.executable, os.path.abspath(__file__)], env={**env, "RANK": str(r)})
            for r in range(STRUCTURE_RANKS)
        ]
        try:
            deadline = time.monotonic() + STRUCTURE_TIMEOUT_S
            rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            raise RuntimeError(f"structure ranks exited {rcs}")
        with open(result) as f:
            study = json.load(f)
    art = _load()
    art["structure"] = structure_record(study)
    art["recorded_unix_structure"] = int(time.time())
    _save(art)
    print(json.dumps({k: v.get("collectives", v.get("collectives_per_round")) for k, v in study["results"].items()}))
    return art["structure"]


# ---- chip ----------------------------------------------------------------------


def _per_worker_batch(device):
    import torch

    from network_distributed_pytorch_tpu_torch.data.cifar10 import synthetic_cifar10

    images, labels = synthetic_cifar10(STUDY_BATCH // N_WORKERS, seed=SEED)
    return tuple(torch.from_numpy(a).to(device) for a in (images, labels))


def time_flat_rows(device, steps: int) -> dict:
    """Seconds a step of each row of ``CHIP_CONFIGS`` on one worker's batch,
    by ``bandwidth_study._timed`` after a warm-up step, with no group (no
    collective: the compute alone)."""
    from network_distributed_pytorch_tpu_torch.experiments.bandwidth_study import _timed, flat_reducer_configs
    from network_distributed_pytorch_tpu_torch.experiments.common import image_classifier_loss
    from network_distributed_pytorch_tpu_torch.experiments.powersgd_cifar10 import build_model
    from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step

    batch = _per_worker_batch(device)
    times = {}
    for name, (reducer, algorithm) in flat_reducer_configs(SEED).items():
        if name not in CHIP_CONFIGS:
            continue
        model = build_model("small", device, seed=SEED)
        step = make_train_step(
            image_classifier_loss(), reducer, model, learning_rate=0.001, momentum=0.9, algorithm=algorithm,
        )
        state = step.init_state()
        step(state, batch)  # warm-up
        times[name] = _timed(lambda: step(state, batch), steps, device)
        del model, step, state
    return times


def time_scan_rows(device, steps: int) -> dict:
    """Seconds an inner step of local SGD and DiLoCo (H = 8) on one worker's
    batch: ``max(1, steps // H)`` timed rounds after a warm-up round."""
    from network_distributed_pytorch_tpu_torch.experiments.bandwidth_study import _timed, scan_round_builders
    from network_distributed_pytorch_tpu_torch.experiments.common import image_classifier_loss
    from network_distributed_pytorch_tpu_torch.experiments.powersgd_cifar10 import build_model

    batch = _per_worker_batch(device)
    times = {}
    for name, build_round in scan_round_builders(image_classifier_loss(), group=None, seed=SEED).items():
        model = build_model("small", device, seed=SEED)
        round_ = build_round(model)
        state = round_.init_state()
        batches = [batch] * round_.sync_every
        round_(state, batches)  # warm-up
        n_rounds = max(1, steps // round_.sync_every)
        times[name] = _timed(lambda: round_(state, batches), n_rounds, device) / round_.sync_every
        del model, round_, state
    return times


def time_full_preset(device, steps: int) -> dict:
    """The flagship's step on the card in each dtype of
    ``FULL_PRESET_RUNS``: ``powersgd_cifar10.run`` at preset full, global
    batch 512, ``steps`` timed steps after a warm-up step; the mean host
    step time and each step's CUDA-event time."""
    from network_distributed_pytorch_tpu_torch.experiments import powersgd_cifar10

    rows = {}
    for name, dtype in FULL_PRESET_RUNS.items():
        cfg = powersgd_cifar10.default_config()
        cfg.global_batch_size, cfg.compute_dtype, cfg.training_epochs = FULL_PRESET_BATCH, dtype, 1
        result = powersgd_cifar10.run(cfg, preset="full", device=device, max_steps_per_epoch=steps + 1)
        host = result["step_time_s"][1:]
        rows[name] = {
            "config": "powersgd_r4", "compute_dtype": dtype, "global_batch": FULL_PRESET_BATCH,
            "chip_step_s": sum(host) / len(host), "step_time_s": host, "device_time_ms": result["device_time_ms"][1:],
            "bits_per_step": result["bits_per_step"],
        }
    return rows


def phase_chip(steps: int = 10, device="cuda", full_steps: int = 6) -> dict:
    """Time every row of ``CHIP_CONFIGS``, the avoidance rows and the
    flagship on the card, saving after each group of rows."""
    from network_distributed_pytorch_tpu_torch.parallel.mesh import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the chip phase times the card, not {device}")
    per_worker = STUDY_BATCH // N_WORKERS
    art = _load()
    chip = art["chip"] = {
        **card_provenance(device), "steps_timed": steps, "batch_per_worker": per_worker,
        "note": f"per-worker compute: batch {per_worker} on one card, one worker's share of the {N_WORKERS}-worker"
        f" global batch {STUDY_BATCH}; no collective runs (the projection adds the modelled wire)",
        "compute_step_s": {},
    }
    for timed in (time_flat_rows, time_scan_rows):
        chip["compute_step_s"].update(timed(device, steps))
        art["recorded_unix_chip"] = int(time.time())
        _save(art)
    for name, t in chip["compute_step_s"].items():
        sys.stderr.write(f"# card {name}: {t * 1e3:.3f} ms a step\n")
    chip["full_preset"] = time_full_preset(device, full_steps)
    art["recorded_unix_chip"] = int(time.time())
    _save(art)
    return chip


# ---- project -------------------------------------------------------------------


def full_preset_bits() -> dict:
    """Bits a step of exact DDP and of PowerSGD rank 4 on ResNet-152 with the
    ImageNet stem, each plus the loss's all-reduce (they do not depend on
    the world)."""
    from network_distributed_pytorch_tpu_torch.experiments.powersgd_cifar10 import build_model
    from network_distributed_pytorch_tpu_torch.parallel.reducers import ExactReducer, PowerSGDReducer
    from network_distributed_pytorch_tpu_torch.parallel.trainer import LOSS_SYNC_BITS

    params = list(build_model("full", "cpu").parameters())
    return {
        "exact": ExactReducer().bits_per_step(params, N_WORKERS) + LOSS_SYNC_BITS,
        "powersgd_r4": PowerSGDReducer(random_seed=SEED, compression_rank=4, matricize="last").bits_per_step(
            params, N_WORKERS
        ) + LOSS_SYNC_BITS,
    }


def full_preset_row(art: dict):
    """The flagship's row: the bits of exact and PowerSGD rank 4 on
    ResNet-152 and the card's own step times from the chip phase; None
    until the card has timed it. Nothing else is read."""
    chip = art.get("chip", {})
    runs = chip.get("full_preset")
    if not runs:
        return None
    bits = full_preset_bits()
    return {
        "model": "resnet152 global_batch 512 (the reference's flagship, ddp_powersgd_guide_cifar10/ddp_init.py:26-36)",
        "bits_per_step": bits,
        "exact_over_powersgd_bytes": round(bits["exact"] / bits["powersgd_r4"], 1),
        "chip_rows": {
            name: {"config": r["config"], "chip_step_s": r["chip_step_s"], "compute_dtype": r["compute_dtype"]}
            for name, r in runs.items()
        },
        "source": f"bits of the port's reducers on ResNet-152's parameters; step times of the port's"
        f" powersgd_cifar10 on {chip['nvidia_smi']}, torch {chip['torch']}",
    }


def row_bits(rec: dict, structure: dict) -> int:
    """A row's bits a step at the projected world: what the recorder saw,
    where the structure ran at that world (an avoidance row's per-step
    bits: its round's over ``sync_every``); the reducer's bits there
    (``projected_bits_per_step``) where it ran at fewer ranks."""
    if structure.get("projected_workers", structure.get("num_devices")) != N_WORKERS:
        raise ValueError(f"the structure projects {structure.get('projected_workers')} workers, not {N_WORKERS}")
    if structure["num_devices"] != N_WORKERS:
        return rec["projected_bits_per_step"]
    if rec.get("sync_every"):
        return rec["bits_per_step"]
    return rec["recorded_bits_per_step"]


def phase_project() -> dict:
    """Join structure and card times into the table a fabric, and print it."""
    from network_distributed_pytorch_tpu_torch.utils.bandwidth import bandwidth_table, format_table

    art = _load()
    structure = art.get("structure", {})
    if not structure.get("results"):
        raise SystemExit("run the structure phase first")
    chip = art.get("chip", {})
    card_times = chip.get("compute_step_s", {})
    tables, table_json = {}, {}
    for name, rec in structure["results"].items():
        bits = row_bits(rec, structure)
        n_coll = sum((rec.get("collectives") or rec["collectives_per_round"]).values())
        if rec.get("sync_every"):
            # the recorder counts each of a round's collectives where it runs
            n_coll = n_coll / rec["sync_every"]
        compute_s, source = card_times.get(name), CARD_SOURCE
        if compute_s is None:
            compute_s, source = rec["measured_step_s"], CPU_SOURCE
        table = bandwidth_table(bits, compute_s, N_WORKERS, n_coll)
        tables[name] = table
        table_json[name] = {
            "compute_s": compute_s,
            "compute_source": source,
            "bits_per_step": bits,
            "n_collectives": n_coll,
            "fabrics": {
                f: {"comm_time_s": e.comm_time_s, "step_time_s": e.step_time_s, "comm_fraction": round(e.comm_fraction, 4)}
                for f, e in table.items()
            },
        }
    art["projection"] = {
        "model": f"ring all-reduce t = 2(W-1)/W * B/beta + n_coll*latency (utils/bandwidth.py), W={N_WORKERS},"
        " comm and compute serialised (an upper bound); the NVLink4(H100) row is the data sheet's 450 GB/s a"
        " direction with no latency, not a measurement",
        "workers": N_WORKERS,
        "bits_source": "recorded" if structure["num_devices"] == N_WORKERS else f"reducers at {N_WORKERS} workers",
        "card": {k: chip.get(k) for k in ("device", "nvidia_smi", "torch")} if chip else None,
        "table": table_json,
    }
    full = full_preset_row(art)
    if full:
        art["full_preset"] = full
    else:
        art.pop("full_preset", None)
    art["recorded_unix_projection"] = int(time.time())
    art["speedup_vs_exact"] = speedup_vs_exact(table_json)
    _save(art)
    print(format_table(tables))
    print(json.dumps({"speedup_vs_exact_1GbE": {k: v.get("1GbE") for k, v in art["speedup_vs_exact"].items()}}))
    return art


def speedup_vs_exact(table_json: dict) -> dict:
    """Each row's projected speed-up over exact a fabric; a row timed on
    another source than exact's is refused, never ratioed."""
    exact = table_json.get("exact")
    speedups = {}
    for name, rec in table_json.items():
        if name == "exact" or not exact:
            continue
        if rec["compute_source"] != exact["compute_source"]:
            speedups[name] = {
                "skipped": f"compute_source {rec['compute_source']!r} != exact's {exact['compute_source']!r}"
            }
            continue
        speedups[name] = {
            f: round(exact["fabrics"][f]["step_time_s"] / rec["fabrics"][f]["step_time_s"], 2) for f in rec["fabrics"]
        }
    return speedups


def main(argv=None) -> int:
    global OUT
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", nargs="?", default="project", choices=["structure", "chip", "project"])
    ap.add_argument("--device", default="cuda", help="the chip phase's card (default %(default)s; no CPU fallback)")
    ap.add_argument("--out", default=OUT, help="the record, merged by phase (default %(default)s)")
    args = ap.parse_args(argv)
    OUT = os.path.abspath(args.out)
    if args.phase == "structure":
        phase_structure()
    elif args.phase == "chip":
        phase_chip(device=args.device)
    else:
        phase_project()
    return 0


if __name__ == "__main__":
    if os.environ.get(STRUCTURE_RANK_ENV):
        _structure_rank()
    else:
        sys.exit(main())
