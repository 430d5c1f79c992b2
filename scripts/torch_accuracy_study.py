"""PowerSGD against exact all-reduce, trained to an accuracy plateau, on the
port: the JAX package's ``scripts/accuracy_study.py``.

The reference's claim is that rank-r PowerSGD with error feedback trains to
the accuracy of exact all-reduce at a fraction of the gradient bytes. Each
task trains the same model from the same initial state on the same
synthetic draw under both arms until the held-out accuracy stops improving,
and records both curves, the accuracy delta and the bytes on the wire.

The tasks are capped so that neither arm can saturate: symmetric label
noise on the train and the held-out split bounds what any learner can
reach. CIFAR: class blobs (``class_sep`` 0.5) with 15 % of labels resampled,
its ceiling the Bayes (true-means nearest-mean) rule scored on the noised
held-out labels. IMDb: 12 % of labels flipped, its ceiling one minus the
flip fraction realized on this draw's validation split. Tiers: ResNet-18 at
width 16 (``cifar``), ``distilbert_tiny`` (``imdb``, whose rank 16 meets
half its width, so its byte ratio is small by construction) and
``distilbert_wide`` (``imdb_wide``, dim 256, where rank 16 is a real
compression).

The world. One process runs at world 1 on the whole global batch. Under
``torchrun`` (``RANK``, ``WORLD_SIZE``) it runs as that many ranks, each on
its slice of the batch; ``workers`` records the world that ran. Bits are
recorded at the JAX study's 8 workers (the reducer's bits at 8 workers plus
the loss's 32), as ``experiments/bandwidth_study.py`` projects them. One
departure from the JAX study's 8-worker run: at world 1 the ResNet's
BatchNorm takes its statistics over all 256 images of a step, where each of
8 workers took them over its 32. PowerSGD with error feedback is linear in
the mean gradient, so apart from BatchNorm world 1 on the global batch is
the same algorithm in exact arithmetic.

Each task record carries the card's name and power limit (``nvidia-smi``),
torch's version and each arm's wall seconds. The record merges into
``--out`` (default ``artifacts/TORCH_ACCURACY_STUDY.json``) after every
seed; stdout gets one slim JSON line, progress goes to stderr.

Usage:
    python3 scripts/torch_accuracy_study.py [--task cifar|imdb|imdb_wide|both|all]
        [--max-epochs 30] [--patience 5] [--seeds 1] [--device cuda|cpu] [--out PATH]

``--device cuda`` (the default) raises where there is no card; ``cpu`` runs
the plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

OUT = os.path.join(REPO, "artifacts", "TORCH_ACCURACY_STUDY.json")

# the JAX study's world: bits_per_step is recorded at it
JAX_WORKERS = 8
# CIFAR: the generator's default separability, capped by 15 % resampled
# labels (9 in 10 resamples land off-class: a 13.5 % flip, ceiling ~0.865)
CIFAR_CLASS_SEP = 0.5
CIFAR_LABEL_NOISE = 0.15
IMDB_LABEL_NOISE = 0.12
IMDB_CLASS_WORD_RATE = 0.25
# one CIFAR draw, split train / held out: the same class means, disjoint noise
CIFAR_N, CIFAR_TRAIN_FRACTION = 5120, 0.8
CIFAR_BATCH, CIFAR_LR = 256, 0.02
IMDB_N, IMDB_VOCAB, IMDB_SEED = 2048, 1024, 714
IMDB_BATCH = 128
MOMENTUM = 0.9
REDUCER_SEED = 714
BN_WORLD_DEPARTURE = (
    "at world 1 the ResNet's BatchNorm takes its statistics over the whole global batch of 256, where the JAX"
    " study's 8 workers took them over 32 each; PowerSGD with error feedback is linear in the mean gradient,"
    " so apart from BatchNorm world 1 is the same algorithm in exact arithmetic"
)


def run_to_plateau(
    arm_name,
    step,
    state,
    epoch_batches,
    evaluate,
    max_epochs: int,
    patience: int,
    min_delta: float = 0.0025,
    *,
    device="cpu",
    rank: int = 0,
    world: int = 1,
    bits_per_step=None,
):
    """Train epoch by epoch until the held-out accuracy has not risen by more
    than ``min_delta`` for ``patience`` epochs, through the port's
    ``experiments.common.train_loop``. The best accuracy is tracked
    unconditionally; the patience mark moves only on a jump of more than
    ``min_delta``; ``plateaued`` says whether the loop broke on patience.
    ``bits_per_step`` (default ``step.bits_per_step``) prices the wire."""
    from network_distributed_pytorch_tpu_torch.experiments import common

    bits = step.bits_per_step if bits_per_step is None else bits_per_step
    curve = []
    best, mark, mark_epoch, total_steps = 0.0, 0.0, -1, 0
    plateaued = False
    t0 = time.perf_counter()
    for epoch in range(max_epochs):
        state, logger = common.train_loop(
            step, state, lambda _e: epoch_batches(epoch), 1, device, rank=rank, world_size=world, log_every=0,
        )
        total_steps += logger.summary()["steps"]
        acc = evaluate(step, state)
        curve.append(round(acc, 4))
        best = max(best, acc)
        if acc > mark + min_delta:
            mark, mark_epoch = acc, epoch
        _say(f"# {arm_name} epoch {epoch}: eval_acc {acc:.4f} (best {best:.4f}, last improvement @ {mark_epoch})")
        if epoch - mark_epoch >= patience:
            plateaued = True
            break
    return {
        "eval_accuracy_curve": curve,
        "final_accuracy": curve[-1],
        "best_accuracy": round(best, 4),
        "epochs_run": len(curve),
        "plateaued": plateaued,
        "bits_per_step": bits,
        "bytes_per_step": bits // 8,
        "total_steps": total_steps,
        "total_mb_on_wire": round(bits * total_steps / 8e6, 2),
        "wall_s": round(time.perf_counter() - t0, 1),
    }


def _say(line: str) -> None:
    if int(os.environ.get("RANK", "0")) == 0:
        sys.stderr.write(line + "\n")
        sys.stderr.flush()


def _nearest_mean_accuracy(x, y, true_means) -> float:
    """Accuracy of the Bayes rule for the class-blob generator (equal
    isotropic covariance: nearest class mean), scored with the generator's
    own means, never means fitted on the scored points."""
    import numpy as np

    flat = x.reshape(len(x), -1).astype(np.float64)
    means = true_means.reshape(len(true_means), -1).astype(np.float64)
    logits = flat @ means.T - 0.5 * (means**2).sum(1)
    return float((logits.argmax(1) == y).mean())


# ---- the tasks --------------------------------------------------------------


def cifar_task(data_seed: int = 0) -> dict:
    """One draw of ``CIFAR_N`` class-blob images, 80 % to train and the rest
    held out, and the Bayes ceiling on the held-out split."""
    from network_distributed_pytorch_tpu_torch.data.cifar10 import synthetic_cifar10

    images, labels, true_means = synthetic_cifar10(
        CIFAR_N, seed=data_seed, class_sep=CIFAR_CLASS_SEP, label_noise=CIFAR_LABEL_NOISE, return_means=True,
    )
    n_train = int(CIFAR_N * CIFAR_TRAIN_FRACTION)
    test_x, test_y = images[n_train:], labels[n_train:]
    return {
        "train_x": images[:n_train], "train_y": labels[:n_train], "test_x": test_x, "test_y": test_y,
        "ceiling": _nearest_mean_accuracy(test_x, test_y, true_means),
    }


def imdb_task(data_seed: int = 0, wide: bool = False) -> dict:
    """The synthetic reviews at vocabulary 1,024 and ``max_len`` 64 (32 on
    the wide tier), and the flip fraction realized on the validation split:
    the flips are drawn after the text, so the same draw with
    ``label_noise=0`` is its clean twin."""
    from network_distributed_pytorch_tpu_torch.data.imdb import prepare_imdb

    max_len = 32 if wide else 64

    def draw(label_noise):
        return prepare_imdb(
            max_len=max_len, synthetic_n=IMDB_N, vocab_size=IMDB_VOCAB, seed=IMDB_SEED + data_seed,
            synthetic_kwargs=dict(class_word_rate=IMDB_CLASS_WORD_RATE, label_noise=label_noise),
        )

    train, val, _ = draw(IMDB_LABEL_NOISE)
    _, clean_val, _ = draw(0.0)
    return {
        "train": train, "val": val, "max_len": max_len,
        "realized_flip": float((val["labels"] != clean_val["labels"]).mean()),
    }


# ---- the arms ---------------------------------------------------------------

CIFAR_ARMS = {"exact": (None, "sgd"), "powersgd_r4": (4, "ef_momentum")}
IMDB_ARMS = {"exact": (None, "sgd"), "powersgd_r16": (16, "ef_momentum")}


def _reducer(rank, model):
    from network_distributed_pytorch_tpu_torch.parallel.reducers import (
        ExactReducer,
        PowerSGDReducer,
        embedding_leaves,
    )

    if rank is None:
        return ExactReducer()
    # flax's matrices: output features last, embedding tables as stored
    return PowerSGDReducer(
        random_seed=REDUCER_SEED, compression_rank=rank, matricize="last", features_last=embedding_leaves(model)
    )


def build_cifar_arm(arm: str, device, group, state_dict=None):
    """``(model, step, state)`` of a CIFAR arm: ResNet-18 at width 16 with
    the CIFAR stem and BatchNorm, from the seed or from ``state_dict``."""
    from network_distributed_pytorch_tpu_torch.experiments.common import image_classifier_loss
    from network_distributed_pytorch_tpu_torch.models.resnet import resnet18
    from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step

    rank, algorithm = CIFAR_ARMS[arm]
    model = resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device=device, seed=0)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    step = make_train_step(
        image_classifier_loss(), _reducer(rank, model), model, learning_rate=CIFAR_LR, momentum=MOMENTUM,
        algorithm=algorithm, group=group,
    )
    return model, step, step.init_state()


def imdb_lr(wide: bool) -> float:
    return 0.002 if wide else 0.005


def flax_default_init_(model, seed: int = 0) -> None:
    """Redraw a DistilBERT's weights as the JAX study's flax model starts:
    each ``Linear`` weight from flax's ``lecun_normal`` (a normal truncated
    at 2 standard deviations, of variance 1 / fan_in), each ``Embedding``
    table normal with variance 1 / dim, biases 0, LayerNorm 1 and 0. The
    port's models draw HuggingFace's normal of std 0.02 instead, under which
    the study's lr (0.005, 0.002) leaves both arms at chance."""
    import math

    import torch
    from torch import nn

    from network_distributed_pytorch_tpu_torch.models.resnet import _lecun_normal_

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                w = torch.empty(mod.weight.shape)  # drawn on the CPU, from the seed's generator
                _lecun_normal_(w, mod.in_features, gen)
                mod.weight.copy_(w)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) / math.sqrt(mod.embedding_dim))
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


def build_imdb_arm(arm: str, wide: bool, device, group, state_dict=None):
    """``(model, step, state)`` of an IMDb arm: ``distilbert_tiny`` or
    ``distilbert_wide`` with flash attention where the device has it, from
    ``state_dict`` or else from flax's default initializers
    (:func:`flax_default_init_`), as the JAX study's model starts."""
    from network_distributed_pytorch_tpu_torch.experiments.powersgd_imdb import sequence_classifier_loss
    from network_distributed_pytorch_tpu_torch.models.distilbert import distilbert_tiny, distilbert_wide
    from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step

    rank, algorithm = IMDB_ARMS[arm]
    model = (distilbert_wide if wide else distilbert_tiny)(num_labels=2, device=device, seed=0)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        flax_default_init_(model)
    step = make_train_step(
        sequence_classifier_loss(), _reducer(rank, model), model, learning_rate=imdb_lr(wide), momentum=MOMENTUM,
        algorithm=algorithm, group=group,
    )
    return model, step, step.init_state()


def arm_bits(step, model) -> int:
    """The arm's bits a step at the JAX study's 8 workers: the reducer's bits
    there plus the loss's all-reduce."""
    from network_distributed_pytorch_tpu_torch.parallel.trainer import LOSS_SYNC_BITS

    return step.reducer.bits_per_step(list(model.parameters()), JAX_WORKERS) + LOSS_SYNC_BITS


def _kernels():
    from network_distributed_pytorch_tpu_torch.ops import flash_attention as fa
    from network_distributed_pytorch_tpu_torch.ops import gram_schmidt as gs

    return (gs.KERNEL, fa.KERNEL, *fa.BWD_KERNELS.values())


def _run_arm(name, build, epoch_batches, evaluate, max_epochs, patience, device, group):
    """Build an arm, train it to its plateau and add the port's kernel
    launches it made (0 on the CPU, where the plain versions run)."""
    import torch.distributed as dist

    model, step, state = build()
    before = {k.name: k.launches for k in _kernels()}
    rec = run_to_plateau(
        name, step, state, epoch_batches, lambda s, st: evaluate(model), max_epochs, patience,
        device=device, rank=dist.get_rank(group), world=dist.get_world_size(group), bits_per_step=arm_bits(step, model),
    )
    rec["kernel_launches"] = {k.name: k.launches - before[k.name] for k in _kernels()}
    return rec


def _task_record(arms, compressed: str) -> dict:
    exact, psgd = arms["exact"], arms[compressed]
    return {
        "accuracy_delta_pts": round(100 * (exact["best_accuracy"] - psgd["best_accuracy"]), 2),
        "gradient_bytes_ratio": round(exact["bytes_per_step"] / psgd["bytes_per_step"], 1),
    }


def cifar_study(max_epochs: int, patience: int, data_seed: int = 0, *, device, group) -> dict:
    """ResNet-18 w16 on the capped CIFAR task: exact SGD against PowerSGD
    rank 4 with error-feedback momentum, the same data, initial state, lr
    and schedule; held-out accuracy from BatchNorm's running statistics."""
    import torch.distributed as dist

    from network_distributed_pytorch_tpu_torch.data.loader import iterate_batches
    from network_distributed_pytorch_tpu_torch.experiments.common import (
        average_model_state,
        evaluate_image_classifier,
    )

    task = cifar_task(data_seed)

    def epoch_batches(epoch):
        return iterate_batches([task["train_x"], task["train_y"]], CIFAR_BATCH, shuffle=True, seed=1234 + epoch)

    def evaluate(model):
        average_model_state(model, group)  # the ranks' mean statistics (nothing at world 1)
        return evaluate_image_classifier(model, task["test_x"], task["test_y"])

    arms = {
        arm: _run_arm(
            f"cifar/{arm}", functools.partial(build_cifar_arm, arm, device, group), epoch_batches, evaluate,
            max_epochs, patience, device, group,
        )
        for arm in CIFAR_ARMS
    }
    return {
        "task": "cifar10_synthetic_label_noise",
        "model": "resnet18_w16",
        "workers": dist.get_world_size(group),
        "global_batch": CIFAR_BATCH,
        "lr": CIFAR_LR,
        "hardness": {
            "class_sep": CIFAR_CLASS_SEP,
            "label_noise": CIFAR_LABEL_NOISE,
            "accuracy_ceiling_nearest_mean": round(task["ceiling"], 4),
        },
        "arms": arms,
        **_task_record(arms, "powersgd_r4"),
        "bits_workers": JAX_WORKERS,
        "departure": BN_WORLD_DEPARTURE if dist.get_world_size(group) != JAX_WORKERS else None,
    }


def imdb_study(max_epochs: int, patience: int, data_seed: int = 0, wide: bool = False, *, device, group) -> dict:
    """DistilBERT on the capped synthetic reviews: exact against PowerSGD
    rank 16 (the reference's IMDb rank), tiny (dim 32) or wide (dim 256,
    depth 1, lr 0.002)."""
    import torch.distributed as dist

    from network_distributed_pytorch_tpu_torch.data.loader import iterate_batches
    from network_distributed_pytorch_tpu_torch.experiments.common import evaluate_text_classifier

    task = imdb_task(data_seed, wide)
    train = task["train"]

    def epoch_batches(epoch):
        return iterate_batches(
            [train["input_ids"], train["attention_mask"], train["labels"]], IMDB_BATCH, shuffle=True,
            seed=1234 + epoch,
        )

    arms = {
        arm: _run_arm(
            f"imdb/{arm}", functools.partial(build_imdb_arm, arm, wide, device, group), epoch_batches,
            lambda model: evaluate_text_classifier(model, task["val"]), max_epochs, patience, device, group,
        )
        for arm in IMDB_ARMS
    }
    return {
        "task": "imdb_synthetic_label_noise" + ("_wide" if wide else ""),
        "model": "distilbert_wide_d256" if wide else "distilbert_tiny",
        "max_len": task["max_len"],
        "workers": dist.get_world_size(group),
        "global_batch": IMDB_BATCH,
        "lr": imdb_lr(wide),
        "init": "flax's default initializers (flax_default_init_)",
        "hardness": {
            "label_noise": IMDB_LABEL_NOISE,
            "class_word_rate": IMDB_CLASS_WORD_RATE,
            "accuracy_ceiling": round(1.0 - IMDB_LABEL_NOISE, 4),
            "accuracy_ceiling_realized": round(1.0 - task["realized_flip"], 4),
        },
        "arms": arms,
        **_task_record(arms, "powersgd_r16"),
        "bits_workers": JAX_WORKERS,
    }


# ---- seeds, the record and the command line ---------------------------------


def _slim(rec: dict, seed: int) -> dict:
    """The summary row of a seed after the first (seed 0 keeps the whole
    record at the task's top level)."""
    return {
        "seed": seed,
        "accuracy_delta_pts": rec["accuracy_delta_pts"],
        "exact_best": rec["arms"]["exact"]["best_accuracy"],
        "compressed_best": min(a["best_accuracy"] for k, a in rec["arms"].items() if k != "exact"),
        "hardness": rec["hardness"],
    }


def _multi_seed(study_fn, max_epochs: int, patience: int, seeds: int, save) -> dict:
    """Seed 0's whole record, then a slim row and the spread of the delta
    over ``seeds`` independent draws; ``save(rec)`` after every seed."""
    rec = study_fn(max_epochs, patience)
    save(rec)
    if seeds > 1:
        runs = [_slim(rec, 0)]
        for s in range(1, seeds):
            runs.append(_slim(study_fn(max_epochs, patience, data_seed=s), s))
            rec["seed_runs"] = list(runs)
            deltas = [r["accuracy_delta_pts"] for r in runs]
            rec["accuracy_delta_pts_per_seed"] = deltas
            rec["accuracy_delta_pts_worst"] = max(deltas)
            save(rec)
    return rec


def _save(out: dict) -> None:
    """Merge ``out``'s task records into ``OUT`` (a task's record is replaced
    only by a new run of that task), atomically: a temporary file and
    ``os.replace``. A file that does not parse is moved to ``OUT.corrupt``
    and the merge starts from nothing."""
    os.makedirs(os.path.dirname(os.path.abspath(OUT)), exist_ok=True)
    try:
        with open(OUT) as f:
            merged = json.load(f)
    except FileNotFoundError:
        merged = {}
    except json.JSONDecodeError:
        os.replace(OUT, OUT + ".corrupt")
        merged = {}
    merged.pop("device", None)
    merged.pop("n_devices", None)
    merged.update(out)
    tmp = OUT + ".tmp"
    with open(tmp, "w") as f:
        json.dump(merged, f, indent=1)
    os.replace(tmp, OUT)


def card_provenance(device) -> dict:
    """The device's name, with the card's name and power limit as
    ``nvidia-smi`` gives them, and torch's version."""
    import torch

    out = {"device": "cpu", "nvidia_smi": None, "torch": torch.__version__}
    if device.type == "cuda":
        out["device"] = torch.cuda.get_device_name(device)
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()
        out["nvidia_smi"] = lines[device.index or 0]
    return out


def _line(rec: dict) -> dict:
    row = {
        "accuracy_delta_pts": rec["accuracy_delta_pts"],
        "gradient_bytes_ratio": rec["gradient_bytes_ratio"],
        "exact_best": rec["arms"]["exact"]["best_accuracy"],
        "compressed_best": min(a["best_accuracy"] for k, a in rec["arms"].items() if k != "exact"),
    }
    if "accuracy_delta_pts_worst" in rec:
        row["accuracy_delta_pts_worst"] = rec["accuracy_delta_pts_worst"]
        row["seeds"] = len(rec["seed_runs"])
    return row


def main(argv=None) -> int:
    global OUT
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="both", choices=["cifar", "imdb", "imdb_wide", "both", "all"])
    ap.add_argument("--max-epochs", type=int, default=30)
    ap.add_argument("--patience", type=int, default=5)
    ap.add_argument("--seeds", type=int, default=1, help="independent data draws a task (seed 0 keeps the whole record)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help="cuda raises where there is no card")
    ap.add_argument("--out", default=OUT, help="the record, merged by task (default %(default)s)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from network_distributed_pytorch_tpu_torch.experiments.common import process_group
    from network_distributed_pytorch_tpu_torch.launch import env_rank_and_world, worker_cuda_device
    from network_distributed_pytorch_tpu_torch.parallel.mesh import resolve_device
    from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig

    OUT = os.path.abspath(args.out)
    rank, world = env_rank_and_world()
    device = resolve_device(worker_cuda_device(rank, world) if args.device == "cuda" and world > 1 else args.device)
    config = ExperimentConfig(
        process_id=rank, num_processes=world, coordinator_address="env://" if world > 1 else None,
    )
    if device.type == "cuda":
        from network_distributed_pytorch_tpu_torch.ops import _build

        _build.build_all()  # before the first arm, so that no arm's wall holds an nvcc
    out: dict = {}
    with process_group(config, device) as group:
        provenance = {**card_provenance(device), "n_devices": dist.get_world_size(group)}

        def saver(task):
            def save(rec):
                rec.update(provenance)
                out[task] = rec
                if dist.get_rank(group) == 0:
                    _save(out)

            return save

        kw = dict(device=device, group=group)
        studies = (
            ("cifar", ("cifar", "both", "all"), functools.partial(cifar_study, **kw)),
            ("imdb", ("imdb", "both", "all"), functools.partial(imdb_study, **kw)),
            ("imdb_wide", ("imdb_wide", "all"), functools.partial(imdb_study, wide=True, **kw)),
        )
        for task, chosen_by, study in studies:
            if args.task in chosen_by:
                _multi_seed(study, args.max_epochs, args.patience, args.seeds, saver(task))
    if rank == 0:
        print(json.dumps({task: _line(rec) for task, rec in out.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
