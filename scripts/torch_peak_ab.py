#!/usr/bin/env python3
"""Peak memory and step time of the options that trade one for the other,
each pair in turns in one process on one card: ResNet-152 (the
``powersgd_cifar10`` preset full, batch 512, PowerSGD rank 4, the xla
pipeline) in fp32 against ``compute_dtype="bfloat16"``; GPT-2 small
(``gpt_lm`` preset full, T 1024, batch 16) and ``distilbert_base``
(``powersgd_imdb`` preset full, batch 16, max_len 256) plain against
``remat``.

Run from the root of the repository on a machine with a CUDA card::

    python3 scripts/torch_peak_ab.py [--steps 4] [--out peak_ab.json]

Every run builds its model, step and state from the seed with nothing of
an earlier run left allocated, and reads, after ``empty_cache`` and
``reset_peak_memory_stats``: the memory allocated at its start (what the
process still holds: the data), the peak of one forward and backward of
the model alone (no reducer), and the peak of ``--steps`` training steps,
each above the start; and the steps' device time (CUDA events around a
step, as ``train_loop`` takes it), p50 over the steps after the first. The
order is A, B, B, A for every pair. ``--device cpu --preset small``
rehearses it (no memory or device time there: those read None).
"""

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def emit(obj, out=None) -> None:
    line = json.dumps(obj)
    sys.stdout.write(line + "\n")
    sys.stdout.flush()
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def cases(preset):
    """``(pair, label, experiment, config fields, build keywords)``."""
    from network_distributed_pytorch_tpu_torch.experiments import gpt_lm, powersgd_cifar10, powersgd_imdb

    small = preset == "small"
    resnet = {"global_batch_size": 16} if small else {}
    gpt = {"global_batch_size": 4 if small else 16}
    return [
        ("resnet152_dtype", dtype, powersgd_cifar10, {**resnet, "compute_dtype": dtype}, {})
        for dtype in ("float32", "bfloat16", "bfloat16", "float32")
    ] + [
        ("gpt2_remat", label, gpt_lm, gpt, {"remat": label == "remat"})
        for label in ("plain", "remat", "remat", "plain")
    ] + [
        ("distilbert_remat", label, powersgd_imdb, {"global_batch_size": 16}, {"remat": label == "remat"})
        for label in ("plain", "remat", "remat", "plain")
    ]


def batches_of(experiment, cfg, model, preset, steps, dev):
    import torch

    from network_distributed_pytorch_tpu_torch.data.cifar10 import load_cifar10_or_synthetic
    from network_distributed_pytorch_tpu_torch.data.imdb import prepare_imdb
    from network_distributed_pytorch_tpu_torch.experiments import gpt_lm, powersgd_imdb
    from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches

    name = experiment.__name__.rsplit(".", 1)[-1]
    if name == "gpt_lm":
        raw = list(gpt_lm.synthetic_lm_batches(model.config.vocab_size, cfg.global_batch_size, seq_len(preset),
                                               steps, cfg.seed))
    else:
        if name == "powersgd_imdb":
            max_len = 64 if preset == "small" else 256
            split, _, _ = prepare_imdb(max_len=max_len, vocab_size=model.config.vocab_size, seed=cfg.seed)
            arrays = [split["input_ids"], split["attention_mask"], split["labels"]]
        else:
            images, labels, _ = load_cifar10_or_synthetic(train=True)
            arrays = [images, labels]
        raw = list(accumulated_batches(arrays, cfg, max_steps_per_epoch=steps)(0))
    return [tuple(torch.from_numpy(a).to(dev) for a in b) for b in raw]


def seq_len(preset):
    return 32 if preset == "small" else 1024


def loss_of(experiment):
    from network_distributed_pytorch_tpu_torch.experiments import gpt_lm, powersgd_imdb
    from network_distributed_pytorch_tpu_torch.experiments.common import image_classifier_loss

    name = experiment.__name__.rsplit(".", 1)[-1]
    return {"gpt_lm": gpt_lm.lm_loss, "powersgd_imdb": powersgd_imdb.sequence_classifier_loss}.get(
        name, image_classifier_loss
    )()


def run_case(pair, label, experiment, fields, build_kw, preset, steps, dev, group):
    import torch

    on_cuda = dev.type == "cuda"
    cfg = experiment.default_config()
    for k, v in fields.items():
        setattr(cfg, k, v)
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev) if on_cuda else None
    name = experiment.__name__.rsplit(".", 1)[-1]
    if name == "gpt_lm":
        model, step, state = experiment.build(cfg, preset, seq_len(preset), "powersgd", dev, group, **build_kw)
    else:
        model, step, state = experiment.build(cfg, preset, dev, group, **build_kw)
    batches = batches_of(experiment, cfg, model, preset, steps, dev)
    # one forward and backward of the model alone
    loss_of(experiment)(model, batches[0]).backward()
    model.zero_grad(set_to_none=True)
    fwd_bwd_peak = torch.cuda.max_memory_allocated(dev) - start if on_cuda else None
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for b in batches:
        if on_cuda:
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
        state, loss = step(state, b)
        if on_cuda:
            t1.record()
            torch.cuda.synchronize()
            ms.append(t0.elapsed_time(t1))
        if not torch.isfinite(loss):
            raise SystemExit(f"{pair} {label}: loss {loss.item()}")
    step_peak = torch.cuda.max_memory_allocated(dev) - start if on_cuda else None
    del model, step, state, batches
    return {
        "pair": pair, "run": label, "allocated_at_start_bytes": start,
        "fwd_bwd_peak_bytes": fwd_bwd_peak, "step_peak_bytes": step_peak,
        "step_device_ms": ms or None, "step_device_ms_p50": statistics.median(ms[1:]) if len(ms) > 1 else None,
    }


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--preset", choices=["full", "small"], default="full")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu --preset small to rehearse")
    from network_distributed_pytorch_tpu_torch.parallel.mesh import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )

    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    if args.device == "cuda":
        torch.zeros(1, device=dev)  # the context, before the memory counters are read
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    else:
        smi = "cpu"
    group = initialize_distributed(DistributedConfig(), dev)
    try:
        for case in cases(args.preset):
            emit({**run_case(*case, args.preset, args.steps, dev, group), "nvidia_smi": smi}, args.out)
    finally:
        shutdown_distributed()


if __name__ == "__main__":
    main()
