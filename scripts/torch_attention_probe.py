#!/usr/bin/env python3
"""Where the flash-attention kernel's (K5's) time in a DistilBERT step comes
from: the kernel timed on three kinds of input, the SM clock beside each
reading.

Run from the root of the repository on a machine with a CUDA card::

    python3 scripts/torch_attention_probe.py

At ``distilbert_base``'s width (B 16, T 256, H 12, D 64) it times one step's
six K5 launches, each by ``torch.profiler`` device time (``chip_smoke.py``'s
``device_ms``), with the inputs warm in L2 and again with 128 MB written
before every launch (L2 flushed):

- ``random_inputs``: random q, k, v with the first synthetic-IMDb batch's
  mask, the inputs of ``chip_smoke.py``'s kernel phase;
- ``path_inputs``: the q, k, v and mask that one forward of the full model
  gives K5, read by forward pre-hooks on its attention modules;
- ``path_profile``: K5's device time per step in ``torch.profiler`` over
  three training steps of ``powersgd_imdb``'s full preset through a one-rank
  NCCL group (``chip_smoke.py``'s profile phase).

The SM clock is read by ``nvidia-smi`` every 20 ms, of the card in use (by
its UUID, so the reading follows ``CUDA_VISIBLE_DEVICES``), and reported for
each timed window (the nearest reading on each side where none falls
inside). It prints one JSON line, then the card's name and power limit.
Without a CUDA device it prints no result and exits 1.
"""

import os
import statistics
import subprocess
import sys
import threading
import time
from datetime import datetime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLUSH_FLOATS = 32 * 2**20  # 128 MB, more than the H100's 50 MB L2


def fail(msg: str) -> None:
    sys.stderr.write(f"torch_attention_probe: {msg}\n")
    sys.exit(1)


class ClockLog:
    """The SM clock of the card ``card_id`` every 20 ms, by ``nvidia-smi``
    in loop mode with its own timestamps, read by a thread; ``window(name)``
    marks a span whose readings :meth:`summary` reports."""

    def __init__(self, card_id: str):
        self.samples, self.windows = [], []
        cmd = [
            "nvidia-smi", f"--id={card_id}", "--query-gpu=timestamp,clocks.sm",
            "--format=csv,noheader,nounits", "-lms", "20",
        ]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                stamp, mhz = (x.strip() for x in line.split(","))
                self.samples.append((datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f").timestamp(), int(mhz)))
            except ValueError:
                continue

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            self.proc.wait(timeout=10)
        self.reader.join(timeout=10)

    def window(self, name):
        log = self

        class _Window:
            def __enter__(self):
                self.t0 = time.time()

            def __exit__(self, *exc):
                log.windows.append((name, self.t0, time.time()))

        return _Window()

    def summary(self):
        out = {}
        for name, t0, t1 in self.windows:
            inside = [mhz for t, mhz in self.samples if t0 <= t <= t1]
            near = [mhz for t, mhz in self.samples if t < t0][-1:] + [mhz for t, mhz in self.samples if t > t1][:1]
            mhz = inside or near
            out[name] = {
                "sm_mhz_min": min(mhz) if mhz else None, "sm_mhz_max": max(mhz) if mhz else None,
                "sm_mhz_median": statistics.median(mhz) if mhz else None,
                "readings_inside": len(inside), "window_s": t1 - t0,
            }
        return out


def path_inputs(experiment, cfg, arrays, dev):
    """The (q, k, v, mask, causal, block_q, block_k, scale) of each K5
    launch of one forward of ``experiment``'s full model on its first
    batch, folded to (B*H, T, D) as ``ops.flash_attention`` folds them."""
    import torch

    from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches
    from network_distributed_pytorch_tpu_torch.models.distilbert import MultiHeadSelfAttention

    model, _, _ = experiment.build(cfg, "full", dev, group=None)
    batch = tuple(torch.from_numpy(a).to(dev) for a in next(accumulated_batches(arrays, cfg, 1)(0)))
    captured = []

    def capture(module, args):
        x, mask = args[0], args[1]
        b, t, _ = x.shape
        h = module.config.n_heads
        d = module.config.dim // h

        def fold(lin):
            return lin(x).reshape(b, t, h, d).permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()

        block = min(128, t)
        q, k, v = fold(module.q_lin), fold(module.k_lin), fold(module.v_lin)
        captured.append((q, k, v, mask.float(), False, block, block, 1.0 / float(d) ** 0.5))

    hooks = [m.register_forward_pre_hook(capture) for m in model.modules() if isinstance(m, MultiHeadSelfAttention)]
    try:
        with torch.no_grad():
            experiment.sequence_classifier_loss()(model, batch)
    finally:
        for hook in hooks:
            hook.remove()
    del model
    return captured


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this probe needs a CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from network_distributed_pytorch_tpu_torch.data.imdb import prepare_imdb
    from network_distributed_pytorch_tpu_torch.experiments import powersgd_imdb
    from network_distributed_pytorch_tpu_torch.experiments.common import accumulated_batches
    from network_distributed_pytorch_tpu_torch.ops import _build
    from network_distributed_pytorch_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build_all()
    dev = torch.device("cuda", 0)
    uuid = str(torch.cuda.get_device_properties(dev).uuid)
    card_id = uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"

    cfg = powersgd_imdb.default_config()
    cfg.global_batch_size = smoke.IMDB_B
    imdb, _, _ = prepare_imdb(max_len=smoke.IMDB_T, seed=cfg.seed)
    arrays = [imdb["input_ids"], imdb["attention_mask"], imdb["labels"]]
    amask = torch.from_numpy(next(accumulated_batches(arrays, cfg)(0))[1])
    mask = torch.where(amask > 0, 0.0, torch.finfo(torch.float32).min).to(dev)
    gen = torch.Generator().manual_seed(0)
    shape = (smoke.IMDB_B * smoke.IMDB_H, smoke.IMDB_T, smoke.IMDB_D)
    q, k, v = (torch.randn(shape, generator=gen).to(dev) for _ in range(3))
    flush = torch.empty(FLUSH_FLOATS, device=dev)

    clocks = ClockLog(card_id)
    try:
        def timed(name, launches):
            with clocks.window(name):
                warm = smoke.device_ms(lambda: [fa.flash_attention_fwd(*a) for a in launches], "flash_fwd_kernel")
            with clocks.window(f"{name}_l2_flushed"):
                cold = smoke.device_ms(
                    lambda: [(flush.zero_(), fa.flash_attention_fwd(*a)) for a in launches], "flash_fwd_kernel"
                )
            return {"launches": len(launches), "device_ms": warm, "device_ms_l2_flushed": cold}

        scale = smoke.IMDB_D**-0.5
        random = timed("random_inputs", [(q, k, v, mask, False, 128, 128, scale)] * smoke.IMDB_LAYERS)
        captured = path_inputs(powersgd_imdb, cfg, arrays, dev)
        if len(captured) != smoke.IMDB_LAYERS:
            fail(f"a DistilBERT forward ran {len(captured)} attention layers, expected {smoke.IMDB_LAYERS}")
        on_path = timed("path_inputs", captured)
        del captured
        with clocks.window("path_profile"):
            profile = smoke.profile_main_path(dev, powersgd_imdb, cfg, arrays, {"flash_attention": "flash_fwd_kernel"})
    finally:
        clocks.stop()
    smoke.emit({
        "probe": "flash_attention", "shape": [smoke.IMDB_B, smoke.IMDB_T, smoke.IMDB_H, smoke.IMDB_D],
        "random_inputs": random, "path_inputs": on_path,
        "path_profile": {
            "device_ms_per_step": profile["kernels"]["flash_attention"]["device_ms_per_step"],
            "launches_per_step": profile["kernels"]["flash_attention"]["launches_per_step"],
            "device_busy_ms_per_step": profile["device_busy_ms_per_step"],
        },
        "sm_clocks": {"card": card_id, "readings": len(clocks.samples), "windows": clocks.summary()},
    })
    sys.stdout.write(smi + "\n")


if __name__ == "__main__":
    main()
