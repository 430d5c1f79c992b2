"""The bandwidth study, the experiment the reference was built for (its
README promises in-node and 1, 10 and 100 GbE numbers and reports none):
the JAX package's ``experiments/bandwidth_study.py``.

For each configuration of the study, exact DDP, PowerSGD at each rank of
``reducer_ranks``, TopK 1 %, SignSGD and QSGD int8 (gradient compression),
local SGD and DiLoCo with PowerSGD rank 4 on the outer delta at H = 8
(communication avoidance) and, at four or more ranks in an even number,
PowerSGD across two groups of exact in-group means (``hier_powersgd_r4``),
it times the step (a round's time over H for the avoidance rows) with CUDA
events, records the step's collectives and their bytes
(:func:`..parallel.comm.record_collectives`, in place of the JAX package's
HLO audit), and projects the step's time over each fabric of
:mod:`..utils.bandwidth` with the ring model. Preset ``full`` is
ResNet-152 with the ImageNet stem, ``small`` ResNet-18 with the CIFAR stem
at width 16, on one synthetic CIFAR-10 batch of ``global_batch`` images.

``project_workers`` sets the world of the projection: by default the run's
own, as in the JAX package; a one-card run can project, say, eight workers,
with each configuration's bits at that world (a gather's grow with it).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..data.cifar10 import synthetic_cifar10
from ..observe.events import NoteEvent
from ..observe.telemetry import telemetry_from_config
from ..parallel.comm import record_collectives, recorded_bits
from ..parallel.compression import QSGDReducer, SignSGDReducer, TopKReducer
from ..parallel.hierarchical import HierarchicalReducer, make_hierarchical_groups
from ..parallel.localsgd import make_diloco_train_fn, make_local_sgd_train_fn
from ..parallel.mesh import resolve_device
from ..parallel.reducers import ExactReducer, PowerSGDReducer
from ..parallel.trainer import LOSS_SYNC_BITS, make_train_step
from ..utils.bandwidth import bandwidth_table, format_table
from ..utils.config import ExperimentConfig
from .common import image_classifier_loss, local_shard, process_group, require_float32
from .powersgd_cifar10 import build_model


SCAN_SYNC_EVERY = 8  # inner steps a round of the avoidance rows
HIER_NAME = "hier_powersgd_r4"


def default_config() -> ExperimentConfig:
    return ExperimentConfig()


def flat_reducer_configs(seed: int, reducer_ranks=(1, 2, 4)) -> Dict:
    """The study's per-step configurations: ``name -> (reducer, algorithm)``."""
    configs = {"exact": (ExactReducer(), "sgd")}
    for r in reducer_ranks:
        configs[f"powersgd_r{r}"] = (
            PowerSGDReducer(random_seed=seed, compression_rank=r, matricize="last"), "ef_momentum"
        )
    configs["topk_1pct"] = (TopKReducer(k_fraction=0.01), "ef_momentum")
    configs["signsgd"] = (SignSGDReducer(), "ef_momentum")
    configs["qsgd_int8"] = (QSGDReducer(random_seed=seed), "ef_momentum")
    return configs


def scan_round_builders(
    loss_fn, *, group, seed: int, learning_rate: float = 0.001, momentum: float = 0.9,
    sync_every: int = SCAN_SYNC_EVERY,
) -> Dict[str, Callable]:
    """``name -> (model -> round)`` for the communication-avoidance rows:
    local SGD, and DiLoCo with PowerSGD rank 4 on the outer delta."""
    return {
        f"local_sgd_h{sync_every}": lambda model: make_local_sgd_train_fn(
            loss_fn, model, learning_rate, momentum, sync_every=sync_every, group=group,
        ),
        f"diloco_psgd_r4_h{sync_every}": lambda model: make_diloco_train_fn(
            loss_fn, model, inner_learning_rate=learning_rate, sync_every=sync_every, group=group,
            reducer=PowerSGDReducer(random_seed=seed, compression_rank=4, matricize="last"),
        ),
    }


def _timed(fn, calls: int, device) -> float:
    """Seconds a call of ``fn()``, over ``calls`` back-to-back calls: CUDA
    events on the card, the host clock (after the last result) on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls


def _by_kind(records) -> Dict[str, int]:
    kinds: Dict[str, int] = {}
    for r in records:
        kinds[r.kind] = kinds.get(r.kind, 0) + 1
    return kinds


def run(
    config: Optional[ExperimentConfig] = None,
    preset: str = "small",
    device="cuda",
    global_batch: int = 256,
    reducer_ranks=(1, 2, 4),
    timed_steps: int = 3,
    timed_rounds: int = 2,
    project_workers: Optional[int] = None,
) -> Dict:
    """The study's table: per configuration its bits per step (analytic and
    as recorded), collectives, measured step time and projected step time
    on each fabric. Each step configuration runs one warm-up step, one
    recorded step and ``timed_steps`` timed steps; each avoidance row one
    warm-up round, one recorded round and ``timed_rounds`` timed rounds
    (``steps_run`` and ``rounds_run`` in the result)."""
    config = config or default_config()
    require_float32(config, "bandwidth_study")
    device = resolve_device(device)
    with process_group(config, device) as group:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        workers = project_workers or world
        images, labels = synthetic_cifar10(global_batch, seed=config.seed)
        batch = tuple(torch.from_numpy(a).to(device) for a in local_shard((images, labels), rank, world))
        loss_fn = image_classifier_loss()
        configs = flat_reducer_configs(config.seed, reducer_ranks)
        hier = None
        if world >= 4 and world % 2 == 0:
            inner, outer, inner_world, outer_world = make_hierarchical_groups(2, group)
            hier = HierarchicalReducer(
                PowerSGDReducer(random_seed=config.seed, compression_rank=4, matricize="last"),
                inner, outer, inner_world, outer_world,
            )
            configs[HIER_NAME] = (hier, "ef_momentum")
        tables, results = {}, {}

        def fresh_model():
            return build_model(preset, device, seed=config.seed)

        for name, build_round in scan_round_builders(
            loss_fn, group=group, seed=config.seed, learning_rate=config.learning_rate, momentum=config.momentum,
        ).items():
            model = fresh_model()
            round_ = build_round(model)
            state = round_.init_state()
            batches = [batch] * round_.sync_every
            round_(state, batches)  # warm-up
            with record_collectives() as records:
                _, losses = round_(state, batches)
            step_s = _timed(lambda: round_(state, batches), timed_rounds, device) / round_.sync_every
            params = list(model.parameters())
            projected_bits = (
                round_.reducer.bits_per_step(params, workers) + round_.sync_every * LOSS_SYNC_BITS
            ) / round_.sync_every
            table = bandwidth_table(projected_bits, step_s, workers, n_collectives=len(records) / round_.sync_every)
            tables[name] = table
            results[name] = {
                "bits_per_step": round_.bits_per_step,
                "bits_per_round": round_.bits_per_round,
                "recorded_bits_per_round": recorded_bits(records),
                "collectives_per_round": _by_kind(records),
                "sync_every": round_.sync_every,
                "rounds_run": 2 + timed_rounds,
                "mbytes_per_step": round_.bits_per_step / 8e6,
                "measured_step_s": step_s,
                "final_loss": float(losses[-1]),
                "projected_bits_per_step": projected_bits,
                "projected_step_s": {f: e.step_time_s for f, e in table.items()},
            }
            del model, round_, state

        for name, (reducer, algorithm) in configs.items():
            model = fresh_model()
            step = make_train_step(
                loss_fn, reducer, model, learning_rate=config.learning_rate, momentum=config.momentum,
                algorithm=algorithm, group=group,
            )
            state = step.init_state()
            step(state, batch)  # warm-up
            with record_collectives() as records:
                _, loss = step(state, batch)
            step_s = _timed(lambda: step(state, batch), timed_steps, device)
            params = list(model.parameters())
            fabric_bits = reducer.bits_per_step(params, workers) + LOSS_SYNC_BITS
            fabric_workers, n_coll, extra = workers, len(records), {}
            if reducer is hier:
                # only the collectives whose group spans two inner groups
                # ride the slow fabric: the outer reducer's and the loss's
                slow = [r for r in records if len({g // hier.inner_world for g in r.ranks}) > 1]
                fabric_bits, fabric_workers, n_coll = recorded_bits(slow), hier.outer_world, len(slow)
                extra = {
                    "bits_slow_fabric": fabric_bits,
                    "bits_fast_fabric": recorded_bits(records) - fabric_bits,
                    "slow_collectives": len(slow),
                    "bits_by_fabric": hier.bits_by_fabric(params),
                }
            table = bandwidth_table(fabric_bits, step_s, fabric_workers, n_coll)
            tables[name] = table
            results[name] = {
                "bits_per_step": step.bits_per_step,
                "recorded_bits_per_step": recorded_bits(records),
                "collectives": _by_kind(records),
                "steps_run": 2 + timed_steps,
                "mbytes_per_step": step.bits_per_step / 8e6,
                "measured_step_s": step_s,
                "final_loss": float(loss),
                "projected_bits_per_step": fabric_bits,
                "projected_step_s": {f: e.step_time_s for f, e in table.items()},
                **extra,
            }
            del model, step, state

        text = format_table(tables)
        telemetry = telemetry_from_config(config)
        try:
            telemetry.emit(NoteEvent(
                f"\nBandwidth study: {world} workers (projected: {workers}), global batch {global_batch}"
            ))
            telemetry.emit(NoteEvent(text))
        finally:
            telemetry.close()
        exact_bits = results["exact"]["bits_per_step"]
        for name, r in results.items():
            if name != "exact":
                r["compression_ratio"] = exact_bits / r["bits_per_step"]
        return {
            "experiment": "bandwidth_study", "preset": preset, "num_devices": world,
            "projected_workers": workers, "global_batch": global_batch,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "results": results, "table": text,
        }
