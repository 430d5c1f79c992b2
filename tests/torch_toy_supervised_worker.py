"""A toy worker for the supervisor's tests (run as a subprocess), the
port's counterpart of ``toy_supervised_worker.py``: it imports neither
torch nor jax, so a restart costs milliseconds.

Each step adds ``world`` to an accumulator (the toy stand-in for the global
batch's contribution, so a degraded restart visibly changes the
accounting), saves it atomically, beats a heartbeat file and obeys the
port's ``resilience.chaos.ChaosPlan`` for the process faults (exit,
SIGKILL, hang, self-SIGTERM) and the correlated ones (``zone_outage``,
``host_flap``). On completion it writes a result JSON per rank. A state
path that stays unwritable exits ``CKPT_UNWRITABLE_EXIT_CODE``. With
``--graceful-term`` a SIGTERM saves the state and exits
``PREEMPT_EXIT_CODE``, the ``PreemptionGuard`` contract.

With ``--event-log`` (or a supervisor-exported run dir: the rank's shard
from ``observe.runlog.shard_event_log_from_env``) the worker writes real
telemetry of the port there: the ``run_start`` marker, one
``CollectiveEvent`` (a toy wire ledger, a fixed payload a step) and a
timed ``StepEvent`` a step. ``--health-every N`` adds a
``TrainHealthEvent`` every N steps with a near-constant grad norm, times
the ``factor`` of a chaos ``grad_spike`` at its step, and a
``MemoryEvent`` whose occupancy climbs toward the toy limit (as the JAX
package's toy worker samples them); under a run dir the
worker then reads the run's ``alerts.jsonl`` after every step
(``observe.live.AlertFeed``) and hands each alert to a two-rung
``FallbackController.nudge``, recording its decisions: the live plane's
round trip from a worker's shard through the supervisor's detectors back
to the worker. The telemetry imports ``observe`` (and so torch) only when
it is on: without it the worker imports neither torch nor jax.

With telemetry each step is a ``step`` span holding ``step/compute`` (the
sleep), ``step/comm`` (the simulated wire, below) and ``checkpoint/save``,
and the worker emits one ``CompileEvent`` (the JAX package's toy cost
model: fixed FLOPs a step and a made-up peak, the rung's ``comm_config``).

``--sim-fabric F`` sleeps, in a ``step/comm`` span each step, the modeled
ring all-reduce time (``utils.bandwidth.allreduce_time_s``) of the rung's
payload on fabric F, spread over the rung's sync period; ``--rung`` picks
the rung (``TOY_RUNG_SPECS``: the payload's compression, the sync period,
the collectives and the ``comm_config``), ``--payload-mult K`` scales the
payload. The measured step then answers to the comm config, which is what
the offline planner (``observe.costmodel``) needs to be tested against
realized times. A chaos ``comm_slow_edge`` adds its throttle's sleep to
the span of the edge's source rank (``CommFaultInjector``), so the
critical path and the fabric matrix can name the edge.

Usage::

    python torch_toy_supervised_worker.py --rank R --world W --steps N \\
        --state-dir D --result-dir D [--heartbeat-dir D] [--chaos-plan F] \\
        [--step-seconds S] [--graceful-term] [--event-log F] [--health-every N] \\
        [--sim-fabric F] [--rung R] [--payload-mult K]
"""

import argparse
import contextlib
import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from network_distributed_pytorch_tpu_torch.resilience.chaos import (  # noqa: E402
    CHAOS_EXIT_CODE,
    CKPT_UNWRITABLE_EXIT_CODE,
    CORRELATED_FAULTS,
    PREEMPT_EXIT_CODE,
    PROCESS_FAULTS,
    HEALTH_FAULTS,
    ChaosPlan,
    CommFaultInjector,
)
from network_distributed_pytorch_tpu_torch.resilience.supervisor import incarnation_from_env  # noqa: E402

# the toy wire ledger: a fixed all-reduce payload a step
TOY_PAYLOAD_BYTES = 1 << 20
# the toy cost model: a fixed FLOPs count and a made-up peak, for the
# report's MFU join (the JAX package's toy's numbers)
TOY_FLOPS_PER_STEP = 2.0e9
TOY_PEAK_FLOPS = 1e12
TOY_DEVICE_KIND = "toy-sim"
# --rung: (the payload's compression divisor, sync_every, collectives a
# sync, the CompileEvent's comm_config), the knobs of the fallback ladder's
# rungs that the cost model prices (compress is the ladder's
# compress-low-rank). The simulated wire time is spread over the sync
# period, so every step is alike and the report's p50 is the modeled mean.
TOY_RUNG_SPECS = {
    "baseline": (1, 1, 1, {"reducer": "exact"}),
    "compress": (8, 1, 2, {"reducer": "powersgd", "reducer_rank": 1}),
    "localsgd": (8, 8, 2, {"reducer": "powersgd", "reducer_rank": 1, "sync_every": 8}),
}
# --health-every: the grad norm's baseline, constant, so the spike
# detector's envelope has almost no variance and a chaos grad_spike (factor
# 1000 by default) is unambiguously critical
TOY_GRAD_NORM = 1.0
# --health-every also samples a toy device memory: bytes_in_use climbs from
# 50 % of this limit toward 97 %, one rung a sample, so the supervisor's
# HbmHeadroomDetector crosses its warn threshold within a few samples
TOY_HBM_LIMIT = float(1 << 30)
# the pseudo-epoch the controller's nudges are charged to
EPOCH_LEN = 4
# observe.runlog.ENV_RUN_DIR: read before observe is imported, so a worker
# outside a run dir never imports it
ENV_RUN_DIR = "RUNLOG_RUN_DIR"


def _load_state(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {"step": 0, "value": 0}


def _save_state(path, state):
    # a short retry budget, then the fail-fast exit code, as the
    # checkpointed loop's _commit_save
    last = None
    for attempt in range(2):
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, path)
            return
        except OSError as e:
            last = e
            time.sleep(0.02 * (attempt + 1))
    sys.stderr.write(f"toy worker: state unwritable after retries: {last}\n")
    os._exit(CKPT_UNWRITABLE_EXIT_CODE)


def _beat(directory, rank, incarnation, step):
    path = os.path.join(directory, f"heartbeat_{rank}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"process_id": rank, "incarnation": incarnation, "ts": time.time(), "step": step}, f)
    os.replace(tmp, path)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--state-dir", required=True)
    p.add_argument("--result-dir", required=True)
    p.add_argument("--heartbeat-dir", default=None)
    p.add_argument("--chaos-plan", default=None)
    p.add_argument("--step-seconds", type=float, default=0.01)
    p.add_argument("--graceful-term", action="store_true")
    p.add_argument("--event-log", default=None)
    p.add_argument("--health-every", type=int, default=0)
    p.add_argument("--sim-fabric", default=None, choices=("1GbE", "10GbE", "100GbE", "NVLink4(H100)"))
    p.add_argument("--rung", default="baseline", choices=sorted(TOY_RUNG_SPECS))
    p.add_argument("--payload-mult", type=int, default=1)
    args = p.parse_args()

    incarnation = incarnation_from_env()
    plan = ChaosPlan.load(args.chaos_plan) if args.chaos_plan else ChaosPlan()
    for d in (args.state_dir, args.result_dir, args.heartbeat_dir):
        if d:
            os.makedirs(d, exist_ok=True)
    state_path = os.path.join(args.state_dir, f"rank{args.rank}.json")
    state = _load_state(state_path)

    if args.graceful_term:
        def _on_term(signum, frame):
            _save_state(state_path, state)
            os._exit(PREEMPT_EXIT_CODE)

        signal.signal(signal.SIGTERM, _on_term)

    payload_bytes = TOY_PAYLOAD_BYTES * max(1, args.payload_mult)
    divisor, sync_every, n_coll, comm_config = TOY_RUNG_SPECS[args.rung]
    rung_bytes = payload_bytes // divisor

    telemetry = controller = feed = None
    run_dir = os.environ.get(ENV_RUN_DIR)
    span = None
    if args.event_log or run_dir:
        from network_distributed_pytorch_tpu_torch.observe import (
            CollectiveEvent,
            CompileEvent,
            MemoryEvent,
            StepEvent,
            TrainHealthEvent,
            recording,
            span,
            telemetry_for_run,
        )
        from network_distributed_pytorch_tpu_torch.observe.runlog import shard_event_log_from_env

        event_log = args.event_log or shard_event_log_from_env()
        if event_log:
            telemetry = telemetry_for_run(event_log=event_log, stdout=False)
            telemetry.emit(CollectiveEvent(
                label="toy", tag="toy.grads", layer="reducer", op="all-reduce", axis="data", dtype="float32",
                payload_bytes=rung_bytes,
            ))
            # exact by construction, one exposed collective, the toy cost
            # model and the rung's comm_config (what join_realized matches)
            telemetry.emit(CompileEvent(
                label="toy", analytic_bytes=rung_bytes, hlo_bytes=rung_bytes, delta_bytes=0, exact=True,
                hlo_collective_count=1, hlo_by_kind={"all-reduce": 1},
                overlap={"scheduled": True, "n_sync_collectives": 1, "n_sync_gaps_with_compute": 0},
                flops_per_step=TOY_FLOPS_PER_STEP, flops_source="analytic", device_kind=TOY_DEVICE_KIND,
                peak_flops_per_s=TOY_PEAK_FLOPS, comm_config=dict(comm_config),
            ))
    if telemetry is not None and run_dir and args.health_every > 0:
        from network_distributed_pytorch_tpu_torch.observe.live import AlertFeed
        from network_distributed_pytorch_tpu_torch.resilience.controller import FallbackController, Rung

        feed = AlertFeed(run_dir)
        controller = FallbackController(
            ladder=[Rung("baseline", {}), Rung("compress", {"reducer": "powersgd", "reducer_rank": 1})],
            telemetry=telemetry, rank=args.rank,
        )

    peak = 0.0

    def ladder_bytes(index):
        return TOY_PAYLOAD_BYTES if index == 0 else TOY_PAYLOAD_BYTES // 8

    # the comm faults of the plan: a comm_slow_edge's sleep is paid here, in
    # the step/comm span of the edge's source rank
    comm_chaos = CommFaultInjector(plan, rank=args.rank, incarnation=incarnation, telemetry=telemetry)

    def comm_sleep_s():
        wire = 0.0
        if args.sim_fabric is not None:
            from network_distributed_pytorch_tpu_torch.utils.bandwidth import allreduce_time_s

            wire = allreduce_time_s(rung_bytes, args.world, args.sim_fabric, n_collectives=n_coll) / sync_every
        return wire + comm_chaos.host_throttle_sleep_s(rung_bytes)

    def region(name, step):
        return span(name, step=step, rank=args.rank) if telemetry is not None else contextlib.nullcontext()

    with recording(telemetry) if telemetry is not None else contextlib.nullcontext():
        while state["step"] < args.steps:
            i = state["step"]
            if args.heartbeat_dir:
                _beat(args.heartbeat_dir, args.rank, incarnation, i)
            comm_chaos.advance(i)
            spec = plan.pop(PROCESS_FAULTS + CORRELATED_FAULTS, i, args.rank, incarnation)
            if spec is not None:
                if spec.kind == "proc_exit":
                    os._exit(int(spec.payload.get("exit_code", CHAOS_EXIT_CODE)))
                if spec.kind in ("proc_kill", "zone_outage"):
                    os.kill(os.getpid(), signal.SIGKILL)
                if spec.kind == "host_flap" and incarnation < int(spec.payload.get("flaps", 2)):
                    os.kill(os.getpid(), signal.SIGKILL)
                if spec.kind == "proc_hang":
                    time.sleep(float(spec.payload.get("hang_seconds", 3600.0)))
                if spec.kind == "proc_preempt":
                    os.kill(os.getpid(), signal.SIGTERM)
            t0 = time.monotonic()
            with region("step", i):
                with region("step/compute", i):
                    time.sleep(args.step_seconds)
                # outside step/compute, so that the cost model's compute
                # calibration (that span's mean) holds no comm
                comm_s = comm_sleep_s()
                if comm_s > 0:
                    with region("step/comm", i):
                        time.sleep(comm_s)
                state = {"step": i + 1, "value": state["value"] + args.world}
                with region("checkpoint/save", i):
                    _save_state(state_path, state)
            if telemetry is not None:
                telemetry.emit(StepEvent(
                    step=i, epoch=i // EPOCH_LEN, loss=1.0 / (i + 1), step_time_s=time.monotonic() - t0,
                    bits_cumulative=8 * rung_bytes * (i + 1),
                ))
                if args.health_every > 0 and i % args.health_every == 0:
                    grad_norm = TOY_GRAD_NORM
                    spec = plan.pop(HEALTH_FAULTS, i, args.rank, incarnation)
                    if spec is not None and spec.kind == "grad_spike":
                        grad_norm *= float(spec.payload.get("factor", 1000.0))
                    telemetry.emit(TrainHealthEvent(
                        step=i, epoch=i // EPOCH_LEN, grad_norm=grad_norm, ef_memory_norm=0.0,
                        powersgd_rel_error=0.0, loss=1.0 / (i + 1), rank=args.rank, label="toy",
                    ))
                    in_use = TOY_HBM_LIMIT * min(0.97, 0.5 + 0.2 * (i // args.health_every))
                    peak = max(peak, in_use)
                    telemetry.emit(MemoryEvent(
                        step=i, bytes_in_use=in_use, peak_bytes_in_use=peak, bytes_limit=TOY_HBM_LIMIT,
                        device_kind="toy-sim", rank=args.rank, label="toy",
                    ))
            if feed is not None:
                # the live plane's return leg: what the supervisor's detectors
                # appended to alerts.jsonl nudges the controller mid-epoch
                for rec in feed.poll():
                    decision = controller.nudge(
                        rec.get("alert", ""), i // EPOCH_LEN, severity=rec.get("severity", "warn"))
                    if decision is not None:
                        controller.record(
                            decision, predicted_bytes_per_step=ladder_bytes(decision.rung_index_after),
                            realized_bytes_per_step=ladder_bytes(decision.rung_index_before),
                        )

    if telemetry is not None:
        telemetry.close()
    with open(os.path.join(args.result_dir, f"rank{args.rank}.json"), "w") as f:
        json.dump({"rank": args.rank, "world": args.world, "incarnation": incarnation, **state}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
