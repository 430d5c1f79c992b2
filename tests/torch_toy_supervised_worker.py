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

Usage::

    python torch_toy_supervised_worker.py --rank R --world W --steps N \\
        --state-dir D --result-dir D [--heartbeat-dir D] [--chaos-plan F] \\
        [--step-seconds S] [--graceful-term]
"""

import argparse
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
    ChaosPlan,
)
from network_distributed_pytorch_tpu_torch.resilience.supervisor import incarnation_from_env  # noqa: E402


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

    while state["step"] < args.steps:
        i = state["step"]
        if args.heartbeat_dir:
            _beat(args.heartbeat_dir, args.rank, incarnation, i)
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
        time.sleep(args.step_seconds)
        state = {"step": i + 1, "value": state["value"] + args.world}
        _save_state(state_path, state)

    with open(os.path.join(args.result_dir, f"rank{args.rank}.json"), "w") as f:
        json.dump({"rank": args.rank, "world": args.world, "incarnation": incarnation, **state}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
