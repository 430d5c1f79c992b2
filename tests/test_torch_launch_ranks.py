"""The launcher's rank, world and card from the environment:

- ``--process-id`` and ``--num-processes`` default to torchrun's ``RANK``
  and ``WORLD_SIZE``, else mpirun's ``OMPI_COMM_WORLD_RANK`` and
  ``OMPI_COMM_WORLD_SIZE`` (the JAX launcher's defaults, held to its
  parser), else 0 and 1, each variable on its own; the flags win;
- ``worker_cuda_device`` takes ``LOCAL_RANK``, else
  ``OMPI_COMM_WORLD_LOCAL_RANK``, else the fleet's grant, else the process
  id;
- two launcher processes given only mpirun's variables form one world of
  two (``bare_init`` over Gloo), where they used to run two worlds of one.
"""

import json
import os
import subprocess
import sys

import pytest

from network_distributed_pytorch_tpu import launch as jax_launch
from network_distributed_pytorch_tpu_torch import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_VARS = ("RANK", "WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE")
CARD_VARS = ("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK", "RESILIENCE_DEVICE_RANKS")


@pytest.fixture
def env(monkeypatch):
    for name in RANK_VARS + CARD_VARS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _cfg(argv=()):
    return launch.config_from_args(launch.build_parser().parse_args(["exact_cifar10", *argv]))


@pytest.mark.parametrize("variables,want", [
    ({}, (0, 1)),
    ({"RANK": "2", "WORLD_SIZE": "4"}, (2, 4)),
    ({"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "3"}, (1, 3)),
    ({"RANK": "0", "WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "3", "OMPI_COMM_WORLD_SIZE": "5"}, (0, 2)),
    ({"RANK": "1", "OMPI_COMM_WORLD_SIZE": "2"}, (1, 2)),  # each variable on its own
    ({"OMPI_COMM_WORLD_RANK": "1", "WORLD_SIZE": "4"}, (1, 4)),
])
def test_rank_and_world_from_the_environment(env, variables, want):
    for k, v in variables.items():
        env.setenv(k, v)
    assert launch.env_rank_and_world() == want
    cfg = _cfg()
    assert (cfg.process_id, cfg.num_processes) == want
    assert cfg.coordinator_address == ("env://" if want[1] > 1 else None)


@pytest.mark.parametrize("rank,size", [("0", "1"), ("1", "2"), ("3", "4")])
def test_mpiruns_variables_give_the_jax_launchers_defaults(env, rank, size):
    env.setenv("OMPI_COMM_WORLD_RANK", rank)
    env.setenv("OMPI_COMM_WORLD_SIZE", size)
    jargs = jax_launch.build_parser().parse_args(["exact_cifar10"])
    cfg = _cfg()
    assert (cfg.process_id, cfg.num_processes) == (jargs.process_id, jargs.num_processes) == (int(rank), int(size))


def test_the_flags_win_over_the_environment(env):
    env.setenv("RANK", "3")
    env.setenv("OMPI_COMM_WORLD_SIZE", "8")
    cfg = _cfg(["--process-id", "1", "--num-processes", "2", "--coordinator", "tcp://127.0.0.1:1"])
    assert (cfg.process_id, cfg.num_processes, cfg.coordinator_address) == (1, 2, "tcp://127.0.0.1:1")


@pytest.mark.parametrize("variables,pid,world,want", [
    ({"OMPI_COMM_WORLD_LOCAL_RANK": "2"}, 0, 1, "cuda:2"),
    ({"LOCAL_RANK": "1", "OMPI_COMM_WORLD_LOCAL_RANK": "2"}, 0, 1, "cuda:1"),  # torchrun's first
    ({"OMPI_COMM_WORLD_LOCAL_RANK": "0", "RESILIENCE_DEVICE_RANKS": "[3]"}, 0, 1, "cuda:0"),  # before the grant
    ({"RESILIENCE_DEVICE_RANKS": "[3]"}, 0, 1, "cuda:3"),
    ({}, 2, 4, "cuda:2"),
])
def test_card_choice_order(env, variables, pid, world, want):
    for k, v in variables.items():
        env.setenv(k, v)
    assert launch.worker_cuda_device(pid, world, device_count=4) == want


def test_mpiruns_local_rank_on_a_missing_card_raises(env):
    env.setenv("OMPI_COMM_WORLD_LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="OMPI_COMM_WORLD_LOCAL_RANK names card 1, but this machine has 1 card"):
        launch.worker_cuda_device(0, 1, device_count=1)


def test_two_processes_with_mpiruns_variables_form_one_world(tmp_path):
    base = {k: v for k, v in os.environ.items() if k not in RANK_VARS + CARD_VARS}
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "network_distributed_pytorch_tpu_torch.launch", "bare_init", "--device", "cpu",
             "--coordinator", f"file://{tmp_path}/rendezvous", "--json"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            env={**base, "OMPI_COMM_WORLD_RANK": str(r), "OMPI_COMM_WORLD_SIZE": "2", "OMP_NUM_THREADS": "1"},
        )
        for r in range(2)
    ]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    summaries = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [(s["process_id"], s["num_devices"], s["backend"]) for s in summaries] == [(0, 2, "gloo"), (1, 2, "gloo")]
