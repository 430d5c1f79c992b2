"""The launcher's training flags, as the JAX package's launcher gives them:
``--accum-steps``, ``--max-grad-norm``, ``--log-every``, ``--json``,
``--remat`` and ``--scan-layers``. Each flag reaches the run (its config
or its keyword), each is refused by the experiments the JAX launcher
refuses it for, before any rendezvous (the run is never called), and
``--json`` alone prints the summary line."""

import json

import numpy as np
import pytest

from network_distributed_pytorch_tpu_torch import launch


@pytest.fixture
def runs(monkeypatch):
    """Every experiment's ``run`` replaced by a recorder of its config and
    keywords: a refusal must come before it."""
    seen = []

    def recorder(name):
        def run(cfg, **kwargs):
            seen.append((name, cfg, kwargs))
            return {"experiment": name}

        return run

    for name, module in launch.EXPERIMENTS.items():
        monkeypatch.setattr(module, "run", recorder(name))
    return seen


@pytest.mark.parametrize(
    "args,field,value",
    [
        (["powersgd_cifar10", "--accum-steps", "2"], "accum_steps", 2),
        (["imdb_baseline", "--accum-steps", "4"], "accum_steps", 4),
        (["exact_cifar10", "--max-grad-norm", "0.5"], "max_grad_norm", 0.5),
        (["powersgd_imdb", "--max-grad-norm", "1.0"], "max_grad_norm", 1.0),
        (["gpt_lm", "--log-every", "3"], "log_every", 3),
        (["bare_init"], "log_every", 10),
    ],
)
def test_config_flags_reach_the_run(runs, args, field, value):
    launch.main([*args, "--device", "cpu"])
    (name, cfg, _), = runs
    assert name == args[0] and getattr(cfg, field) == value


@pytest.mark.parametrize(
    "args,kwargs",
    [
        (["gpt_lm", "--remat", "--scan-layers"], {"remat": True, "scan_layers": True}),
        (["gpt_lm"], {"remat": False, "scan_layers": False}),
        (["powersgd_imdb", "--remat"], {"remat": True}),
    ],
)
def test_remat_and_scan_layers_reach_the_run(runs, args, kwargs):
    launch.main([*args, "--device", "cpu"])
    (_, _, got), = runs
    assert {k: got[k] for k in kwargs} == kwargs


@pytest.mark.parametrize(
    "args",
    [
        ["gpt_lm", "--accum-steps", "2"],
        ["diloco_cifar10", "--accum-steps", "2"],
        ["gpt_tp", "--max-grad-norm", "1.0"],
        ["bandwidth_study", "--max-grad-norm", "1.0"],
        ["exact_cifar10", "--remat"],
        ["gpt_pp", "--remat"],
        ["powersgd_imdb", "--scan-layers"],
        ["gpt_generate", "--scan-layers"],
    ],
)
def test_flags_are_refused_before_any_rendezvous(runs, args):
    with pytest.raises(ValueError, match=f"{args[1]} is not supported by '{args[0]}'"):
        launch.main([*args, "--device", "cpu"])
    assert runs == []


def test_accum_steps_of_one_is_not_refused(runs):
    launch.main(["gpt_lm", "--accum-steps", "1", "--device", "cpu"])
    assert runs[0][1].accum_steps == 1


def test_json_alone_prints_the_summary(runs, capsys):
    launch.main(["bare_init", "--device", "cpu"])
    assert capsys.readouterr().out == ""
    launch.main(["bare_init", "--device", "cpu", "--json"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"experiment": "bare_init"}


def test_fsdp_keeps_its_own_refusals():
    """``exact_cifar10 --strategy fsdp`` takes neither accumulation nor
    clipping: the experiment refuses them before its rendezvous."""
    for flags, what in ((["--accum-steps", "2"], "accum_steps"), (["--max-grad-norm", "1.0"], "max_grad_norm")):
        with pytest.raises(ValueError, match=what):
            launch.main(["exact_cifar10", "--device", "cpu", "--strategy", "fsdp", *flags])


def test_the_flags_run_end_to_end_on_cpu(capsys):
    out = launch.main([
        "gpt_lm", "--device", "cpu", "--epochs", "1", "--max-steps-per-epoch", "1", "--remat", "--scan-layers",
        "--log-every", "1", "--json",
    ])
    assert out["remat"] and out["scan_layers"] and np.isfinite(out["losses"]).all()
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["scan_layers"]
    out = launch.main([
        "powersgd_cifar10", "--device", "cpu", "--global-batch", "16", "--epochs", "1", "--max-steps-per-epoch",
        "1", "--accum-steps", "2", "--max-grad-norm", "1.0", "--dtype", "bfloat16",
    ])
    assert out["compute_dtype"] == "bfloat16" and np.isfinite(out["losses"]).all()
