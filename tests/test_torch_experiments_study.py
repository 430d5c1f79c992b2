"""The study's entry points on the CPU: ``diloco_cifar10`` (compressed
rounds, streaming, a trailing partial round padded rather than dropped),
``bandwidth_study`` (every configuration of the JAX study, each step's or
round's bits as the recorder counted them) and the launcher's new flags."""

import numpy as np
import pytest

from network_distributed_pytorch_tpu.experiments import bandwidth_study as jax_study
from network_distributed_pytorch_tpu_torch import launch
from network_distributed_pytorch_tpu_torch.experiments import bandwidth_study, diloco_cifar10
from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig
from torch_worker import few_torch_threads  # noqa: F401  (autouse)


def _run(**kw):
    """The JAX package's test run: two epochs of two rounds of four steps."""
    cfg = ExperimentConfig(training_epochs=2, global_batch_size=64, reducer_rank=2, log_every=0)
    return diloco_cifar10.run(
        cfg, preset="small", data_dir="/nonexistent", device="cpu", sync_every=4, max_steps_per_epoch=8, **kw
    )


def test_diloco_cifar10_compressed_rounds():
    """Two epochs of two PowerSGD-compressed rounds: one logged step a
    round, each charged the round's bits, and the loss falls."""
    out = _run(reducer="powersgd")
    assert out["steps"] == out["rounds"] == 4 and out["num_devices"] == 1
    assert out["bits_communicated"] == 4 * out["bits_per_round"]
    assert out["bits_per_step"] == out["bits_per_round"] / 4
    assert out["shape_groups"] > 0 and out["padded_slots"] == out["skipped_batches"] == 0
    assert all(np.isfinite(out["losses"])) and out["final_loss"] < out["first_loss"]


def test_diloco_cifar10_streaming():
    """Two fragments: the rounds alternate between the phases' bits, and the
    reported round bits are the peak phase's."""
    out = _run(reducer="powersgd", fragments=2)
    assert out["fragments"] == 2 and out["steps"] == 4 and all(np.isfinite(out["losses"]))
    assert out["bits_communicated"] == 2 * round(2 * 4 * out["bits_per_step"])
    assert out["bits_per_round"] < 2 * 4 * out["bits_per_step"]


def test_trailing_partial_round_pads_not_drops(monkeypatch):
    """Seven batches at sync_every 4: one full round and one of three real
    batches and a pad of weight 0, both logged and synced, nothing dropped."""
    rng = np.random.RandomState(0)
    x = rng.rand(7 * 16, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=(7 * 16,)).astype(np.int32)
    monkeypatch.setattr(diloco_cifar10, "load_cifar10_or_synthetic", lambda data_dir, train=True: (x, y, False))
    cfg = ExperimentConfig(training_epochs=1, global_batch_size=16, log_every=0)
    out = diloco_cifar10.run(cfg, preset="small", device="cpu", sync_every=4)
    assert out["steps"] == out["rounds"] == 2 and out["padded_slots"] == 1 and out["skipped_batches"] == 0
    assert out["bits_communicated"] == 2 * out["bits_per_round"]
    assert all(np.isfinite(out["losses"]))


def test_too_few_steps_for_a_round_is_refused():
    with pytest.raises(ValueError, match="not even one sync round"):
        diloco_cifar10.run(ExperimentConfig(), preset="small", device="cpu", sync_every=8, max_steps_per_epoch=4)


def test_bandwidth_study_covers_the_jax_study():
    """Every configuration of the JAX study at one rank (the hierarchical
    row needs four: ``test_torch_hierarchical.py``), each one's bits as
    recorded, slower fabrics never faster, and the avoidance rows an order
    below exact DDP."""
    out = bandwidth_study.run(preset="small", device="cpu", global_batch=64, reducer_ranks=(2,))
    res = out["results"]
    want = set(jax_study.flat_reducer_configs(0, (2,)))
    want |= {f"local_sgd_h{jax_study.SCAN_SYNC_EVERY}", f"diloco_psgd_r4_h{jax_study.SCAN_SYNC_EVERY}"}
    assert set(res) == want and out["num_devices"] == 1
    for name, r in res.items():
        if "sync_every" in r:
            assert r["recorded_bits_per_round"] == r["bits_per_round"], name
        else:
            assert r["recorded_bits_per_step"] == r["bits_per_step"], name
        assert r["measured_step_s"] > 0 and np.isfinite(r["final_loss"])
        p = r["projected_step_s"]
        assert p["1GbE"] >= p["10GbE"] >= p["100GbE"] >= p["NVLink4(H100)"] >= r["measured_step_s"], name
    assert res["powersgd_r2"]["compression_ratio"] > 10
    assert res["local_sgd_h8"]["bits_per_step"] < res["exact"]["bits_per_step"] / 7
    assert res["diloco_psgd_r4_h8"]["bits_per_step"] < res["local_sgd_h8"]["bits_per_step"] / 10
    assert res["topk_1pct"]["steps_run"] == 5 and res["local_sgd_h8"]["rounds_run"] == 4


def test_bandwidth_study_projects_another_world():
    """At one rank, a projection of eight workers charges each gather its
    eight contributions and the ring its 2 * 7 / 8 of the payload."""
    out = bandwidth_study.run(
        preset="small", device="cpu", global_batch=16, reducer_ranks=(1,), timed_steps=1, timed_rounds=1,
        project_workers=8,
    )
    res = out["results"]
    assert out["projected_workers"] == 8
    sign = res["signsgd"]
    assert sign["projected_bits_per_step"] - 32 == 8 * (sign["bits_per_step"] - 32)
    exact = res["exact"]
    assert exact["projected_bits_per_step"] == exact["bits_per_step"]
    comm = exact["projected_step_s"]["1GbE"] - exact["measured_step_s"]
    ring = 2 * 7 / 8 * exact["bits_per_step"] / 8 / 0.125e9
    np.testing.assert_allclose(comm, ring + 2 * 50e-6, rtol=1e-9)


def test_launcher_runs_diloco_with_its_flags(capsys):
    out = launch.main([
        "diloco_cifar10", "--device", "cpu", "--global-batch", "16", "--epochs", "1", "--max-steps-per-epoch", "4",
        "--sync-every", "2", "--diloco-reducer", "powersgd", "--fragments", "2", "--lr", "0.1", "--reducer-rank", "2",
        "--json",
    ])
    assert out["experiment"] == "diloco_cifar10" and out["steps"] == 2
    assert (out["sync_every"], out["fragments"], out["reducer"], out["reducer_rank"]) == (2, 2, "powersgd", 2)
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"experiment": "diloco_cifar10"')


@pytest.mark.parametrize(
    "args",
    [
        ["powersgd_cifar10", "--sync-every", "4"],
        ["exact_cifar10", "--fragments", "2"],
        ["gpt_lm", "--diloco-reducer", "powersgd"],
        ["bandwidth_study", "--max-steps-per-epoch", "2"],
        ["bandwidth_study", "--dtype", "bfloat16"],
    ],
    ids=["sync_every", "fragments", "diloco_reducer", "study_steps", "study_dtype"],
)
def test_launcher_refuses_the_new_flags_elsewhere(args):
    with pytest.raises(ValueError):
        launch.main(args + ["--device", "cpu"])
