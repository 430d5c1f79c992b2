"""Exact-allreduce DDP in the PyTorch port against the JAX package:
``bucket_assignments``; the explicit ring on three Gloo ranks against the
JAX ring under ``shard_map`` on three CPU devices; every ``ExactReducer``
layout (one packed payload, one collective per tensor, buckets, chunks, the
ring) on two ranks, and on three ranks with dyadic values; PowerSGD with
chunked payloads; BatchNorm statistics averaged before an evaluation;
``exact_cifar10.run`` against the JAX run from the same weights; and the
launcher.

Tolerances. The ring follows the JAX ring's schedule step for step, and
scales the sum by fp32(1/W) as the JAX ring's compiled ``/ W`` does, so the
two are held equal bit for bit; against one all-reduce the ring
reassociates the sum, rtol 1e-6 (about 1 ulp). Layouts are bitwise equal on
two ranks (a sum of two floats does not depend on order) and on dyadic
values at three; they are not compared on arbitrary floats at three ranks,
where Gloo's algorithms split a buffer by its size and can reassociate.
``exact_cifar10`` after two steps: losses 1e-5 and parameters 1e-4, the
ResNet classes of ``test_torch_training.py`` (XLA and PyTorch sum the
convolutions' backward in other orders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from network_distributed_pytorch_tpu.experiments import exact_cifar10 as jax_exact_cifar10
from network_distributed_pytorch_tpu.models import resnet18 as jax_resnet18
from network_distributed_pytorch_tpu.parallel import make_mesh
from network_distributed_pytorch_tpu.parallel.comm import bucket_assignments as jax_bucket_assignments
from network_distributed_pytorch_tpu.parallel.comm import chunked_all_reduce_mean as jax_chunked_all_reduce_mean
from network_distributed_pytorch_tpu.parallel.comm import ring_all_reduce_mean as jax_ring_all_reduce_mean
from network_distributed_pytorch_tpu.parallel.mesh import DATA_AXIS
from network_distributed_pytorch_tpu.parallel.reducers import ExactReducer as JaxExactReducer
from network_distributed_pytorch_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
from network_distributed_pytorch_tpu_torch import launch
from network_distributed_pytorch_tpu_torch.experiments import exact_cifar10
from network_distributed_pytorch_tpu_torch.models.import_weights import resnet_state_dict_from_flax
from network_distributed_pytorch_tpu_torch.parallel.comm import bucket_assignments, n_bits, ring_all_reduce_mean
from network_distributed_pytorch_tpu_torch.parallel.reducers import ExactReducer, PowerSGDReducer
from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig
from torch_parity import random_flax_variables, to_numpy
from torch_worker import (  # few_torch_threads: autouse
    average_state_rank,
    exact_cifar10_rank,
    exact_layouts_rank,
    few_torch_threads,
    powersgd_rank,
    ring_rank,
    run_all,
    spawn,
)

TOL = 1e-4
LOSS_TOL = 1e-5


@pytest.mark.parametrize(
    "sizes,target",
    [
        ([4, 4, 4, 4, 4], 8),
        ([1, 2, 3], 1),
        ([1, 2, 3], 0),
        ([10, 1, 1, 10, 3], 11),
        ([100, 1, 1, 1], 100),
        ([5, 6, 7], 18),
        ([5, 6, 7], 1 << 30),
        ([], 10),
    ],
    ids=["even", "one_byte", "zero_clamps", "uneven", "exact_fit", "total", "above_total", "empty"],
)
def test_bucket_assignments_match_jax(sizes, target):
    got = bucket_assignments(sizes, target)
    assert got == jax_bucket_assignments(sizes, target)
    assert sorted(i for b in got for i in b) == list(range(len(sizes)))
    assert all(b == sorted(b) and b for b in got)


def test_resnet50_buckets_at_torch_ddp_default():
    """torch DDP's 25 MiB cap over ResNet-50's 161 leaves in the port's
    order: four buckets (the first holds the head and the last stage),
    the same as the JAX function gives on the same sizes."""
    sizes = [n_bits(p) // 8 for p in exact_cifar10.build_model("full", "cpu").parameters()]
    buckets = bucket_assignments(sizes, 25 << 20)
    assert buckets == jax_bucket_assignments(sizes, 25 << 20)
    mib = [round(sum(sizes[i] for i in b) / 2**20, 2) for b in buckets]
    assert mib == [30.12, 25.04, 25.32, 9.27] and len(sizes) == 161
    assert buckets[0][-1] == 160 and buckets[-1][0] == 0


def test_ring_without_a_group_is_identity():
    x = torch.arange(7.0)
    assert ring_all_reduce_mean(x, None) is x
    assert ring_all_reduce_mean(torch.zeros(0), None).numel() == 0


# ---- three ranks: the ring, and dyadic layouts ------------------------------

RING_N, RING_CHUNKS = 1001, 4  # 1001 % 3 != 0: the ring pads


def _ring_inputs():
    rng = np.random.RandomState(20)
    return [torch.from_numpy(rng.randn(RING_N).astype(np.float32)) for _ in range(3)]


# leaves whose sizes cross the bucket targets below (9.7 KB in all)
LEAF_SHAPES = [(16, 32), (300,), (3, 3, 8, 8), (1,), (1000,), (7,), (5, 2)]
LAYOUTS = {
    "mono": {},
    "per_tensor": {"packed": False},
    "bucket_1": {"bucket_bytes": 1},
    "bucket_4096": {"bucket_bytes": 4096},
    "bucket_above_total": {"bucket_bytes": 1 << 20},
    "chunks_2": {"comm_chunks": 2},
    "chunks_7": {"comm_chunks": 7},
    "bucket_4096_chunks_2": {"bucket_bytes": 4096, "comm_chunks": 2},
    "ring": {"comm_strategy": "ring"},
    "ring_chunks_7": {"comm_strategy": "ring", "comm_chunks": 7},
    "ring_bucket_4096": {"comm_strategy": "ring", "bucket_bytes": 4096},
}
RING_LAYOUTS = [k for k in LAYOUTS if k.startswith("ring")]


def _sends(world, seed, dyadic=False):
    rng = np.random.RandomState(seed)
    draw = (lambda s: rng.randint(-50, 50, s)) if dyadic else (lambda s: rng.randn(*s))
    return [[torch.from_numpy(np.asarray(draw(s), np.float32)) for s in LEAF_SHAPES] for _ in range(world)]


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    calls = [(ring_rank, (_ring_inputs(), RING_CHUNKS)), (exact_layouts_rank, (_sends(3, 21, dyadic=True), LAYOUTS))]
    ring, layouts = zip(*spawn(run_all, 3, tmp_path_factory.mktemp("ranks3"), calls))
    return {"ring": ring, "layouts": layouts}


def _jax_ring(fn, xs):
    """``fn`` on each of three CPU devices' rows of ``xs`` under shard_map."""
    mesh = make_mesh(devices=jax.devices()[:3])
    body = jax.shard_map(lambda x: fn(x[0])[None], mesh=mesh, in_specs=P(DATA_AXIS), out_specs=P(DATA_AXIS))
    return np.asarray(jax.jit(body)(jnp.asarray(np.stack(xs))))


def test_ring_equals_jax_ring_bitwise_on_three_ranks(three_ranks):
    xs = [x.numpy() for x in _ring_inputs()]
    want = _jax_ring(lambda x: jax_ring_all_reduce_mean(x, DATA_AXIS), xs)
    want_chunked = _jax_ring(lambda x: jax_chunked_all_reduce_mean(x, DATA_AXIS, RING_CHUNKS, "ring"), xs)
    for rank, res in enumerate(three_ranks["ring"]):
        assert res["ring"].shape == (RING_N,)
        np.testing.assert_array_equal(res["ring"].numpy().view(np.uint32), want[rank].view(np.uint32))
        np.testing.assert_array_equal(res["chunked_ring"].numpy().view(np.uint32), want_chunked[rank].view(np.uint32))
        # every rank holds the same bits
        assert torch.equal(res["ring"], three_ranks["ring"][0]["ring"])


def test_ring_close_to_all_reduce_mean_on_three_ranks(three_ranks):
    for res in three_ranks["ring"]:
        torch.testing.assert_close(res["ring"], res["mean"], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(res["chunked_ring"], res["mean"], rtol=1e-6, atol=1e-7)


def test_exact_layouts_bitwise_on_dyadic_values_at_three_ranks(three_ranks):
    """Integers in fp32 sum exactly in any order, so every layout, the ring
    among them, gives the same bits: the sum over ranks times fp32(1/3),
    the JAX package's mean."""
    sends = _sends(3, 21, dyadic=True)
    want = [sum(sends[r][i] for r in range(3)).mul(1 / 3) for i in range(len(LEAF_SHAPES))]
    for res in three_ranks["layouts"]:
        for name in LAYOUTS:
            for got, w in zip(res[name]["out"], want):
                assert torch.equal(got, w), name


# ---- two ranks: every layout, PowerSGD chunks, BN averaging, the entry point --

POWERSGD_SHAPES = [(8, 6), (5, 3, 2, 2), (9,), (4, 4)]
POWERSGD_KW = {"random_seed": 3, "compression_rank": 2, "matricize": "last"}
CIFAR_CFG = {"training_epochs": 1, "global_batch_size": 16, "learning_rate": 0.01}


def _powersgd_sends():
    rng = np.random.RandomState(22)
    return [[[torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in POWERSGD_SHAPES] for _ in range(2)]
            for _ in range(2)]  # [rank][step][leaf]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    sends = _powersgd_sends()
    q0 = PowerSGDReducer(**POWERSGD_KW).init(sends[0][0]).q_memory
    calls = [
        (exact_layouts_rank, (_sends(2, 23), LAYOUTS)),
        (powersgd_rank, (sends, q0, POWERSGD_KW)),
        (powersgd_rank, (sends, q0, {**POWERSGD_KW, "comm_chunks": 3})),
        (average_state_rank, ()),
        (exact_cifar10_rank, (CIFAR_CFG, 2)),
    ]
    results = spawn(run_all, 2, tmp_path_factory.mktemp("ranks2"), calls)
    names = ("layouts", "powersgd", "powersgd_chunked", "bn", "exact_cifar10")
    return {name: [res[i] for res in results] for i, name in enumerate(names)}


def test_exact_layouts_bitwise_on_two_ranks(two_ranks):
    """Every layout gives (send_0 + send_1) / 2 bit for bit, and the same
    bits on the wire; the interleave and ring layouts each agree among
    themselves and, on two ranks, with each other."""
    sends = _sends(2, 23)
    want = [(a + b) / 2 for a, b in zip(*sends)]
    total_bits = sum(n_bits(t) for t in sends[0])
    for res in two_ranks["layouts"]:
        for group in ([k for k in LAYOUTS if k not in RING_LAYOUTS], RING_LAYOUTS):
            for name in group:
                assert res[name]["bits"] == total_bits, name
                for got, first, w in zip(res[name]["out"], res[group[0]]["out"], want):
                    assert torch.equal(got, first) and torch.equal(got, w), name


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_n_collectives_match_jax(layout):
    """The JAX reducer fed the same leaves as a list (a list keeps its
    order) counts the same collectives."""
    leaves = _sends(1, 24)[0]
    got = ExactReducer(**LAYOUTS[layout]).n_collectives(leaves)
    want = JaxExactReducer(**LAYOUTS[layout]).n_collectives([jnp.asarray(t.numpy()) for t in leaves])
    assert got == want
    assert ExactReducer(**LAYOUTS[layout]).bits_per_step(leaves) == 32 * sum(t.numel() for t in leaves)


def test_powersgd_chunked_payloads_bitwise_on_two_ranks(two_ranks):
    for plain, chunked in zip(two_ranks["powersgd"], two_ranks["powersgd_chunked"]):
        assert torch.equal(plain["q_memory"], chunked["q_memory"])
        for a, b in zip(plain["steps"], chunked["steps"]):
            assert a["bits"] == b["bits"]
            for x, y in zip(a["out"] + a["mem"], b["out"] + b["mem"]):
                assert torch.equal(x, y)


def test_average_model_state_on_two_ranks(two_ranks):
    """Floating-point buffers become the ranks' mean (1 and 2 give 1.5);
    the batch counters stay each rank's own."""
    for rank, buffers in enumerate(two_ranks["bn"]):
        for name, b in buffers.items():
            want = 10 + rank if name.endswith("num_batches_tracked") else 1.5
            assert torch.all(b == want), name


def test_exact_cifar10_two_ranks_evaluate_the_same_model(two_ranks):
    """Two ranks train on their halves of each batch and evaluate after the
    BatchNorm statistics are averaged: the same losses, bits and accuracy
    on both."""
    r0, r1 = two_ranks["exact_cifar10"]
    for res in (r0, r1):
        assert res["num_devices"] == 2 and res["steps"] == 2 and np.isfinite(res["losses"]).all()
        assert 0.0 <= res["eval_accuracy"] <= 1.0
    assert r0["losses"] == r1["losses"] and r0["eval_accuracy"] == r1["eval_accuracy"]
    assert r0["bits_per_step"] == r1["bits_per_step"] == 32 * sum(
        p.numel() for p in exact_cifar10.build_model("small", "cpu").parameters()
    ) + 32


# ---- the entry point against the JAX run -------------------------------------


RUN_LAYOUTS = {"mono": {}, "bucket_chunks": {"bucket_bytes": 50_000, "comm_chunks": 3}}


@functools.lru_cache(maxsize=None)
def _jax_run(layout):
    """The JAX ``exact_cifar10.run`` on one CPU device from numpy weights;
    its final state is kept from the run's own training loop."""
    model = jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16)
    variables = to_numpy(random_flax_variables(model, (1, 32, 32, 3), seed=25))
    kept = {}
    train_loop = jax_exact_cifar10.train_loop

    def keep(step, state, *args, **kwargs):
        state, logger = train_loop(step, state, *args, **kwargs)
        kept.update(state=state, logger=logger, bits=step.bits_per_step)
        return state, logger

    jax_exact_cifar10.train_loop = keep
    try:
        cfg = JaxExperimentConfig(**CIFAR_CFG, **RUN_LAYOUTS[layout])
        jax_exact_cifar10.run(
            cfg, preset="small", mesh=make_mesh(devices=jax.devices()[:1]),
            pretrained_variables=variables, max_steps_per_epoch=2,
        )
    finally:
        jax_exact_cifar10.train_loop = train_loop
    return variables, kept


@pytest.mark.parametrize("layout", list(RUN_LAYOUTS))
def test_run_matches_jax_run(layout, monkeypatch):
    variables, jax_out = _jax_run(layout)
    kept = {}
    build = exact_cifar10.build

    def keep(*args, **kwargs):
        kept["model"], step, state = build(*args, **kwargs)
        return kept["model"], step, state

    monkeypatch.setattr(exact_cifar10, "build", keep)
    out = exact_cifar10.run(
        ExperimentConfig(**CIFAR_CFG, **RUN_LAYOUTS[layout]), preset="small", device="cpu", max_steps_per_epoch=2,
        pretrained_state_dict=resnet_state_dict_from_flax(variables),
    )
    assert out["steps"] == 2 and out["num_devices"] == 1
    assert out["bits_per_step"] == jax_out["bits"]  # the gradient and the loss, 32 bits
    np.testing.assert_allclose(out["losses"], [r.loss for r in jax_out["logger"].records], rtol=LOSS_TOL, atol=LOSS_TOL)
    want = resnet_state_dict_from_flax({"params": to_numpy(jax_out["state"].params)})
    got = dict(kept["model"].named_parameters())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), rtol=TOL, atol=TOL, err_msg=name)


def test_run_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="strategy"):
        exact_cifar10.run(strategy="zero", device="cpu")
    cfg = exact_cifar10.default_config()
    cfg.adaptive_comm = True  # set after construction, past the config's own check
    with pytest.raises(NotImplementedError, match="adaptive_comm"):
        exact_cifar10.run(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        ExperimentConfig(chaos_plan="plan.json")


def test_launcher_runs_exact_cifar10_with_buckets_and_chunks(capsys):
    args = [
        "exact_cifar10", "--device", "cpu", "--global-batch", "16", "--epochs", "1",
        "--max-steps-per-epoch", "2", "--bucket-bytes", "100000", "--comm-chunks", "3", "--json",
    ]
    out = launch.main(args)
    assert out["experiment"] == "exact_cifar10" and out["steps"] == 2 and np.isfinite(out["losses"]).all()
    model = exact_cifar10.build_model("small", "cpu")
    leaves = list(model.parameters())
    assert out["n_collectives"] == ExactReducer(bucket_bytes=100000, comm_chunks=3).n_collectives(leaves)
    assert out["n_collectives"] > 3
    assert out["bits_per_step"] == 32 * sum(p.numel() for p in leaves) + 32
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"experiment": "exact_cifar10"')


@pytest.mark.parametrize(
    "args,error",
    [
        (["exact_cifar10", "--strategy", "fsdp", "--comm-strategy", "ring"], ValueError),
        (["powersgd_cifar10", "--bucket-bytes", "1024"], ValueError),
        (["powersgd_imdb", "--comm-chunks", "2"], ValueError),
        (["imdb_baseline", "--comm-strategy", "ring"], ValueError),
        (["powersgd_cifar10", "--strategy", "fsdp"], ValueError),
    ],
    ids=["fsdp", "buckets_powersgd", "chunks_imdb", "ring_baseline", "strategy_powersgd"],
)
def test_launcher_refuses_flags_it_would_ignore(args, error):
    with pytest.raises(error):
        launch.main(args + ["--device", "cpu", "--max-steps-per-epoch", "1"])
