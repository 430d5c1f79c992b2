"""The port's fully-sharded data parallelism (``parallel/fsdp.py``) against
the JAX package's ``parallel/fsdp.py``, and its contracts.

- ``shard_params`` / ``unshard_params``: each leaf's shard shape and
  padding equal the JAX functions' leaf for leaf (the port shards the
  torch layout, the JAX package the flax one: the sizes depend only on the
  leaf's size), and the round trip is exact;
- the FSDP step on 2 and 4 Gloo ranks against the JAX step on 2 and 4 CPU
  devices, from one state (``fsdp_state_from_jax``), under ``sgd``,
  ``sgd_nesterov``, ``sgd_plain`` and ``"optax"`` (AdamW): losses 1e-5 and
  unsharded parameters 1e-4 after two steps (the frameworks sum the
  convolutions in other orders; ``test_torch_exact.py``'s classes), and
  each rank's shards ``ceil(size / world)`` long (the reference's memory
  test);
- bits and collectives by kind against the JAX step's ``bits_per_step``
  and ledger entries, for K in {None, 3, 7};
- against the port's DDP ``sgd`` step on the same ranks: losses 1e-5;
- chunked against monolithic bit for bit: on any values at 2 ranks (a sum
  of two floats does not depend on order), and at 4 ranks on dyadic
  values, where a sum over more ranks could round by where the algorithm
  cuts the buffer (the JAX package's own chunked test is red, so it is no
  oracle here);
- ``exact_cifar10.run(strategy="fsdp")`` at preset small on 2 ranks
  against the JAX run on 2 devices, the reference's five refusals before
  any rendezvous, and the launcher.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from network_distributed_pytorch_tpu.experiments import exact_cifar10 as jax_exact_cifar10
from network_distributed_pytorch_tpu.models import resnet18 as jax_resnet18
from network_distributed_pytorch_tpu.models.cnn import SmallCNN as JaxSmallCNN
from network_distributed_pytorch_tpu.parallel import make_mesh
from network_distributed_pytorch_tpu.parallel import fsdp as jax_fsdp
from network_distributed_pytorch_tpu.parallel.trainer import stateless_loss
from network_distributed_pytorch_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
from network_distributed_pytorch_tpu.utils.losses import cross_entropy_loss as jax_cross_entropy
from network_distributed_pytorch_tpu_torch import launch
from network_distributed_pytorch_tpu_torch.experiments import common, exact_cifar10
from network_distributed_pytorch_tpu_torch.models.cnn import SmallCNN
from network_distributed_pytorch_tpu_torch.models.import_weights import fsdp_state_from_jax, resnet_state_dict_from_flax
from network_distributed_pytorch_tpu_torch.parallel import fsdp
from torch_parity import random_flax_variables, to_numpy
from torch_worker import (  # few_torch_threads: autouse
    FSDP_HW,
    FSDP_WIDTH,
    exact_fsdp_rank,
    few_torch_threads,
    fsdp_bits_rank,
    fsdp_dyadic_rank,
    fsdp_train_rank,
    fsdp_vs_ddp_rank,
    numpy_batches,
    run_all,
    spawn,
)

TOL = 1e-4
LOSS_TOL = 1e-5
ALGORITHMS = ("sgd", "sgd_nesterov", "sgd_plain", "optax")
LR = {"sgd": 0.05, "sgd_nesterov": 0.05, "sgd_plain": 0.05, "optax": 1e-3}
CHUNKS = (3, 7)
WORLDS = (2, 4)
CIFAR_CFG = {"training_epochs": 1, "global_batch_size": 16, "learning_rate": 0.01}


def _batches(seed=50, steps=2):
    return numpy_batches(seed, steps, batch=8, hw=FSDP_HW)


def _jax_cnn_params():
    model = JaxSmallCNN(width=FSDP_WIDTH)
    params = to_numpy(random_flax_variables(model, (1, FSDP_HW, FSDP_HW, 3), seed=51, init_kwargs={}))["params"]

    def loss_fn(p, batch):
        x, y = batch
        return jax_cross_entropy(model.apply({"params": p}, x), y)

    return params, stateless_loss(loss_fn)


def _jax_step(world, algorithm="sgd", comm_chunks=None):
    params, loss_fn = _jax_cnn_params()
    return params, jax_fsdp.make_fsdp_train_step(
        loss_fn, params, LR[algorithm], 0.9, algorithm, mesh=make_mesh(devices=jax.devices()[:world]),
        donate_state=False, optimizer=optax.adamw(LR[algorithm]) if algorithm == "optax" else None,
        comm_chunks=comm_chunks,
    )


@functools.lru_cache(maxsize=None)
def _jax_run(world, algorithm):
    """Two JAX FSDP steps on ``world`` CPU devices: the initial state as
    plain numpy (an optax state as its list of leaves, which the spawned
    ranks can read without JAX), the losses and the unsharded parameters
    in the port's names and layouts."""
    params, step = _jax_step(world, algorithm)
    state = step.init_state(params)
    opt = to_numpy(state.opt_shards) if algorithm != "optax" else [
        np.asarray(x) for x in jax.tree_util.tree_leaves(state.opt_shards)
    ]
    init = types.SimpleNamespace(param_shards=to_numpy(state.param_shards), opt_shards=opt, model_state={})
    losses = []
    for x, y in _batches():
        state, loss = step(state, (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(loss))
    final = resnet_state_dict_from_flax({"params": to_numpy(step.unshard(state))})
    return init, losses, final


@functools.lru_cache(maxsize=None)
def _jax_exact_run():
    """The JAX ``exact_cifar10.run(strategy="fsdp")`` on two CPU devices
    from numpy weights: the weights and the run's losses and unsharded
    parameters, kept from its own training loop."""
    model = jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16)
    variables = to_numpy(random_flax_variables(model, (1, 32, 32, 3), seed=52))
    kept = {}
    train_loop = jax_exact_cifar10.train_loop

    def keep(step, state, *args, **kwargs):
        state, logger = train_loop(step, state, *args, **kwargs)
        kept.update(params=to_numpy(step.unshard(state)), logger=logger, bits=step.bits_per_step)
        return state, logger

    jax_exact_cifar10.train_loop = keep
    try:
        jax_exact_cifar10.run(
            JaxExperimentConfig(**CIFAR_CFG), preset="small", mesh=make_mesh(devices=jax.devices()[:2]),
            pretrained_variables=variables, max_steps_per_epoch=2, strategy="fsdp",
        )
    finally:
        jax_exact_cifar10.train_loop = train_loop
    return variables, kept


def _dyadic(world, steps=2, per_rank=3):
    rng = np.random.RandomState(53)
    xs = [rng.randint(-3, 4, (world * per_rank, 13)).astype(np.float32) for _ in range(steps)]
    cs = [rng.randint(-3, 4, (world * per_rank, 7)).astype(np.float32) for _ in range(steps)]
    return xs, cs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of 2 Gloo ranks and one of 4, every rank function of the
    module in each."""
    out = {}
    for world in WORLDS:
        calls = [(fsdp_train_rank, (_jax_run(world, a)[0], a, LR[a], _batches())) for a in ALGORITHMS]
        calls.append((fsdp_bits_rank, ((None,) + CHUNKS, _batches()[0])))
        if world == 2:
            variables, _ = _jax_exact_run()
            calls.append((fsdp_vs_ddp_rank, (_batches(), CHUNKS)))
            calls.append((exact_fsdp_rank, (CIFAR_CFG, resnet_state_dict_from_flax(variables), 2)))
        else:
            calls.append((fsdp_dyadic_rank, (CHUNKS,) + _dyadic(world)))
        results = spawn(run_all, world, tmp_path_factory.mktemp(f"fsdp{world}"), calls)
        out[world] = {
            "train": {a: [r[i] for r in results] for i, a in enumerate(ALGORITHMS)},
            "bits": [r[len(ALGORITHMS)] for r in results],
            "extra": [r[len(ALGORITHMS) + 1] for r in results],
            "exact": [r[len(ALGORITHMS) + 2] for r in results] if world == 2 else None,
        }
    return out


# ---- sharding, in one process ----------------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_shard_unshard_round_trip_matches_jax(world):
    """Every leaf's ``(world, chunk)`` shape and its zero padding equal the
    JAX function's on the same leaf (in its own layout), and unsharding
    gives the leaf back exactly."""
    params, _ = _jax_cnn_params()
    full = resnet_state_dict_from_flax({"params": params})
    got = fsdp.shard_params(full, world)
    assert list(got) == list(full)
    for k, v in full.items():
        jax_shard = np.asarray(jax_fsdp.shard_params({"leaf": _to_flax(v)}, world)["leaf"])
        assert tuple(got[k].shape) == jax_shard.shape == (world, -(-v.numel() // world)), k
        assert torch.count_nonzero(got[k].reshape(-1)[v.numel():]) == 0
        assert not np.any(jax_shard.reshape(-1)[v.numel():])
    back = fsdp.unshard_params(got, full)
    assert all(torch.equal(back[k], full[k]) for k in full)
    # the flat concatenation of the rows unshards the same way
    back = fsdp.unshard_params({k: v.reshape(-1) for k, v in got.items()}, full)
    assert all(torch.equal(back[k], full[k]) for k in full)


def test_fsdp_state_from_jax_carries_a_resnet_with_batchnorm():
    """The JAX FSDP state of the small ResNet-18 (shards of flax-layout
    leaves, per-worker BatchNorm statistics) becomes one port state a rank
    whose shards, joined, are the torch-layout parameters and momenta bit
    for bit, with each rank's own statistics."""
    world = 2
    variables = to_numpy(random_flax_variables(jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16),
                                               (1, 32, 32, 3), seed=54))
    stats = jax.tree_util.tree_map(lambda x: np.stack([x, x + 1]), variables["batch_stats"])
    momenta = jax.tree_util.tree_map(lambda x: x * 0.5, variables["params"])
    jax_state = types.SimpleNamespace(
        param_shards=to_numpy(jax_fsdp.shard_params(variables["params"], world)),
        opt_shards=to_numpy(jax_fsdp.shard_params(momenta, world)), model_state={"batch_stats": stats},
    )
    model = exact_cifar10.build_model("small", "cpu")
    states = fsdp_state_from_jax(jax_state, model, world)
    templates = dict(model.named_parameters())
    for field, tree in (("param_shards", variables["params"]), ("opt_shards", momenta)):
        joined = {k: torch.stack([getattr(st, field)[k] for st in states]) for k in templates}
        want = resnet_state_dict_from_flax({"params": tree})
        got = fsdp.unshard_params(joined, templates)
        assert all(torch.equal(got[k], want[k]) for k in templates), field
    for r, st in enumerate(states):
        want = resnet_state_dict_from_flax({"batch_stats": jax.tree_util.tree_map(lambda x: x[r], stats)})
        assert set(st.model_state) == {k for k, _ in model.named_buffers()}
        assert all(torch.equal(st.model_state[k], want[k]) for k in want)


def _to_flax(t):
    a = t.numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else (a.T if a.ndim == 2 else a)


def test_make_fsdp_train_step_refuses_bad_arguments():
    model = SmallCNN(width=FSDP_WIDTH, image_size=FSDP_HW, device="cpu")
    loss = common.image_classifier_loss()
    group = object()  # never used: each refusal comes before any collective
    with pytest.raises(ValueError, match="algorithm"):
        fsdp.make_fsdp_train_step(loss, model, 0.1, algorithm="ef_momentum", group=group)
    with pytest.raises(ValueError, match="optax"):
        fsdp.make_fsdp_train_step(loss, model, 0.1, algorithm="optax", group=group)
    with pytest.raises(ValueError, match="optax"):
        fsdp.make_fsdp_train_step(loss, model, 0.1, optimizer=torch.optim.SGD, group=group)
    with pytest.raises(ValueError, match="comm_chunks"):
        fsdp.make_fsdp_train_step(loss, model, 0.1, group=group, comm_chunks=0)
    with pytest.raises(ValueError, match="process group"):
        fsdp.make_fsdp_train_step(loss, model, 0.1)


# ---- the step against the JAX step, on 2 and 4 ranks ---------------------------------


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_step_matches_jax(ranks, world, algorithm):
    _, losses, final = _jax_run(world, algorithm)
    for res in ranks[world]["train"][algorithm]:
        np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_TOL, atol=LOSS_TOL)
        assert set(res["params"]) == set(final)
        for k, want in final.items():
            np.testing.assert_allclose(res["params"][k].numpy(), want.numpy(), rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_ceil_size_over_world(ranks, world):
    """The reference's memory test: every shard of every rank is
    ``ceil(size / world)`` long, so a rank holds about 1/world of the
    model."""
    sizes = {k: v.numel() for k, v in SmallCNN(width=FSDP_WIDTH, image_size=FSDP_HW, device="cpu").named_parameters()}
    for res in ranks[world]["train"]["sgd"]:
        assert res["shard_len"] == {k: -(-n // world) for k, n in sizes.items()}


@pytest.mark.parametrize("chunks", (None,) + CHUNKS, ids=["mono", "k3", "k7"])
@pytest.mark.parametrize("world", WORLDS)
def test_bits_by_kind_match_the_jax_ledger(ranks, world, chunks):
    """What a step put on the wire, by kind, is the JAX step's ledger entry
    by entry (payload and count) and sums to its ``bits_per_step``,
    whatever K."""
    _, step = _jax_step(world, comm_chunks=chunks)
    want_bits = {e.op: 8 * e.payload_bytes for e in step.ledger.entries}
    want_count = {e.op: e.count for e in step.ledger.entries}
    for res in ranks[world]["bits"]:
        got = res[chunks]
        records = got["records"]
        kinds = {kind for kind, _, _ in records}
        assert kinds == set(want_bits)
        for kind in kinds:
            assert 8 * sum(b for k, _, b in records if k == kind) == want_bits[kind], kind
            assert sum(1 for k, _, _ in records if k == kind) == want_count[kind], kind
        assert got["bits_by_kind"] == want_bits and got["collectives_by_kind"] == want_count
        assert got["bits_per_step"] == step.bits_per_step == sum(want_bits.values())
        assert all(ranks_ == tuple(range(world)) for _, ranks_, _ in records)


# ---- within the port ------------------------------------------------------------------


def test_fsdp_matches_ddp_on_two_ranks(ranks):
    for res in ranks[2]["extra"]:
        np.testing.assert_allclose(res[None]["losses"], res["ddp"]["losses"], rtol=LOSS_TOL, atol=LOSS_TOL)
        for k, want in res["ddp"]["params"].items():
            np.testing.assert_allclose(res[None]["params"][k].numpy(), want.numpy(), rtol=TOL, atol=TOL, err_msg=k)


def test_init_state_releases_the_model_parameters(ranks):
    """ZeRO-3: once the state exists, no rank holds a full parameter
    between steps; the step gathers them."""
    for res in ranks[2]["extra"]:
        assert all(n == 0 for n in res[None]["released"])


def test_eval_model_state_takes_the_mean_only(ranks):
    """The reference's ``reduce="first"`` (worker 0's statistics) is not
    ported: it raises rather than average."""
    assert all(res["first_refused"] for res in ranks[2]["extra"])


@pytest.mark.parametrize("chunks", CHUNKS)
def test_chunked_equals_monolithic_bitwise_at_two_ranks(ranks, chunks):
    for res in ranks[2]["extra"]:
        assert res[chunks]["losses"] == res[None]["losses"]
        for k, want in res[None]["params"].items():
            assert torch.equal(res[chunks]["params"][k], want), k


@pytest.mark.parametrize("chunks", CHUNKS)
def test_chunked_equals_monolithic_on_dyadic_values_at_four_ranks(ranks, chunks):
    """Integer gradients sum exactly in any order, so chunked and
    monolithic steps agree bit for bit with each other and with the numpy
    golden of two momentum steps."""
    xs, cs = _dyadic(4)
    w = np.arange(91.0, dtype=np.float32).reshape(7, 13) - 40
    b = np.arange(7.0, dtype=np.float32)
    mw, mb = np.zeros_like(w), np.zeros_like(b)
    for x, c in zip(xs, cs):  # the mean over 4 ranks of each rank's summed loss gradient
        gw, gb = (c.T @ x) * np.float32(0.25), c.sum(0) * np.float32(0.25)
        mw, mb = 0.5 * mw + gw, 0.5 * mb + gb
        w, b = w - 0.5 * mw, b - 0.5 * mb
    for res in ranks[4]["extra"]:
        for k, want in res[None].items():
            assert torch.equal(res[chunks][k], want), k
        assert np.array_equal(res[chunks]["weight"].numpy(), w) and np.array_equal(res[chunks]["bias"].numpy(), b)


# ---- the entry point and the launcher ---------------------------------------------------


def test_exact_cifar10_fsdp_matches_the_jax_run(ranks):
    _, jax_out = _jax_exact_run()
    want = resnet_state_dict_from_flax({"params": jax_out["params"]})
    for res in ranks[2]["exact"]:
        out = res["summary"]
        assert out["strategy"] == "fsdp" and out["num_devices"] == 2 and out["steps"] == 2
        np.testing.assert_allclose(out["losses"], [r.loss for r in jax_out["logger"].records], rtol=LOSS_TOL, atol=LOSS_TOL)
        for k, w in want.items():
            np.testing.assert_allclose(res["params"][k].numpy(), w.numpy(), rtol=TOL, atol=TOL, err_msg=k)
        # the recorder's bits are the JAX step's static count
        assert out["bits_per_step"] == jax_out["bits"]
        assert out["collectives"]["by_kind"]["all-gather"] == out["collectives"]["by_kind"]["reduce-scatter"] == len(want)
        assert 0.0 <= out["eval_accuracy"] <= 1.0
    r0, r1 = (res["summary"] for res in ranks[2]["exact"])
    assert r0["losses"] == r1["losses"] and r0["eval_accuracy"] == r1["eval_accuracy"]


def test_launcher_trains_fsdp_on_two_ranks(ranks):
    for res in ranks[2]["exact"]:
        out = res["launched"]
        assert out["experiment"] == "exact_cifar10" and out["strategy"] == "fsdp" and out["steps"] == 2
        assert np.isfinite(out["losses"]).all()
        leaves = list(exact_cifar10.build_model("small", "cpu").parameters())
        assert out["bits_per_step"] == 2 * sum(32 * 2 * -(-p.numel() // 2) for p in leaves) + 32
        assert out["collectives"]["by_kind"]["all-gather"] == sum(min(3, -(-p.numel() // 2)) for p in leaves)


def _no_rendezvous(*args, **kwargs):
    raise AssertionError("a refusal must come before the rendezvous")


@pytest.mark.parametrize(
    "field,value,match",
    [
        ("accum_steps", 2, "accum_steps"),
        ("max_grad_norm", 1.0, "max_grad_norm"),
        ("checkpoint_dir", "ckpt", "restore_checkpoint_sharded"),
        ("comm_strategy", "ring", "interleave"),
        ("adaptive_comm", True, "adaptive_comm requires strategy='ddp'"),
    ],
)
def test_run_refuses_what_the_reference_refuses_under_fsdp(monkeypatch, tmp_path, field, value, match):
    monkeypatch.setattr(common, "initialize_distributed", _no_rendezvous)
    cfg = exact_cifar10.default_config()
    kwargs = {}
    if field == "checkpoint_dir":
        kwargs["checkpoint_dir"] = str(tmp_path / value)
    else:
        setattr(cfg, field, value)  # set after construction, past the config's own checks
    with pytest.raises(ValueError, match=match):
        exact_cifar10.run(cfg, device="cpu", strategy="fsdp", **kwargs)


@pytest.mark.parametrize(
    "flags,match",
    [(["--checkpoint-dir", "ckpt"], "restore_checkpoint_sharded"), (["--comm-strategy", "ring"], "interleave")],
    ids=["checkpoint_dir", "comm_strategy"],
)
def test_launcher_refuses_fsdp_flags_before_the_rendezvous(monkeypatch, flags, match):
    monkeypatch.setattr(common, "initialize_distributed", _no_rendezvous)
    with pytest.raises(ValueError, match=match):
        launch.main(["exact_cifar10", "--device", "cpu", "--strategy", "fsdp"] + flags)
