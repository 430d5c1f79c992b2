"""The port's local SGD and DiLoCo (``parallel/localsgd.py``) against the
JAX package's compiled rounds, and their contracts.

Parity: two rounds of H = 4 on a tiny SmallCNN (width 4, 8x8 images), two
Gloo ranks against the JAX rounds on two CPU devices, from the same weights
and batches, with an exact outer reducer and with PowerSGD (rank 2, the
JAX reducer's Q carried over by name): parameters, losses, momenta, error
memories and BatchNorm-free buffers at rtol = atol = 1e-5 (each framework
sums the convolutions in its own order, and eight SGD steps carry it).

The rest is held within the port, on two ranks unless a test says
otherwise: local SGD at H = 1 equals exact DDP (the JAX test's tolerances);
DiLoCo's identity outer step equals local SGD; the outer Nesterov step
equals a numpy golden (one process); a padded round equals the shorter
round bit for bit, all-ones weights equal none; the replicated state is
bitwise equal on both ranks after each round; an AdamW inner trains; and
the collectives recorded in a round carry ``bits_per_round``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.models.cnn import SmallCNN as JaxSmallCNN
from network_distributed_pytorch_tpu.parallel import make_mesh
from network_distributed_pytorch_tpu.parallel.localsgd import make_diloco_train_fn as jax_make_diloco
from network_distributed_pytorch_tpu.parallel.localsgd import make_local_sgd_train_fn as jax_make_local_sgd
from network_distributed_pytorch_tpu.parallel.reducers import PowerSGDReducer as JaxPowerSGD
from network_distributed_pytorch_tpu.parallel.trainer import stateless_loss
from network_distributed_pytorch_tpu.utils.losses import cross_entropy_loss
from network_distributed_pytorch_tpu_torch.models.cnn import SmallCNN
from network_distributed_pytorch_tpu_torch.models.import_weights import (
    powersgd_state_from_jax,
    resnet_state_dict_from_flax,
)
from network_distributed_pytorch_tpu_torch.parallel.localsgd import make_diloco_train_fn
from network_distributed_pytorch_tpu_torch.parallel.reducers import PowerSGDReducer
from network_distributed_pytorch_tpu_torch.parallel.trainer import LOSS_SYNC_BITS
from torch_parity import random_flax_variables, to_numpy
from torch_worker import (  # few_torch_threads: autouse
    LinReg,
    adamw_inner_rank,
    few_torch_threads,
    h1_local_sgd_vs_ddp_rank,
    identity_outer_rank,
    mse_loss,
    padded_round_rank,
    round_parity_rank,
    run_all,
    spawn,
)

TOL = 1e-5
H, LR = 4, 0.05


def _rounds():
    rng = np.random.RandomState(40)
    return [
        [
            (rng.randn(16, 8, 8, 3).astype(np.float32), rng.randint(0, 10, size=16).astype(np.int32))
            for _ in range(H)
        ]
        for _ in range(2)
    ]


ROUNDS = _rounds()


def _jax_setup():
    model = JaxSmallCNN(width=4)
    params = random_flax_variables(model, (1, 8, 8, 3), seed=41, init_kwargs={})["params"]
    loss_fn = stateless_loss(lambda p, b: cross_entropy_loss(model.apply({"params": p}, b[0]), b[1]))
    return params, loss_fn


def _stacked(batches):
    return tuple(jnp.asarray(np.stack([b[i] for b in batches])) for i in range(2))


def _jax_runs():
    """The JAX package's local SGD and DiLoCo rounds on two CPU devices:
    the state after each round and the losses, by kind."""
    params, loss_fn = _jax_setup()
    mesh = make_mesh(devices=jax.devices()[:2])
    psgd = JaxPowerSGD(random_seed=1, compression_rank=2, matricize="last")
    fns = {
        "local_sgd": jax_make_local_sgd(loss_fn, params, LR, 0.9, sync_every=H, mesh=mesh, donate_state=False),
        "diloco_exact": jax_make_diloco(
            loss_fn, params, inner_learning_rate=LR, sync_every=H, mesh=mesh, donate_state=False
        ),
        "diloco_powersgd": jax_make_diloco(
            loss_fn, params, inner_learning_rate=LR, sync_every=H, reducer=psgd, mesh=mesh, donate_state=False
        ),
    }
    out = {}
    for kind, fn in fns.items():
        state = fn.init_state(params)
        rounds = []
        for batches in ROUNDS:
            state, losses = fn(state, _stacked(batches))
            rounds.append((state, np.asarray(losses)))
        out[kind] = (fn, rounds)
    q0 = np.asarray(psgd.init(params).q_memory)
    return params, q0, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX rounds, and one spawn of two Gloo ranks for every two-rank
    check of this module."""
    params, q0, jax_out = _jax_runs()
    model = SmallCNN(width=4, image_size=8, device="cpu")
    sd = resnet_state_dict_from_flax({"params": to_numpy(params)})
    q_port = powersgd_state_from_jax(
        q0, params, PowerSGDReducer(random_seed=1, compression_rank=2, matricize="last"), model
    ).q_memory
    calls = [
        (round_parity_rank, (sd, q_port, ROUNDS, LR)),
        (h1_local_sgd_vs_ddp_rank, (10,)),
        (identity_outer_rank, (3, 4)),
        (padded_round_rank, ()),
        (adamw_inner_rank, (12, 4)),
    ]
    ranks = spawn(run_all, 2, tmp_path_factory.mktemp("ranks"), calls)
    names = ["parity", "h1", "identity", "padded", "adamw"]
    return {"jax": jax_out, "params": params, **{n: [r[i] for r in ranks] for i, n in enumerate(names)}}


def _named(tree):
    return resnet_state_dict_from_flax({"params": to_numpy(tree)})


def _close(got, want, what, tol=TOL):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=tol, atol=tol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("kind", ["local_sgd", "diloco_exact", "diloco_powersgd"])
def test_rounds_match_jax(runs, kind):
    """Two rounds of H = 4 on two ranks against the JAX package's compiled
    rounds on two devices: the parameters after each round, the losses, and
    each rank's per-worker state (momenta, error memories)."""
    fn, jax_rounds = runs["jax"][kind]
    for w, res in enumerate(r[kind] for r in runs["parity"]):
        assert res["bits_per_round"] == fn.bits_per_round
        for (jstate, jlosses), got in zip(jax_rounds, res["rounds"]):
            params = fn.eval_params(jstate)
            _close(got["params"], _named(params), f"{kind} params")
            np.testing.assert_allclose(got["losses"].numpy(), jlosses, rtol=TOL, atol=TOL)
        jstate = jax_rounds[-1][0]
        worker = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a)[w], tree)  # noqa: E731
        if kind == "local_sgd":
            _close(res["momenta"], _named(worker(jstate.momenta)), "momenta")
        else:
            _close(res["inner_momenta"], _named(worker(jstate.inner_opt)), "inner momenta")
            _close(res["memories"], _named(worker(jstate.memories)), "memories")
            _close(res["outer_momenta"], _named(jstate.outer_momenta), "outer momenta")
        if kind == "diloco_powersgd":
            # the error memory holds what rank 2 left out of the outer delta
            assert max(float(m.abs().max()) for m in res["memories"].values()) > 0


@pytest.mark.parametrize("kind", ["local_sgd", "diloco_exact", "diloco_powersgd"])
def test_replicated_state_is_bitwise_equal_across_ranks(runs, kind):
    """After every round both ranks hold the same parameters bit for bit
    (and DiLoCo the same outer momenta and Q); the per-rank state differs."""
    a, b = (r[kind] for r in runs["parity"])
    for ra, rb in zip(a["rounds"], b["rounds"]):
        for k in ra["params"]:
            assert torch.equal(ra["params"][k], rb["params"][k]), k
        assert torch.equal(ra["losses"], rb["losses"])
    if kind != "local_sgd":
        for k in a["outer_momenta"]:
            assert torch.equal(a["outer_momenta"][k], b["outer_momenta"][k]), k
        assert any(not torch.equal(a["memories"][k], b["memories"][k]) for k in a["memories"]) or kind == "diloco_exact"
    if kind == "diloco_powersgd":
        assert torch.equal(a["q_memory"], b["q_memory"])


@pytest.mark.parametrize("kind", ["local_sgd", "diloco_exact", "diloco_powersgd"])
def test_recorded_bits_equal_bits_per_round(runs, kind):
    """The round's collectives, as the recorder saw them, carry exactly
    ``bits_per_round``: H loss all-reduces and the sync."""
    for res in (r[kind] for r in runs["parity"]):
        for rnd in res["rounds"]:
            assert rnd["recorded_bits"] == res["bits_per_round"]
            assert rnd["collectives"] == H + (1 if kind != "diloco_powersgd" else 3)


def test_h1_plain_local_sgd_equals_exact_ddp(runs):
    for res in runs["h1"]:
        (llosses, lparams), (dlosses, dparams) = res["local"], res["ddp"]
        np.testing.assert_allclose(llosses, dlosses, rtol=1e-6)
        for k in dparams:
            np.testing.assert_allclose(lparams[k].numpy(), dparams[k].numpy(), rtol=1e-5, atol=1e-7)


def test_identity_outer_step_equals_local_sgd(runs):
    """Outer lr 1, no outer momentum, exact reducer: theta_0 - mean(theta_0
    - theta_w) = mean(theta_w), round for round."""
    for res in runs["identity"]:
        for (dl, dp), (ll, lp) in zip(res["diloco"], res["local"]):
            np.testing.assert_allclose(dl.numpy(), ll.numpy(), rtol=1e-6)
            for k in lp:
                np.testing.assert_allclose(dp[k].numpy(), lp[k].numpy(), rtol=1e-5, atol=1e-7)


def test_padded_partial_round_equals_shorter_round_bitwise(runs):
    """A round of 4 slots fed 3 batches and a pad of weight 0 (zeros or
    NaN) lands on the parameters of a round of 3, bit for bit; the pad's
    loss is 0 and its loss all-reduce still runs (the recorded bits are the
    round's); all-ones weights equal no weights bit for bit."""
    for res in runs["padded"]:
        short = res["short"]
        for pad in ("zero_pad", "nan_pad"):
            for k in short["params"]:
                assert torch.equal(res[pad]["params"][k], short["params"][k]), (pad, k)
                assert torch.equal(res[pad]["momenta"][k], short["momenta"][k]), (pad, k)
            assert torch.equal(res[pad]["losses"][:3], short["losses"])
            assert float(res[pad]["losses"][3]) == 0.0
            assert res[pad]["recorded_bits"] == res[pad]["bits_per_round"]
        for k in res["none"]["params"]:
            assert torch.equal(res["ones"]["params"][k], res["none"]["params"][k])
    assert res["zero_pad"]["bits_per_round"] == res["short"]["bits_per_round"] + LOSS_SYNC_BITS


def test_adamw_inner_trains_and_keeps_its_state(runs):
    """The paper's recipe, a torch AdamW inner and a Nesterov outer step:
    the loss falls, each rank's AdamW has taken every inner step, and the
    parameters are the same on both ranks."""
    for res in runs["adamw"]:
        first, last = float(res["losses"][0][0]), float(res["losses"][-1][-1])
        assert last < 0.5 * first, (first, last)
        assert res["adam_steps"] == [12 * 4, 12 * 4]
    a, b = (r["params"] for r in runs["adamw"])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_outer_nesterov_matches_numpy_golden():
    """One process, four rounds of three plain-SGD inner steps against a
    literal numpy replica of the round: delta = theta_0 - theta_H,
    m <- mu m + delta, theta <- theta_0 - gamma (delta + mu m)."""
    rng = np.random.RandomState(3)
    w_true = rng.randn(16, 4).astype(np.float32)
    x = rng.randn(8, 16).astype(np.float32)
    y = x @ w_true
    h, gamma, mu, ilr = 3, 0.7, 0.9, 0.05
    fn = make_diloco_train_fn(
        mse_loss, LinReg(), inner_learning_rate=ilr, outer_learning_rate=gamma, outer_momentum=mu,
        outer_nesterov=True, sync_every=h, inner_algorithm="sgd_plain",
    )
    state = fn.init_state()
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    w, b = np.zeros((16, 4), np.float32), np.zeros((4,), np.float32)
    m_w, m_b = np.zeros_like(w), np.zeros_like(b)
    for _ in range(4):
        state, _ = fn(state, [batch] * h)
        w0, b0 = w.copy(), b.copy()
        for _ in range(h):
            r = x @ w + b - y
            w, b = w - ilr * (2.0 * x.T @ r / r.size), b - ilr * (2.0 * r.sum(0) / r.size)
        dw, db = w0 - w, b0 - b
        m_w, m_b = mu * m_w + dw, mu * m_b + db
        w, b = w0 - gamma * (dw + mu * m_w), b0 - gamma * (db + mu * m_b)
    np.testing.assert_allclose(state.params["w"].detach().numpy(), w, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(state.params["b"].detach().numpy(), b, rtol=1e-4, atol=1e-6)


def test_inner_learning_rate_contract():
    """An SGD inner needs a rate; an optimizer's own rate is not given twice."""
    with pytest.raises(ValueError, match="needs inner_learning_rate"):
        make_diloco_train_fn(mse_loss, LinReg())
    with pytest.raises(ValueError, match="unused"):
        make_diloco_train_fn(
            mse_loss, LinReg(), inner_learning_rate=0.1, inner_algorithm="optax",
            inner_optimizer=lambda ps: torch.optim.AdamW(ps),
        )
    with pytest.raises(ValueError):
        make_diloco_train_fn(mse_loss, LinReg(), inner_learning_rate=0.1, sync_every=0)
