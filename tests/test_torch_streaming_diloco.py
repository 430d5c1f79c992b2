"""The port's streaming DiLoCo (``make_streaming_diloco_train_fn``) against
the JAX package's, and its contracts.

Parity: two phases (K = 2, H = 4, exact outer reducer) of the tiny
SmallCNN on two Gloo ranks against the JAX phases on two CPU devices, from
the same weights and batches: each rank's parameters, the anchors, the
losses, the error memories, the outer momenta and the drift statistics, at
rtol = atol = 1e-5. The SmallCNN's leaves all differ in size, so the
greedy fragment assignment puts the same parameters in the same fragment
in either framework's leaf order (flax sorts by name, torch registers).
``_fragment_indices`` itself is held to JAX's on the same size lists.
"""

import jax
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.models.cnn import SmallCNN as JaxSmallCNN
from network_distributed_pytorch_tpu.parallel import make_mesh
from network_distributed_pytorch_tpu.parallel.localsgd import _fragment_indices as jax_fragment_indices
from network_distributed_pytorch_tpu.parallel.localsgd import drift_stats as jax_drift_stats
from network_distributed_pytorch_tpu.parallel.localsgd import (
    make_streaming_diloco_train_fn as jax_make_streaming,
)
from network_distributed_pytorch_tpu.parallel.trainer import stateless_loss
from network_distributed_pytorch_tpu.utils.losses import cross_entropy_loss
from network_distributed_pytorch_tpu_torch.models.cnn import SmallCNN
from network_distributed_pytorch_tpu_torch.models.import_weights import _flatten, resnet_state_dict_from_flax, torch_name
from network_distributed_pytorch_tpu_torch.parallel.localsgd import (
    _fragment_indices,
    make_diloco_train_fn,
    make_streaming_diloco_train_fn,
)
from torch_parity import random_flax_variables, to_numpy
from torch_worker import LinReg, few_torch_threads, mse_loss, spawn, streaming_rank  # few_torch_threads: autouse
from test_torch_localsgd import ROUNDS, _stacked

TOL = 1e-5
H, LR = 4, 0.05


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    model = JaxSmallCNN(width=4)
    params = random_flax_variables(model, (1, 8, 8, 3), seed=42, init_kwargs={})["params"]
    loss_fn = stateless_loss(lambda p, b: cross_entropy_loss(model.apply({"params": p}, b[0]), b[1]))
    mesh = make_mesh(devices=jax.devices()[:2])
    stream = jax_make_streaming(loss_fn, params, LR, num_fragments=2, sync_every=H, mesh=mesh)
    state = stream.init_state(params)
    jax_phases = []
    for batches in ROUNDS:
        state, losses = stream(state, _stacked(batches))
        jax_phases.append((state, np.asarray(losses)))
    sd = resnet_state_dict_from_flax({"params": to_numpy(params)})
    ranks = spawn(streaming_rank, 2, tmp_path_factory.mktemp("ranks"), sd, ROUNDS, LR, H)
    return {"jax": (stream, jax_phases, params), "ranks": ranks}


def _named(tree):
    return resnet_state_dict_from_flax({"params": to_numpy(tree)})


def _close(got, want, what, tol=TOL):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=tol, atol=tol, err_msg=f"{what} {k}")


def test_fragments_hold_the_same_parameters_as_jax(runs):
    stream, _, params = runs["jax"]
    jax_names = [torch_name(path) for path, _ in _flatten(params)]
    sizes = [int(np.asarray(v).size) for _, v in _flatten(params)]
    want = [sorted(jax_names[i] for i in idx) for idx in jax_fragment_indices(sizes, 2)]
    port_names = [n for n, _ in SmallCNN(width=4, image_size=8, device="cpu").named_parameters()]
    for res in runs["ranks"]:
        assert [sorted(port_names[i] for i in idx) for idx in res["fragments"]] == want
        assert res["bits_per_phase"] == stream.bits_per_phase


def test_two_phases_match_jax(runs):
    stream, jax_phases, _ = runs["jax"]
    for w, res in enumerate(runs["ranks"]):
        for (jstate, jlosses), got in zip(jax_phases, res["phases"]):
            _close(got["params"], _named(jax.tree_util.tree_map(lambda a: np.asarray(a)[w], jstate.params)), "params")
            _close(got["anchors"], _named(jstate.anchors), "anchors")
            np.testing.assert_allclose(got["losses"].numpy(), jlosses, rtol=TOL, atol=TOL)
        jstate = jax_phases[-1][0]
        _close(res["memories"], _named(jax.tree_util.tree_map(lambda a: np.asarray(a)[w], jstate.memories)), "memories")
        _close(res["outer_momenta"], _named(jstate.outer_momenta), "outer momenta")
        _close(res["eval_params"], _named(stream.eval_params(jstate)), "eval params")
        want = jax_drift_stats(jstate)
        for key in ("replica_drift", "anchor_drift"):
            np.testing.assert_allclose(res["drift"][key], float(want[key]), rtol=1e-4, atol=1e-7)
        assert [p["phase"] for p in res["phases"]] == [1, 2]


def test_anchors_are_bitwise_equal_across_ranks(runs):
    """The anchors (the synced values) are the same on both ranks after each
    phase; the parameters of the fragment not yet synced differ."""
    a, b = runs["ranks"]
    for pa, pb in zip(a["phases"], b["phases"]):
        for k in pa["anchors"]:
            assert torch.equal(pa["anchors"][k], pb["anchors"][k]), k
    first = a["fragments"][0]
    names = list(a["phases"][0]["params"])
    synced = {names[i] for i in first}
    for k in names:
        same = torch.equal(a["phases"][0]["params"][k], b["phases"][0]["params"][k])
        assert same == (k in synced), k


def test_phase_bits_equal_recorded_bits(runs):
    for res in runs["ranks"]:
        for k, phase in enumerate(res["phases"]):
            assert phase["recorded_bits"] == res["bits_per_phase"][k % 2]


def test_k1_equals_plain_diloco_bitwise(runs):
    for res in runs["ranks"]:
        for r in res["k1"]:
            (ls, ps), (lp, pp) = r["stream"], r["plain"]
            assert torch.equal(ls, lp)
            for k in pp:
                assert torch.equal(ps[k], pp[k]), k


@pytest.mark.parametrize(
    "sizes,k",
    [([2048, 256, 256, 256, 256, 256, 256, 256, 256], 2), ([5, 5, 5, 3, 3], 3), ([1, 7, 7, 2, 9, 4, 4], 4), ([3], 2)],
)
def test_fragment_indices_equal_jax(sizes, k):
    assert _fragment_indices(sizes, k) == jax_fragment_indices(sizes, k)


def test_peak_bits_fall_k_fold():
    """Four fragments of a model of sixteen equal leaves, one process (no
    loss all-reduces): each phase syncs a quarter of the parameters, so its
    peak bits are a quarter of plain DiLoCo's round; the time average
    matches plain DiLoCo at the same period."""
    model = torch.nn.Sequential(*[torch.nn.Linear(8, 8, bias=False) for _ in range(16)])
    stream = make_streaming_diloco_train_fn(mse_loss, model, 0.05, num_fragments=4, sync_every=4)
    plain = make_diloco_train_fn(mse_loss, model, inner_learning_rate=0.05, sync_every=4)
    assert stream.peak_sync_bits * 4 == plain.bits_per_round
    assert stream.bits_per_step * stream.sync_every * stream.num_fragments == sum(stream.bits_per_phase)


def test_phase_counter_resumes_the_fragment_schedule():
    """The phase lives in the state: a state whose counter reads 1 syncs the
    second fragment next (only its anchors move)."""
    x, y = np.random.RandomState(0).randn(8, 16).astype(np.float32), np.zeros((8, 4), np.float32)
    batch = (torch.from_numpy(x), torch.from_numpy(y + 1.0))
    stream = make_streaming_diloco_train_fn(mse_loss, LinReg(), 0.05, num_fragments=2, sync_every=2)
    state = stream.init_state()
    state.phase = 1
    before = {k: v.clone() for k, v in state.anchors.items()}
    state, _ = stream(state, [batch] * 2)
    moved = [k for k in before if not torch.equal(before[k], state.anchors[k])]
    assert moved == [list(state.params)[i] for i in stream.fragments[1]] and state.phase == 2
