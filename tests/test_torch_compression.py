"""The port's gather-based compressors (TopK, SignSGD, QSGD) against the JAX
package's, on the same numpy inputs: on one process, and on two Gloo ranks
against the JAX reducer under ``shard_map`` on two CPU devices.

Both sides get the same leaves in the same order (the compressors work on
one flat buffer, so the layout of a leaf does not matter, only the order).
The payloads each side sends are captured at its ``all_gather``:

- TopK: the kept index sets equal, the values bitwise;
- SignSGD: the uint8 bitmap bitwise (little-endian, -0.0 counted positive);
- QSGD: the int8 levels bitwise, with deterministic rounding and with the
  stochastic rounding fed the noise of the JAX package's key schedule.

Tolerance: rtol = atol = 1e-6 for the scales, ``out`` and the error
memories (the frameworks sum a leaf's mean or max and the workers' scaled
contributions in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from network_distributed_pytorch_tpu.models import resnet18 as jax_resnet18
from network_distributed_pytorch_tpu.parallel import DATA_AXIS, make_mesh
from network_distributed_pytorch_tpu.parallel import compression as jax_compression
from network_distributed_pytorch_tpu_torch.models.resnet import resnet18
from network_distributed_pytorch_tpu_torch.parallel import compression
from network_distributed_pytorch_tpu_torch.parallel.comm import record_collectives
from torch_worker import (  # few_torch_threads: autouse
    bypass_rank,
    compressor_rank,
    compressor_train_rank,
    few_torch_threads,
    make_compressor,
    run_all,
    spawn,
)

TOL = 1e-6
SHAPES = [(3, 3, 2, 4), (4,), (24, 10), (10,), (5,)]
NAMES = ["topk", "signsgd", "qsgd", "qsgd_stochastic"]
JAX_REDUCERS = {
    "topk": lambda: jax_compression.TopKReducer(k_fraction=0.1),
    "signsgd": lambda: jax_compression.SignSGDReducer(),
    "qsgd": lambda: jax_compression.QSGDReducer(random_seed=3, stochastic=False),
    "qsgd_stochastic": lambda: jax_compression.QSGDReducer(random_seed=3, stochastic=True),
}


def sends(seed):
    rng = np.random.RandomState(seed)
    leaves = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    leaves[1][0], leaves[1][1] = -0.0, 0.0  # the bitmap's sign of zero
    return leaves


def jax_noise(n: int, worker=None):
    """The uniform noise the JAX QSGD reducer draws at its first step
    (``random_seed=3``), folded with the worker's index on a mesh."""
    _, sub = jax.random.split(jax.random.PRNGKey(3))
    if worker is not None:
        sub = jax.random.fold_in(sub, worker)
    return np.array(jax.random.uniform(sub, (n,)))


def jax_one_process(name, leaves):
    """The JAX reducer on one process: its result and the payloads it gave
    ``all_gather``."""
    sent = []
    inner = jax_compression.all_gather
    jax_compression.all_gather = lambda x, axis: (sent.append(np.asarray(x)), inner(x, axis))[1]
    try:
        reducer = JAX_REDUCERS[name]()
        jl = [jnp.asarray(a) for a in leaves]
        _, out, mem, bits = reducer.reduce(reducer.init(jl), jl, None)
    finally:
        jax_compression.all_gather = inner
    return [np.asarray(o) for o in out], [np.asarray(m) for m in mem], bits, sent


def jax_two_workers(name, per_worker):
    """The JAX reducer under ``shard_map`` on two CPU devices: ``out`` (the
    same on both) and each worker's error memory."""
    mesh = make_mesh(devices=jax.devices()[:2])
    reducer = JAX_REDUCERS[name]()
    n = len(SHAPES)
    state = reducer.init([jnp.asarray(a) for a in per_worker[0]])

    def f(*send):
        _, out, mem, _ = reducer.reduce(state, [s[0] for s in send], DATA_AXIS)
        return [o[None] for o in out], [m[None] for m in mem]

    stacked = [jnp.stack([jnp.asarray(w[i]) for w in per_worker]) for i in range(n)]
    out, mem = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(DATA_AXIS),) * n, out_specs=([P(DATA_AXIS)] * n, [P(DATA_AXIS)] * n),
    ))(*stacked)
    return [np.asarray(o) for o in out], [np.asarray(m) for m in mem]


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def check_payloads(name, port_sent, jax_sent):
    """The compressed payloads one worker sent, port against JAX."""
    port_sent = [t.numpy() for t in port_sent]
    assert len(port_sent) == len(jax_sent) == 2
    if name == "topk":
        (p_vals, p_idx), (j_vals, j_idx) = port_sent, jax_sent
        assert p_idx.dtype == np.int32 and p_vals.dtype == np.float32
        assert set(p_idx.tolist()) == set(j_idx.tolist())
        by_index = dict(zip(j_idx.tolist(), j_vals.tolist()))
        assert np.array_equal(p_vals, np.array([by_index[i] for i in p_idx.tolist()], np.float32))
    else:
        (p_payload, p_scales), (j_payload, j_scales) = port_sent, jax_sent
        assert p_payload.dtype == j_payload.dtype == (np.uint8 if name == "signsgd" else np.int8)
        assert np.array_equal(p_payload, j_payload)
        close(p_scales, j_scales)


def port_one_process(name, leaves, noises=None):
    return compressor_rank(0, 1, None, name, [[torch.from_numpy(a) for a in leaves]], noises)


@pytest.mark.parametrize("name", NAMES)
def test_one_process_matches_jax(name):
    leaves = sends(1)
    n = sum(a.size for a in leaves)
    noises = [torch.from_numpy(jax_noise(n))] if name == "qsgd_stochastic" else None
    port = port_one_process(name, leaves, noises)
    j_out, j_mem, j_bits, j_sent = jax_one_process(name, leaves)
    check_payloads(name, port["sent"], j_sent)
    assert port["bits"] == j_bits == port["bits_per_step"]
    for o, jo in zip(port["out"], j_out):
        close(o, jo)
    for m, jm in zip(port["mem"], j_mem):
        close(m, jm)
    assert port["records"] == []  # one process: nothing on the wire


def test_signsgd_bitmap_is_little_endian():
    positive = torch.tensor([True, False, False, True, False, False, False, False, True, True])
    bitmap = compression.pack_bits(positive)
    assert bitmap.tolist() == [0b00001001, 0b00000011]
    signs = compression.unpack_signs(bitmap, 10)
    assert signs.dtype == torch.int8 and signs.tolist() == [1 if p else -1 for p in positive.tolist()]
    jax_bitmap = jax_compression.SignSGDReducer._pack_bits(jnp.asarray(positive.numpy()))
    assert np.array_equal(np.asarray(jax_bitmap), bitmap.numpy())


def test_quantize_rounds_half_to_even_and_clips():
    levels = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 200.0, -200.0, 3.2])
    assert compression.quantize(levels, None).tolist() == [0, 2, 2, 0, -2, 127, -127, 3]
    noise = torch.tensor([0.5, 0.4, 0.6, 0.0, 0.99, 0.0, 0.0, 0.9])
    assert compression.quantize(levels, noise).tolist() == [1, 1, 3, -1, -1, 127, -127, 4]


def test_qsgd_stochastic_is_unbiased():
    """E[dequantized] = send, over independent roundings (the JAX package's
    test, 200 seeds, 3 standard errors)."""
    send = [torch.from_numpy(np.random.RandomState(1).randn(64).astype(np.float32))]
    outs = []
    for seed in range(200):
        reducer = compression.QSGDReducer(random_seed=seed, stochastic=True)
        _, out, _, _ = reducer.reduce(reducer.init(send), send, None)
        outs.append(out[0].numpy())
    scale = np.abs(send[0].numpy()).max() / 127.0
    np.testing.assert_allclose(np.mean(outs, axis=0), send[0].numpy(), atol=3 * scale / np.sqrt(200))


def test_qsgd_noise_differs_by_rank_and_step():
    reducer = compression.QSGDReducer(random_seed=5)
    state = reducer.init([])
    a, b = reducer.noise(state, 16, "cpu", 0), reducer.noise(state, 16, "cpu", 1)
    c = reducer.noise(state._replace(step=1), 16, "cpu", 0)
    assert not torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, reducer.noise(state, 16, "cpu", 0))
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0


@pytest.mark.parametrize("n_workers", [1, 4])
@pytest.mark.parametrize("name", ["topk", "signsgd", "qsgd"])
def test_bits_per_step_match_jax_on_resnet18(name, n_workers):
    """The small ResNet-18's shapes give the JAX reducer's bits, W times a
    worker's contribution."""
    model = resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device="cpu")
    jax_params = jax.eval_shape(
        lambda: jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=True
        )
    )["params"]
    port = make_compressor(name).bits_per_step(list(model.parameters()), n_workers)
    assert port == JAX_REDUCERS[name]().bits_per_step(jax_params, n_workers=n_workers) > 0


TRAIN_BATCH = (
    np.random.RandomState(21).randn(16, 8, 8, 3).astype(np.float32),
    np.random.RandomState(22).randint(0, 10, size=16).astype(np.int32),
)
TRAIN_STEPS = 25


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two Gloo ranks for every two-rank check of this module."""
    per_worker = [sends(10 + w) for w in range(2)]
    n = sum(a.size for a in per_worker[0])
    noises = [torch.from_numpy(jax_noise(n, w)) for w in range(2)]
    per_rank = [[torch.from_numpy(a) for a in leaves] for leaves in per_worker]
    calls = [(compressor_rank, (name, per_rank, noises)) for name in NAMES]
    calls += [(compressor_train_rank, (name, TRAIN_BATCH, TRAIN_STEPS)) for name in ("topk", "signsgd", "qsgd")]
    calls.append((bypass_rank, (per_rank, TRAIN_BATCH)))
    ranks = spawn(run_all, 2, tmp_path_factory.mktemp("ranks"), calls)
    n_reduce = len(NAMES)
    return {
        "per_worker": per_worker,
        "reduce": {name: [r[i] for r in ranks] for i, name in enumerate(NAMES)},
        "train": {name: [r[n_reduce + i] for r in ranks] for i, name in enumerate(("topk", "signsgd", "qsgd"))},
        "bypass": [r[-1] for r in ranks],
    }


@pytest.mark.parametrize("name", NAMES)
def test_two_ranks_match_jax(two_ranks, name):
    """Two Gloo ranks against the JAX reducer on two CPU devices: ``out``
    bitwise equal on both ranks and within 1e-6 of JAX's; each rank's
    memory within 1e-6 of its JAX worker's; each rank's payload as the JAX
    reducer makes it from that worker's send (QSGD's noise folded with the
    worker's index); the bits W times a contribution, as recorded."""
    per_worker = two_ranks["per_worker"]
    ranks = two_ranks["reduce"][name]
    j_out, j_mem = jax_two_workers(name, per_worker)
    n = sum(a.size for a in per_worker[0])
    for w, res in enumerate(ranks):
        for o, o0 in zip(res["out"], ranks[0]["out"]):
            assert torch.equal(o, o0)
        for i, o in enumerate(res["out"]):
            close(o, j_out[i][w])
        for i, m in enumerate(res["mem"]):
            close(m, j_mem[i][w])
        if name == "qsgd_stochastic":
            # the JAX payload of this worker's send and noise: one process
            # with the folded noise fed through the port's quantizer
            leaves = per_worker[w]
            flat = np.concatenate([a.reshape(-1) for a in leaves])
            scales = np.array([np.abs(a).max() / np.float32(127.0) for a in leaves], np.float32)
            inv = np.concatenate([np.full(a.size, 1.0, np.float32) / s for a, s in zip(leaves, scales)])
            levels = jnp.asarray(flat) * jnp.asarray(inv)
            want = np.asarray(jnp.clip(jnp.floor(levels + jnp.asarray(jax_noise(n, w))), -127, 127).astype(jnp.int8))
            assert np.array_equal(res["sent"][0].numpy(), want)
        else:
            check_payloads(name, res["sent"], jax_one_process(name, per_worker[w])[3])
        assert res["bits"] == res["bits_per_step"] == 8 * sum(r[2] for r in res["records"])
        assert [(kind, ranks) for kind, ranks, _ in res["records"]] == [("all-gather", (0, 1))] * 2


@pytest.mark.parametrize("name", ["topk", "signsgd", "qsgd"])
def test_compressor_trains_tiny_cnn_under_ef_momentum(two_ranks, name):
    """25 ef_momentum steps of a tiny CNN on a fixed batch over two ranks:
    finite losses, the same on both ranks, falling; each step's recorded
    collectives (the gathers and the loss all-reduce) carry its bits."""
    ranks = two_ranks["train"][name]
    losses = ranks[0]["losses"]
    assert ranks[1]["losses"] == losses
    assert all(np.isfinite(losses)) and losses[-1] < 0.8 * losses[0], losses
    assert np.mean(losses[-5:]) < np.mean(losses[-10:-5]) < np.mean(losses[:5]), losses
    reducer = make_compressor(name)
    model_bits = ranks[0]["bits_per_step"] - 32
    assert model_bits == reducer.bits_per_step([torch.zeros(s) for s in _small_cnn_shapes()], 2)
    assert ranks[0]["recorded_bits"] == ranks[0]["bits_per_step"]


def _small_cnn_shapes():
    from network_distributed_pytorch_tpu_torch.models.cnn import SmallCNN

    return [tuple(p.shape) for p in SmallCNN(width=4, image_size=8, device="cpu").parameters()]


def test_no_collective_bypasses_the_recorder(two_ranks):
    """Every ``torch.distributed`` collective that each reducer and a
    training step issue is one that the recorder saw."""
    for res in two_ranks["bypass"]:
        for name, (issued, recorded) in res.items():
            assert issued == recorded > 0, (name, issued, recorded)


def test_recorder_costs_nothing_without_a_group():
    with record_collectives() as records:
        reducer = compression.TopKReducer(0.5)
        leaves = [torch.ones(4)]
        reducer.reduce(reducer.init(leaves), leaves, None)
    assert records == []
