"""The PyTorch port's PowerSGD reducer against the NumPy oracle of the
reference math and against the JAX package's reducer, on the same matrices
with the same injected Q, on one process and on two Gloo ranks.

The leaves are made in the JAX package's layout (HWIO convs, (in, out)
dense kernels); the port gets the same arrays in torch layout (OIHW,
(out, in)) and ``matricize="last"`` must build the same matrices.

Tolerance: fp32, rtol = atol = 1e-5 (the frameworks and numpy sum the
matmuls in different orders; a 3-step warm-start chain carries each step's
rounding into the next Q) unless a case says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from network_distributed_pytorch_tpu.parallel import DATA_AXIS, make_mesh
from network_distributed_pytorch_tpu.parallel.reducers import PowerSGDReducer as JaxPowerSGD
from network_distributed_pytorch_tpu.parallel.reducers import PowerSGDState as JaxState
from network_distributed_pytorch_tpu.models import resnet18 as jax_resnet18
from network_distributed_pytorch_tpu_torch.models.resnet import resnet18
from network_distributed_pytorch_tpu_torch.parallel.reducers import PowerSGDReducer, PowerSGDState
from oracle_powersgd import powersgd_reduce_np
from torch_worker import few_torch_threads, powersgd_rank, spawn  # few_torch_threads: autouse

RTOL = ATOL = 1e-5
RANK = 2
# JAX layout: conv HWIO, dense (in, out), biases; two same-shaped convs make
# a shape group of g = 2
SHAPES = [(3, 3, 3, 8), (3, 3, 8, 8), (3, 3, 8, 8), (8,), (8, 16), (16,), (16, 10), (10,)]


def to_torch(a: np.ndarray) -> torch.Tensor:
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    elif a.ndim == 2:
        a = a.T
    return torch.from_numpy(np.ascontiguousarray(a))


def to_jax_layout(t: torch.Tensor) -> np.ndarray:
    a = t.detach().numpy()
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    if a.ndim == 2:
        return a.T
    return a


def sends(seed, n_workers):
    rng = np.random.RandomState(seed)
    return [[rng.randn(*s).astype(np.float32) for s in SHAPES] for _ in range(n_workers)]


def initial_qs(rank=RANK):
    """Warm-start Qs in leaf order, shaped (m, r) of the "last" matrices."""
    rng = np.random.RandomState(7)
    qs = []
    for s in SHAPES:
        if len(s) > 1:
            n, m = int(np.prod(s[:-1])), s[-1]
            qs.append(rng.randn(m, min(n, m, rank)).astype(np.float32))
    return qs


def packed(qs):
    return np.concatenate([q.reshape(-1) for q in qs])


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def jax_chain(steps_sends, q0, mesh=None, **kw):
    """The JAX reducer over the steps; returns per step (out, mem per worker)
    and the final q_memory."""
    reducer = JaxPowerSGD(random_seed=0, compression_rank=RANK, matricize="last", **kw)
    state = JaxState(jnp.asarray(q0), jax.random.PRNGKey(0))
    results = []
    if mesh is None:
        for s in steps_sends:
            state, out, mem, bits = reducer.reduce(state, [jnp.asarray(a) for a in s[0]], None)
            results.append(([np.asarray(o) for o in out], [[np.asarray(m) for m in mem]], bits))
        return results, np.asarray(state.q_memory)

    def f(q_memory, key, *send):
        st, out, mem, _ = reducer.reduce(JaxState(q_memory, key), [x[0] for x in send], DATA_AXIS)
        return st.q_memory, st.key, [o[None] for o in out], [m[None] for m in mem]

    n = len(SHAPES)
    fn = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(), P()) + (P(DATA_AXIS),) * n,
        out_specs=(P(), P(), [P(DATA_AXIS)] * n, [P(DATA_AXIS)] * n),
    ))
    q, key = state.q_memory, state.key
    for s in steps_sends:
        stacked = [jnp.stack([jnp.asarray(w[i]) for w in s]) for i in range(n)]
        q, key, out, mem = fn(q, key, *stacked)
        out = [np.asarray(o)[0] for o in out]
        mems = [[np.asarray(m)[w] for m in mem] for w in range(len(s))]
        results.append((out, mems, None))
    return results, np.asarray(q)


def oracle_chain(steps_sends, q0s, **kw):
    qs, results = list(q0s), []
    for s in steps_sends:
        out, mems, qs, bits = powersgd_reduce_np(s, qs, RANK, "last", **kw)
        results.append((out, mems, bits))
    return results, packed(qs)


def port_chain(steps_sends, q0, **kw):
    reducer = PowerSGDReducer(random_seed=0, compression_rank=RANK, matricize="last", **kw)
    template = [to_torch(a) for a in steps_sends[0][0]]
    state = PowerSGDState(torch.from_numpy(q0), reducer.init(template).generator)
    results = []
    for s in steps_sends:
        state, out, mem, bits = reducer.reduce(state, [to_torch(a) for a in s[0]], None)
        results.append(([to_jax_layout(o) for o in out], [[to_jax_layout(m) for m in mem]], bits))
    return results, state.q_memory.numpy()


def check_chain(port, ref, n_workers, check_bits=True):
    (port_steps, port_q), (ref_steps, ref_q) = port, ref
    for (p_out, p_mems, p_bits), (r_out, r_mems, r_bits) in zip(port_steps, ref_steps):
        for a, b in zip(p_out, r_out):
            close(a, b)
        for w in range(n_workers):
            for a, b in zip(p_mems[w], r_mems[w]):
                close(a, b)
        if check_bits:
            assert p_bits == r_bits
    close(port_q, ref_q)


@pytest.mark.parametrize("n_power_iterations", [0, 1])
def test_one_worker_chain_matches_oracle_and_jax(n_power_iterations):
    steps = [sends(100 + 31 * k, 1) for k in range(3)]
    q0s = initial_qs()
    port = port_chain(steps, packed(q0s), n_power_iterations=n_power_iterations)
    check_chain(port, oracle_chain(steps, q0s, n_power_iterations=n_power_iterations), 1)
    check_chain(port, jax_chain(steps, packed(q0s), n_power_iterations=n_power_iterations), 1)


def test_two_ranks_chain_matches_oracle_and_jax(tmp_path):
    """The 3-step warm-start chain on two Gloo ranks, against the oracle and
    against the JAX reducer under shard_map on two devices."""
    steps = [sends(200 + 31 * k, 2) for k in range(3)]
    q0s = initial_qs()
    per_rank = [[[to_torch(a) for a in s[r]] for s in steps] for r in range(2)]
    kwargs = dict(random_seed=0, compression_rank=RANK, matricize="last")
    ranks = spawn(powersgd_rank, 2, tmp_path, per_rank, torch.from_numpy(packed(q0s)), kwargs)
    # every rank holds the same mean and Q; each keeps its own error memory
    port_steps = []
    for k in range(3):
        out = [to_jax_layout(o) for o in ranks[0]["steps"][k]["out"]]
        for o1, o0 in zip(ranks[1]["steps"][k]["out"], ranks[0]["steps"][k]["out"]):
            assert torch.equal(o1, o0)
        mems = [[to_jax_layout(m) for m in ranks[r]["steps"][k]["mem"]] for r in range(2)]
        port_steps.append((out, mems, ranks[0]["steps"][k]["bits"]))
    assert torch.equal(ranks[0]["q_memory"], ranks[1]["q_memory"])
    port = (port_steps, ranks[0]["q_memory"].numpy())
    check_chain(port, oracle_chain(steps, q0s), 2)
    mesh = make_mesh(devices=jax.devices()[:2])
    check_chain(port, jax_chain(steps, packed(q0s), mesh=mesh), 2, check_bits=False)


def test_matricize_first_matches_oracle():
    """The reference's rule, ``reshape(shape[0], -1)``, on the tensors as
    given (here torch layout), one step."""
    torch_sends = [[to_torch(a).numpy() for a in sends(5, 1)[0]]]
    reducer = PowerSGDReducer(random_seed=3, compression_rank=RANK, matricize="first")
    template = [torch.from_numpy(a) for a in torch_sends[0]]
    state = reducer.init(template)
    metas = reducer._metas(template)
    _, q_packer, _ = reducer._packers(template, metas)
    qs = [q.numpy() for q in q_packer.unpack(state.q_memory)]
    exp_out, exp_mems, exp_qs, exp_bits = powersgd_reduce_np(torch_sends, qs, RANK, "first")
    state, out, mem, bits = reducer.reduce(state, template, None)
    assert bits == exp_bits
    for o, e in zip(out, exp_out):
        close(o, e)
    for m, e in zip(mem, exp_mems[0]):
        close(m, e)
    close(state.q_memory, packed(exp_qs))


def test_bf16_wire_matches_jax():
    """bf16 P, Q and rank-1 payloads, cast back to fp32 for the math.
    Tolerance 2e-2: a product summed in another order can round to the
    neighbouring bf16 value (2**-8 relative), and that error runs through
    the Gram-Schmidt and the decompression."""
    steps = [sends(300, 1)]
    q0 = packed(initial_qs()).astype(np.float32)
    reducer = PowerSGDReducer(
        random_seed=0, compression_rank=RANK, matricize="last", compression_dtype="bfloat16"
    )
    template = [to_torch(a) for a in steps[0][0]]
    state = PowerSGDState(torch.from_numpy(q0).to(torch.bfloat16), reducer.init(template).generator)
    state, out, mem, bits = reducer.reduce(state, template, None)
    jax_red = JaxPowerSGD(random_seed=0, compression_rank=RANK, matricize="last", compression_dtype=jnp.bfloat16)
    jstate = JaxState(jnp.asarray(q0).astype(jnp.bfloat16), jax.random.PRNGKey(0))
    jstate, jout, jmem, jbits = jax_red.reduce(jstate, [jnp.asarray(a) for a in steps[0][0]], None)
    assert bits == jbits
    assert state.q_memory.dtype == torch.bfloat16
    for o, e in zip(out, jout):
        assert o.dtype == torch.float32
        close(to_jax_layout(o), e, rtol=2e-2, atol=2e-2)
    for m, e in zip(mem, jmem):
        close(to_jax_layout(m), e, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize(
    "kw",
    [
        dict(compression_rank=4),
        dict(compression_rank=1),
        dict(compression_rank=4, n_power_iterations=1),
        dict(compression_rank=4, compression_dtype="bfloat16"),
    ],
)
def test_bits_per_step_match_jax_on_resnet18(kw):
    """Same parameter shapes (the small ResNet-18), same bits on the wire."""
    model = resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device="cpu")
    jax_params = jax.eval_shape(
        lambda: jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=True
        )
    )["params"]
    jax_kw = dict(kw)
    if "compression_dtype" in jax_kw:
        jax_kw["compression_dtype"] = jnp.bfloat16
    port = PowerSGDReducer(matricize="last", **kw).bits_per_step(list(model.parameters()))
    ref = JaxPowerSGD(matricize="last", **jax_kw).bits_per_step(jax_params)
    assert port == ref > 0


def test_rank_clipping_and_shape_groups():
    reducer = PowerSGDReducer(compression_rank=8, matricize="last")
    leaves = [torch.zeros(10, 3, 1, 1), torch.zeros(4, 6), torch.zeros(4, 6), torch.zeros(5)]
    metas = reducer._metas(leaves)
    assert [(m.n, m.m, m.r) for m in metas] == [(3, 10, 3), (6, 4, 4), (6, 4, 4)]
    assert reducer._shape_groups(metas) == [[0], [1, 2]]
    assert reducer.n_shape_groups(leaves) == 2


def test_no_reuse_redraws_q_the_same_on_every_rank():
    leaves = [to_torch(a) for a in sends(9, 1)[0]]
    results = []
    for _ in range(2):
        reducer = PowerSGDReducer(random_seed=5, compression_rank=RANK, reuse_query=False)
        state = reducer.init(leaves)
        s1, out1, _, _ = reducer.reduce(state, leaves, None)
        s2, out2, _, _ = reducer.reduce(s1, leaves, None)
        results.append((out1, out2))
    for a, b in zip(results[0][0] + results[0][1], results[1][0] + results[1][1]):
        assert torch.equal(a, b)  # same seed, same draws: ranks agree with no communication
    assert not torch.equal(results[0][0][0], results[0][1][0])  # a fresh Q each step


def test_cuda_impl_refuses_cpu_tensors():
    reducer = PowerSGDReducer(compression_rank=2, orthogonalize_impl="cuda")
    leaves = [torch.ones(4, 3)]
    with pytest.raises(ValueError, match="CUDA"):
        reducer.reduce(reducer.init(leaves), leaves, None)


def test_q_carries_across_by_name_past_ten_blocks():
    """With 11 blocks ``jax.tree_util`` orders ``BottleneckBlock_10`` before
    ``BottleneckBlock_2``; the port orders by registration. Each port Q must
    still equal the JAX reducer's Q for the same parameter."""
    from network_distributed_pytorch_tpu.models.resnet import BottleneckBlock as JaxBottleneck
    from network_distributed_pytorch_tpu.models.resnet import ResNet as JaxResNet
    from network_distributed_pytorch_tpu_torch.models.import_weights import (
        powersgd_state_from_jax,
        torch_name,
    )
    from network_distributed_pytorch_tpu_torch.models.resnet import BottleneckBlock, ResNet

    stages = [3, 4, 4]
    jax_params = jax.eval_shape(
        lambda: JaxResNet(stage_sizes=stages, block_cls=JaxBottleneck, width=4).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=True
        )
    )["params"]
    jax_params = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), jax_params)
    jred = JaxPowerSGD(random_seed=3, compression_rank=4, matricize="last")
    jq = jred.init(jax_params).q_memory
    leaves_with_path = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    leaves = [leaf for _, leaf in leaves_with_path]
    metas = jred._metas(leaves)
    _, jq_packer, _ = jred._packers(leaves, metas)
    want = {
        torch_name(tuple(str(k.key) for k in leaves_with_path[meta.leaf_index][0])): np.asarray(q)
        for meta, q in zip(metas, jq_packer.unpack(jq))
    }
    assert "blocks.10.conv0.weight" in want

    model = ResNet(stages, BottleneckBlock, width=4, device="cpu")
    reducer = PowerSGDReducer(random_seed=3, compression_rank=4, matricize="last")
    state = powersgd_state_from_jax(np.asarray(jq), jax_params, reducer, model)
    names, params = zip(*model.named_parameters())
    port_metas = reducer._metas(list(params))
    _, q_packer, _ = reducer._packers(list(params), port_metas)
    got = {names[m.leaf_index]: q for m, q in zip(port_metas, q_packer.unpack(state.q_memory))}
    assert set(got) == set(want)
    assert list(got) != sorted(got)  # registration order is not key order
    for name, q in got.items():
        assert np.array_equal(q.numpy(), want[name]), name
