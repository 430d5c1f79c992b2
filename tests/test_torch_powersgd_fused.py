"""The port's fused PowerSGD pipeline (``ops/powersgd.py``, the reducer's
``compress_impl="pallas"``) against the JAX package.

- Each plain version against the JAX ``fused_*`` function of
  ``ops/pallas_powersgd.py`` run in interpret mode, at the shapes of
  ``tests/test_pallas_powersgd.py``. On CPU tensors the port's wrappers run
  these plain versions, and ``chip_smoke.py`` holds the CUDA kernels to
  them on the card.
- The bf16 residual: fp32 math cast once, bitwise.
- The reducer: the port's fused ``reduce_ef`` on torch-layout leaves against
  the JAX ``"xla"`` and ``"pallas"`` reducers on the same leaves in JAX
  layout, one process, and a two-rank Gloo chain against the port's
  ``"xla"`` chain and the NumPy oracle (``tests/oracle_powersgd.py``).

Inputs are drawn with numpy from a seed. Tolerances: M = G + E is one
rounded add, so bitwise; the products (P, Q, out, mem) rtol 2e-4, atol 1e-4,
as ``test_pallas_powersgd.py`` holds the JAX fused path to its XLA path:
XLA and PyTorch sum the fp32 products in different orders, and the
Gram-Schmidt divides by column norms. The bf16 wire: 2e-2, a neighbouring
bf16 value (2**-8 relative) carried through the Gram-Schmidt.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.ops.pallas_powersgd import (
    fused_decompress_residual as jax_decompress_residual,
    fused_ef_compress as jax_ef_compress,
    fused_orthogonalize_project as jax_orthogonalize_project,
)
from network_distributed_pytorch_tpu.parallel.reducers import PowerSGDReducer as JaxPowerSGD
from network_distributed_pytorch_tpu.parallel.reducers import PowerSGDState as JaxState
from network_distributed_pytorch_tpu_torch.ops import powersgd as ps
from network_distributed_pytorch_tpu_torch.parallel.reducers import PowerSGDReducer, PowerSGDState
from oracle_powersgd import powersgd_reduce_np
from torch_worker import few_torch_threads, powersgd_ef_rank, spawn  # few_torch_threads: autouse

RTOL, ATOL = 2e-4, 1e-4
BF16_TOL = 2e-2
EF_TOL = 1e-5


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a copy: JAX's arrays are read-only


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=rtol, atol=atol)


# ---- each plain version against the JAX kernel (interpret mode) -------------

# the last three: m % 4 in {2, 3} (m = 10 as in ResNet's fc group), where
# the CUDA kernels take their scalar loads
SHAPES = [(1, 64, 32, 4), (3, 100, 37, 8), (2, 5, 3, 2), (2, 6, 9, 1), (2, 12, 10, 4), (1, 9, 7, 3), (2, 5, 6, 2)]


@pytest.mark.parametrize("g,n,m,r", SHAPES)
def test_plain_versions_match_jax_kernels(g, n, m, r):
    rng = np.random.RandomState(g * 1000 + n + m + r)
    grads, resid = (rng.randn(g, n, m).astype(np.float32) for _ in range(2))
    q = rng.randn(g, m, r).astype(np.float32)

    # K2a: M bitwise, P to the tolerance
    jm, jp = jax_ef_compress(jnp.asarray(grads), jnp.asarray(q), jnp.asarray(resid), interpret=True)
    tm, tp = ps.fused_ef_compress(_t(grads), _t(q), _t(resid))
    np.testing.assert_array_equal(_bits(tm.numpy()), _bits(np.asarray(jm)))
    _close(tp, jp)
    # K2b: M is grads itself
    _, jp2 = jax_ef_compress(jnp.asarray(grads), jnp.asarray(q), interpret=True)
    tg = _t(grads)
    same, tp2 = ps.fused_ef_compress(tg, _t(q))
    assert same is tg
    _close(tp2, jp2)
    # K3 on the JAX kernel's P and M
    p, mat = np.asarray(jp), np.asarray(jm)
    jphat, jq = jax_orthogonalize_project(jnp.asarray(p), jnp.asarray(mat), interpret=True)
    tphat, tq = ps.fused_orthogonalize_project(_t(p), _t(mat))
    _close(tphat, jphat)
    _close(tq, jq)
    # K4 on K3's results
    phat, qn = np.asarray(jphat), np.asarray(jq)
    jout, jmem = jax_decompress_residual(jnp.asarray(phat), jnp.asarray(qn), jnp.asarray(mat), interpret=True)
    tout, tmem = ps.fused_decompress_residual(_t(phat), _t(qn), _t(mat))
    _close(tout, jout)
    _close(tmem, jmem)
    # the dtypes of the JAX bodies
    assert tp.dtype == tq.dtype == tout.dtype == tmem.dtype == torch.float32


def test_bf16_residual_is_fp32_math_cast_once():
    """The bf16 EF residual is fp32 math cast ONCE, bitwise, as
    ``test_fused_decompress_bf16_accumulates_in_fp32`` pins the JAX kernel.
    P and Q hold multiples of 1/16 and M multiples of 1/256, so every fp32
    sum and the residual are exact in any order; a bf16 accumulation chain
    (8-bit mantissa) would round the sums and differ."""
    rng = np.random.RandomState(13)
    p = (rng.randint(-16, 17, size=(2, 64, 8)) / 16).astype(np.float32)
    q = (rng.randint(-16, 17, size=(2, 32, 8)) / 16).astype(np.float32)
    mat = torch.from_numpy((rng.randint(-2048, 2049, size=(2, 64, 32)) / 256).astype(np.float32)).to(torch.bfloat16)
    exact_out = np.einsum("gnr,gmr->gnm", p.astype(np.float64), q.astype(np.float64))
    exact_mem = mat.double().numpy() - exact_out
    out, mem = ps.fused_decompress_residual(_t(p).to(torch.bfloat16), _t(q).to(torch.bfloat16), mat)
    assert out.dtype == mem.dtype == torch.bfloat16
    want_out = torch.from_numpy(exact_out.astype(np.float32)).to(torch.bfloat16)
    want_mem = torch.from_numpy(exact_mem.astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(out.view(torch.int16), want_out.view(torch.int16))
    assert torch.equal(mem.view(torch.int16), want_mem.view(torch.int16))
    # a bf16 chain would not give these bits
    assert not torch.equal(mem, (mat - torch.bmm(_t(p).to(torch.bfloat16), _t(q).to(torch.bfloat16).transpose(1, 2))))
    # and the JAX kernel gives the same bits
    jout, jmem = jax_decompress_residual(
        jnp.asarray(p, jnp.bfloat16), jnp.asarray(q, jnp.bfloat16),
        jnp.asarray(mat.float().numpy(), jnp.bfloat16), interpret=True,
    )
    assert torch.equal(mem.view(torch.int16), _t(np.asarray(jmem).view(np.int16)))
    assert torch.equal(out.view(torch.int16), _t(np.asarray(jout).view(np.int16)))


# ---- the reducer: fused against the JAX reducers -----------------------------

# the mixes of test_pallas_powersgd.py, JAX layout: a 4-D conv kernel (HWIO),
# dense kernels (in, out), rank-1 biases; the ragged mix puts three (16, 8)
# twins in one group and rank-clips a (2, 3)
TEMPLATE = [(8, 3, 3, 3), (16, 8), (16,), (10, 16), (10,)]
RAGGED = [(16, 8), (16, 8), (16, 8), (10, 16), (2, 3), (7,)]


def to_torch(a: np.ndarray) -> torch.Tensor:
    """JAX layout -> torch layout (HWIO -> OIHW, (in, out) -> (out, in))."""
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    elif a.ndim == 2:
        a = a.T
    return _t(a)


def to_jax_layout(t: torch.Tensor) -> np.ndarray:
    a = t.detach().float().numpy()
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    return a.T if a.ndim == 2 else a


def draw(shapes, seed, rank):
    """Gradients, error memories (0.3 x a draw; zero for rank-1 leaves) and
    the packed warm-start Q of the "last" matrices, in JAX layout."""
    rng = np.random.RandomState(seed)
    grads = [rng.randn(*s).astype(np.float32) for s in shapes]
    mems = [
        (0.3 * rng.randn(*s)).astype(np.float32) if len(s) > 1 else np.zeros(s, np.float32)
        for s in shapes
    ]
    qs = []
    for s in shapes:
        if len(s) > 1:
            n, m = int(np.prod(s[:-1])), s[-1]
            qs.append(rng.randn(m, min(n, m, rank)).astype(np.float32).reshape(-1))
    return grads, mems, np.concatenate(qs)


def jax_reduce_ef(impl, grads, mems, q0, rank, wire):
    """The JAX reducer's ``reduce_ef``, one process, jitted whole (one
    compile in place of one per operation)."""
    reducer = JaxPowerSGD(
        random_seed=0, compression_rank=rank, matricize="last", compress_impl=impl,
        compression_dtype=jnp.bfloat16 if wire == "bfloat16" else None,
    )

    def f(q_memory, g, e):
        st, out, mem, _ = reducer.reduce_ef(JaxState(q_memory, jax.random.PRNGKey(0)), g, e, None)
        return st.q_memory, out, mem

    q0 = jnp.asarray(q0).astype(reducer.compression_dtype or jnp.float32)
    q, out, mem = jax.jit(f)(q0, [jnp.asarray(g) for g in grads], [jnp.asarray(e) for e in mems])
    bits = reducer.bits_per_step([jnp.asarray(g) for g in grads])
    return [np.asarray(o, np.float32) for o in out], [np.asarray(m, np.float32) for m in mem], bits, np.asarray(q, np.float32)


@pytest.mark.parametrize(
    "mix,rank,wire",
    [("template", 1, None), ("template", 4, None), ("template", 8, None),
     ("ragged", 1, None), ("ragged", 4, None), ("ragged", 8, None),
     ("template", 4, "bfloat16")],
)
def test_fused_reducer_matches_jax_reducers(mix, rank, wire):
    shapes = TEMPLATE if mix == "template" else RAGGED
    grads, mems, q0 = draw(shapes, seed=17 + rank + (7 if mix == "ragged" else 0), rank=rank)
    reducer = PowerSGDReducer(
        random_seed=0, compression_rank=rank, matricize="last", compress_impl="pallas",
        compression_dtype=wire,
    )
    t_grads, t_mems = [to_torch(g) for g in grads], [to_torch(e) for e in mems]
    state = PowerSGDState(_t(q0).to(reducer.compression_dtype or torch.float32), reducer.init(t_grads).generator)
    st, out, mem, bits = reducer.reduce_ef(state, t_grads, t_mems, None)
    out, mem = [to_jax_layout(o) for o in out], [to_jax_layout(m) for m in mem]
    q_mem = st.q_memory.float().numpy()
    tol = dict(rtol=BF16_TOL, atol=BF16_TOL) if wire else {}
    for impl in ("xla", "pallas"):
        j_out, j_mem, j_bits, j_q = jax_reduce_ef(impl, grads, mems, q0, rank, wire)
        assert bits == j_bits, impl
        _close(q_mem, j_q, **tol)
        for a, b in zip(out + mem, j_out + j_mem):
            _close(a, b, **tol)
    # the EF identity: out + mem = G + E for every high-rank leaf
    for g, e, o, m in zip(grads, mems, out, mem):
        if g.ndim > 1:
            np.testing.assert_allclose(o + m, g + e, rtol=EF_TOL, atol=EF_TOL)


# ---- two Gloo ranks: the fused chain against xla and the NumPy oracle --------

CHAIN_RANK = 2


@pytest.fixture(scope="module")
def two_rank_chain(tmp_path_factory):
    """One spawn of two Gloo ranks: a 3-step error-feedback chain on each
    pipeline, from the same Q, each rank on its own gradients."""
    steps = []
    for k in range(3):
        per_worker = [draw(TEMPLATE, seed=300 + 31 * k + w, rank=CHAIN_RANK) for w in range(2)]
        steps.append([w[0] for w in per_worker])
    q0 = draw(TEMPLATE, seed=299, rank=CHAIN_RANK)[2]
    per_rank = [[[to_torch(a) for a in s[w]] for s in steps] for w in range(2)]
    kwargs = dict(random_seed=0, compression_rank=CHAIN_RANK, matricize="last")
    ranks = spawn(powersgd_ef_rank, 2, tmp_path_factory.mktemp("fused_chain"), per_rank, _t(q0), kwargs)
    return steps, q0, ranks


def test_two_rank_fused_chain_matches_xla_and_oracle(two_rank_chain):
    steps, q0, ranks = two_rank_chain
    # the NumPy oracle's error-feedback chain: send = grad + memory
    qs, offset = [], 0
    for s in TEMPLATE:
        if len(s) > 1:
            n, m = int(np.prod(s[:-1])), s[-1]
            r = min(n, m, CHAIN_RANK)
            qs.append(q0[offset : offset + m * r].reshape(m, r))
            offset += m * r
    mems = [[np.zeros(s, np.float32) for s in TEMPLATE] for _ in range(2)]
    for k, grads in enumerate(steps):
        sends = [[g + e for g, e in zip(grads[w], mems[w])] for w in range(2)]
        out, mems, qs, bits = powersgd_reduce_np(sends, qs, CHAIN_RANK, "last")
        for w, res in enumerate(ranks):
            fused, xla = res["pallas"]["steps"][k], res["xla"]["steps"][k]
            assert fused["bits"] == xla["bits"] == bits
            for a, b in zip(fused["out"] + fused["mem"], xla["out"] + xla["mem"]):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
            for a, b in zip(fused["out"], out):
                _close(to_jax_layout(a), b, rtol=1e-5, atol=1e-5)
            for a, b in zip(fused["mem"], mems[w]):
                _close(to_jax_layout(a), b, rtol=1e-5, atol=1e-5)
    oracle_q = np.concatenate([q.reshape(-1) for q in qs])
    for res in ranks:
        assert torch.equal(res["pallas"]["q_memory"], ranks[0]["pallas"]["q_memory"])
        _close(res["pallas"]["q_memory"], oracle_q, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(res["pallas"]["q_memory"], res["xla"]["q_memory"], rtol=1e-6, atol=1e-6)


# ---- wrappers, reducer and launcher on the CPU --------------------------------


def test_wrappers_take_the_plain_versions_on_cpu_without_launching():
    rng = np.random.RandomState(5)
    grads, resid = _t(rng.randn(2, 6, 9).astype(np.float32)), _t(rng.randn(2, 6, 9).astype(np.float32))
    q, p = _t(rng.randn(2, 9, 3).astype(np.float32)), _t(rng.randn(2, 6, 3).astype(np.float32))
    before = [k.launches for k in ps.KERNELS]
    for got, want in (
        (ps.fused_ef_compress(grads, q, resid), ps.ef_compress_reference(grads, q, resid)),
        (ps.fused_orthogonalize_project(p, grads), ps.orthogonalize_project_reference(p, grads)),
        (ps.fused_decompress_residual(p, q, grads), ps.decompress_residual_reference(p, q, grads)),
    ):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert [k.launches for k in ps.KERNELS] == before
    with pytest.raises(ValueError, match="operands on"):
        ps.fused_decompress_residual(p.to("meta"), q, grads)


def test_reducer_refuses_unknown_compress_impl():
    with pytest.raises(ValueError, match="compress_impl"):
        PowerSGDReducer(compress_impl="bogus")


def test_launcher_runs_the_fused_pipeline_on_cpu(capsys):
    from network_distributed_pytorch_tpu_torch import launch

    args = ["powersgd_cifar10", "--device", "cpu", "--global-batch", "16", "--epochs", "1",
            "--max-steps-per-epoch", "1", "--compress-impl", "pallas", "--orthogonalize-impl", "eager", "--json"]
    cfg = launch.config_from_args(launch.build_parser().parse_args(args))
    assert (cfg.compress_impl, cfg.orthogonalize_impl) == ("pallas", "eager")
    out = launch.main(args)
    assert out["steps"] == 1 and np.isfinite(out["losses"]).all()
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")
