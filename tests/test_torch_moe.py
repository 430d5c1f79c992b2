"""Expert parallelism in the port against the JAX package: ``switch_moe``
on one process (``group=None``) and on 4 ranks of 2 experts and 2 ranks
of 4 (the all-to-all dispatch), top-1 and top-2, its output, aux loss,
dropped fraction and the gradients of the tokens, the router and the
experts; capacity drops; the Switch aux-loss formula; priority dispatch;
and 4 ranks x 2 experts equal to 1 x 8 (``tests/test_moe.py:65``).

Routing is discontinuous: a near-tie in the router can pick another
expert in the other framework. Each case first holds the top-k indices to
the JAX ones, allowing a flip only where the first two choices' margin is
under ``MOE_TIE`` (none occurs on these inputs; the smallest margin is
printed). The JAX functions run under ``shard_map`` on the conftest's CPU
devices, the port's in 4 Gloo ranks spawned once. Tolerance 1e-5
(``tests/test_torch_gpt.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_model_parallel_worker as w
import torch_worker
from network_distributed_pytorch_tpu.parallel.mesh import make_mesh as jax_make_mesh
from network_distributed_pytorch_tpu_torch.parallel.moe import routing, switch_moe
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

jax_moe = importlib.import_module("network_distributed_pytorch_tpu.parallel.moe")

TOL = 1e-5
MOE_TIE = 1e-6  # a routing flip is a near-tie only under this top-2 margin
E, D, TOKENS = 8, 6, 32
# (ranks (0: group=None), top_k, capacity)
CASES = [(0, 1, 32), (0, 2, 64), (4, 1, 8), (4, 2, 16), (2, 1, 16), (2, 2, 32), (4, 1, 2), (0, 2, 3)]


def _inputs(case):
    rng = np.random.RandomState(case)
    x = rng.randn(TOKENS, D).astype(np.float32)
    router = (rng.randn(D, E) * 0.5).astype(np.float32)
    experts = {
        "w1": (rng.randn(E, D, 2 * D) * 0.3).astype(np.float32), "b1": (rng.randn(E, 2 * D) * 0.1).astype(np.float32),
        "w2": (rng.randn(E, 2 * D, D) * 0.3).astype(np.float32), "b2": (rng.randn(E, D) * 0.1).astype(np.float32),
    }
    return x, router, experts, rng.randn(TOKENS, D).astype(np.float32)


def _priority_inputs():
    router = np.zeros((D, E), np.float32)
    router[:, 0], router[:, 1] = 1.0, 0.5  # every token: expert 0 first, 1 second
    x = np.abs(np.random.RandomState(7).randn(4, D)).astype(np.float32)
    _, _, experts, _ = _inputs(8)
    return x, router, experts, np.ones((4, D), np.float32)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    calls = []
    for i, (n, k, cap) in enumerate(CASES):
        x, router, experts, cot = _inputs(i)
        calls.append((w.moe_rank, (x, router, experts, cap, k, n, cot)))
    x, router, experts, cot = _inputs(3)  # case 3's inputs on one process with all 8 experts
    calls.append((w.moe_rank, (x, router, experts, 16, 2, 0, cot)))
    x, router, experts, cot = _priority_inputs()
    calls.append((w.moe_rank, (x, router, experts, 1, 2, 0, cot)))
    return torch_worker.spawn(torch_worker.run_all, 4, tmp_path_factory.mktemp("moe"), calls)


def _expert_fn(p, t):
    return jnp.tanh(t @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _jax_moe(x, router, experts, cap, k, n, cot):
    """Output, aux, dropped and the gradients of sum(out * cot) + aux."""

    def body(x, r, e, c):
        def f(x, r, e):
            res = jax_moe.switch_moe(x, r, e, _expert_fn, "expert" if n else None, capacity=cap, top_k=k)
            return jnp.sum(res.out * c) + res.aux_loss, res

        (_, res), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(x, r, e)
        if n:
            return res.out, jax.lax.pmean(res.aux_loss, "expert"), jax.lax.pmean(res.dropped_fraction, "expert"), g
        return res.out, res.aux_loss, res.dropped_fraction, g

    args = [jnp.asarray(a) for a in (x, router)] + [jax.tree_util.tree_map(jnp.asarray, experts), jnp.asarray(cot)]
    if not n:
        return jax.jit(body)(*args)
    ex = P("expert")
    mesh = jax_make_mesh(axis_sizes=(n,), axis_names=("expert",), devices=jax.devices()[:n])
    return jax.jit(
        jax.shard_map(body, mesh=mesh, in_specs=(ex, P(), ex, ex), out_specs=(ex, P(), P(), (ex, P(), ex)))
    )(*args)


def _check_routing(x, router, k):
    """The port's top-k indices against JAX's, flips only at near-ties."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, want = jax.lax.top_k(probs, k)
    p, _, got = routing(torch.from_numpy(x), torch.from_numpy(router), k)
    top2 = torch.topk(p, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).numpy()
    flips = (got.numpy() != np.asarray(want)).any(axis=-1)
    print(f"smallest top-2 margin {margin.min():.3e}, flips {int(flips.sum())}")
    assert (margin[flips] < MOE_TIE).all(), "a routing flip away from a near-tie"


@pytest.mark.parametrize("case", range(len(CASES)), ids=[f"n{n}-top{k}-cap{c}" for n, k, c in CASES])
def test_switch_moe_matches_jax(port, case):
    n, k, cap = CASES[case]
    x, router, experts, cot = _inputs(case)
    _check_routing(x, router, k)
    out, aux, dropped, (gx, gr, ge) = _jax_moe(x, router, experts, cap, k, n, cot)
    res = [r[case] for r in port[: max(n, 1)]]
    assert [r["index"] for r in res] == list(range(max(n, 1)))
    np.testing.assert_allclose(torch.cat([r["out"] for r in res]).numpy(), np.asarray(out), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.mean([r["aux"] for r in res]), float(aux), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.mean([r["dropped"] for r in res]), float(dropped), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(torch.cat([r["grads"]["x"] for r in res]).numpy(), np.asarray(gx), rtol=TOL, atol=TOL)
    # the replicated router's gradient: the sum of every rank's own
    np.testing.assert_allclose(sum(r["grads"]["router"] for r in res).numpy(), np.asarray(gr), rtol=TOL, atol=TOL)
    for name in experts:
        got = torch.cat([r["grads"][name] for r in res]).numpy()
        np.testing.assert_allclose(got, np.asarray(ge[name]), rtol=TOL, atol=TOL, err_msg=name)


def test_capacity_drops_assignments(port):
    drops = [port[0][i]["dropped"] for i, (_, _, cap) in enumerate(CASES) if cap <= 3]
    assert drops and all(d > 0.0 for d in drops)
    assert port[0][0]["dropped"] == 0.0  # capacity = every token


def test_four_ranks_of_two_experts_equal_one_process_of_eight(port):
    single = port[0][len(CASES)]
    res = [r[3] for r in port]
    np.testing.assert_allclose(torch.cat([r["out"] for r in res]).numpy(), single["out"].numpy(), rtol=TOL, atol=1e-6)


def test_aux_loss_is_the_switch_formula():
    x, router, _, _ = _inputs(0)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1))
    fraction = np.bincount(probs.argmax(-1), minlength=E) / TOKENS
    want = E * np.sum(fraction * probs.mean(0))
    experts = {k: torch.from_numpy(v) for k, v in _inputs(0)[2].items()}
    res = switch_moe(torch.from_numpy(x), torch.from_numpy(router), experts, w.toy_experts, None, capacity=32)
    np.testing.assert_allclose(float(res.aux_loss), want, rtol=TOL)


def test_priority_dispatch_drops_the_secondary_first(port):
    res = port[0][len(CASES) + 1]
    # token 0 keeps both assignments; tokens 1-3 lose both: 2 of 8 kept
    np.testing.assert_allclose(res["dropped"], 6 / 8, rtol=1e-6)
    assert float(res["out"][1:].abs().max()) == 0.0 and float(res["out"][0].abs().max()) > 0.0
