"""Tensor parallelism in the port against the JAX package: ``tp_mlp``, the
TP decoder's loss, logits and every leaf's gradient (head-sharded
attention, the column -> row MLP, the vocabulary-parallel embedding and
head) and the vocabulary-parallel cross-entropy, at 2 and 4 model shards.

The JAX functions run under ``shard_map`` on the conftest's CPU devices;
the port's in 4 Gloo ranks spawned once for the module (a 2-shard case
runs as two replicas of a 2-rank mesh). Inputs and weights are drawn with
numpy from seeds. Tolerance 1e-5 relative and absolute, as
``tests/test_torch_gpt.py``. The entry point ``gpt_tp.run`` is held to the
JAX run in ``test_torch_gpt_parallel.py``.
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
from network_distributed_pytorch_tpu_torch.models.import_weights import gpt_state_dict_from_flax
from torch_parity import random_gpt_params, to_numpy
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

jax_gpt = importlib.import_module("network_distributed_pytorch_tpu.models.gpt")
jax_tensor = importlib.import_module("network_distributed_pytorch_tpu.parallel.tensor")

TOL = 1e-5
CFG = dict(vocab_size=64, max_position_embeddings=16, dim=16, n_layers=2, n_heads=4, hidden_dim=32, dropout=0.0)
B, T = 2, 16
FORWARD_CASES = [(2, False), (4, False), (2, True), (4, True)]


def _params():
    return to_numpy(random_gpt_params(jax_gpt.GPTLM(jax_gpt.GPTConfig(**CFG)), T, 0))


def _tokens(seed):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"], (B, T)).astype(np.int32)


def _mlp_inputs():
    rng = np.random.RandomState(3)
    return [rng.randn(*s).astype(np.float32) * 0.5 for s in ((4, 8), (8, 16), (16,), (16, 8), (8,))]


def _ce_inputs():
    rng = np.random.RandomState(4)
    return rng.randn(2, 8, 64).astype(np.float32), rng.randint(0, 64, (2, 8)).astype(np.int32)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    sd = {k: v.numpy() for k, v in gpt_state_dict_from_flax({"params": _params()}).items()}
    ids, labels = _tokens(1), _tokens(2)
    calls = [(w.tp_forward_rank, (CFG, sd, ids, labels, n, vp)) for n, vp in FORWARD_CASES]
    calls += [(w.tp_mlp_rank, (*_mlp_inputs(), n)) for n in (2, 4)]
    calls += [(w.vocab_ce_rank, (*_ce_inputs(), n)) for n in (2, 4)]
    return torch_worker.spawn(torch_worker.run_all, 4, tmp_path_factory.mktemp("tp"), calls)


def _by_index(port, call, n):
    """The ranks' results of ``call`` for shard indices 0..n-1 (replica 0)."""
    return [port[r][call] for r in range(n)]


def _assemble(shards, specs):
    """Full tensors from the shards of ``specs``' dimensions."""
    return {k: torch.cat([s[k] for s in shards], dim=d) if d is not None else shards[0][k] for k, d in specs.items()}


def _mesh(n, name):
    return jax_make_mesh(axis_sizes=(n,), axis_names=(name,), devices=jax.devices()[:n])


@pytest.mark.parametrize("case", range(len(FORWARD_CASES)), ids=[f"{n}shards-vp{int(vp)}" for n, vp in FORWARD_CASES])
def test_tp_decoder_loss_and_every_gradient_match_jax(port, case):
    n, vp = FORWARD_CASES[case]
    cfg = jax_gpt.GPTConfig(**CFG)
    params = jax.tree_util.tree_map(jnp.asarray, _params())
    ids, labels = jnp.asarray(_tokens(1)), jnp.asarray(_tokens(2))
    specs = jax_gpt.gpt_tp_param_specs(cfg, vocab_parallel=vp)

    def body(p, i, y):
        def loss(p):
            logits = jax_gpt.tp_gpt_forward(cfg, p, i, vocab_parallel=vp)
            if vp:
                return jax_gpt.vocab_parallel_next_token_loss(logits, y, "model"), logits
            return jax_gpt.next_token_loss(logits, y), logits

        (l, logits), g = jax.value_and_grad(loss, has_aux=True)(p)
        return l, logits, g

    out_logits = P(None, None, "model") if vp else P()
    loss, logits, grads = jax.jit(
        jax.shard_map(body, mesh=_mesh(n, "model"), in_specs=(specs, P(), P()), out_specs=(P(), out_logits, specs))
    )(params, ids, labels)
    res = _by_index(port, case, n)
    assert [r["index"] for r in res] == list(range(n))
    for r in res:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=TOL, atol=TOL)
    got_logits = torch.cat([r["logits"] for r in res], dim=-1) if vp else res[0]["logits"]
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), rtol=TOL, atol=TOL)
    # every leaf: the shards' gradients assembled along their spec dimension
    from network_distributed_pytorch_tpu_torch.models.gpt import GPTConfig, gpt_tp_param_specs

    port_specs = gpt_tp_param_specs(GPTConfig(**CFG), vp)
    got = _assemble([r["grads"] for r in res], port_specs)
    want = gpt_state_dict_from_flax({"params": to_numpy(grads)})
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=TOL, atol=TOL, err_msg=name)
    # a replicated leaf's gradient is the same on every model rank
    for name, d in port_specs.items():
        if d is None:
            for r in res[1:]:
                np.testing.assert_allclose(r["grads"][name].numpy(), res[0]["grads"][name].numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_mlp_matches_jax(port, n):
    call = len(FORWARD_CASES) + (0 if n == 2 else 1)
    x, w_up, b_up, w_down, b_down = (jnp.asarray(a) for a in _mlp_inputs())

    def body(x, wu, bu, wd, bd):
        def f(args):
            return jax_tensor.tp_mlp(*args, axis_name="model")

        out, vjp = jax.vjp(f, (x, wu, bu, wd, bd))
        return out, vjp(2 * out)[0]

    col, row = P(None, "model"), P("model", None)
    specs = (P(), col, P("model"), row, P())
    out, grads = jax.jit(
        jax.shard_map(body, mesh=_mesh(n, "model"), in_specs=specs, out_specs=(P(), specs))
    )(x, w_up, b_up, w_down, b_down)
    res = _by_index(port, call, n)
    np.testing.assert_allclose(res[0]["out"].numpy(), np.asarray(out), rtol=TOL, atol=TOL)
    gx, gwu, gbu, gwd, gbd = (np.asarray(g) for g in grads)
    np.testing.assert_allclose(res[0]["grads"]["x"].numpy(), gx, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(res[0]["grads"]["b_down"].numpy(), gbd, rtol=TOL, atol=TOL)
    # the column shard is rows of the (out, in) weight, the row shard columns
    np.testing.assert_allclose(torch.cat([r["grads"]["w_up"] for r in res], 0).T.numpy(), gwu, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(torch.cat([r["grads"]["b_up"] for r in res], 0).numpy(), gbu, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(torch.cat([r["grads"]["w_down"] for r in res], 1).T.numpy(), gwd, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_ce_matches_jax_and_the_full_loss(port, n):
    call = len(FORWARD_CASES) + 2 + (0 if n == 2 else 1)
    logits, labels = (jnp.asarray(a) for a in _ce_inputs())
    loss, g = jax.jit(
        jax.shard_map(
            lambda l, y: jax.value_and_grad(lambda ls: jax_gpt.vocab_parallel_next_token_loss(ls, y, "model"))(l),
            mesh=_mesh(n, "model"), in_specs=(P(None, None, "model"), P()), out_specs=(P(), P(None, None, "model")),
        )
    )(logits, labels)
    full = float(jax_gpt.next_token_loss(logits, labels))
    res = _by_index(port, call, n)
    for r in res:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["loss"], full, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(torch.cat([r["grad"] for r in res], -1).numpy(), np.asarray(g), rtol=TOL, atol=TOL)
