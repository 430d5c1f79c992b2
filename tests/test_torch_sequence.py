"""Sequence parallelism in the port against the JAX package: ring and
Ulysses attention (forward and the gradients of q, k and v; no mask, a
padding mask, causal) at 2 and 4 sequence shards, Ulysses' refusal of a
head count the shards do not divide, DistilBERT's sequence-parallel
encoder, and the sequence-parallel GPT (logits, loss and every leaf's
full-sequence gradient) under both schedules.

The JAX functions run under ``shard_map`` on the conftest's CPU devices;
the port's in 4 Gloo ranks spawned once for the module (a 2-shard case
runs as two replicas of a 2-rank mesh). Inputs and weights come from numpy
seeds. Tolerance 1e-5 relative and absolute (``tests/test_torch_gpt.py``).
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
from network_distributed_pytorch_tpu_torch.models.import_weights import (
    distilbert_state_dict_from_flax,
    gpt_state_dict_from_flax,
)
from torch_parity import random_distilbert_params, random_gpt_params, to_numpy
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

jax_seq = importlib.import_module("network_distributed_pytorch_tpu.parallel.sequence")
jax_gpt = importlib.import_module("network_distributed_pytorch_tpu.models.gpt")
jax_distilbert = importlib.import_module("network_distributed_pytorch_tpu.models.distilbert")

TOL = 1e-5
B, T, H, D = 2, 32, 4, 8
ATTN_CASES = [
    (impl, n, masked, causal)
    for impl in ("ring", "ulysses")
    for n in (2, 4)
    for masked, causal in ((False, False), (True, False), (False, True))
]
GPT_CFG = dict(vocab_size=64, max_position_embeddings=T, dim=32, n_layers=2, n_heads=4, hidden_dim=64, dropout=0.0)
BERT_CFG = dict(
    vocab_size=128, max_position_embeddings=64, dim=32, n_layers=2, n_heads=4, hidden_dim=64, dropout=0.0,
    attention_dropout=0.0,
)
MODEL_CASES = [(impl, n) for impl in ("ring", "ulysses") for n in (2, 4)]


def _qkv_cot(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype(np.float32) for _ in range(4)]


def _mask():
    mask = np.zeros((B, T), np.float32)
    mask[1, 21:] = -np.inf  # pad the tail of row 1, across a shard boundary
    return mask


def _gpt_inputs():
    params = to_numpy(random_gpt_params(jax_gpt.GPTLM(jax_gpt.GPTConfig(**GPT_CFG)), T, 5))
    rng = np.random.RandomState(6)
    ids, labels = (rng.randint(0, GPT_CFG["vocab_size"], (B, T)).astype(np.int32) for _ in range(2))
    return params, ids, labels


def _bert_inputs():
    params = to_numpy(random_distilbert_params(jax_distilbert.DistilBertEncoder(jax_distilbert.DistilBertConfig(**BERT_CFG)), T, 7))
    ids = np.random.RandomState(8).randint(0, 128, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 24:] = 0
    return params, ids, mask


def _collective_inputs(n):
    return np.random.RandomState(40 + n).randn(n, 4, 6).astype(np.float32)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    calls = []
    for i, (impl, n, masked, causal) in enumerate(ATTN_CASES):
        q, k, v, cot = _qkv_cot(i)
        calls.append((w.attention_rank, (impl, n, q, k, v, _mask() if masked else None, causal, cot)))
    q, k, v, cot = _qkv_cot(99)
    calls.append((w.attention_rank, ("ulysses", 4, q[:, :, :2], k[:, :, :2], v[:, :, :2], None, False, cot[:, :, :2])))
    params, ids, labels = _gpt_inputs()
    sd = {k: v.numpy() for k, v in gpt_state_dict_from_flax({"params": params}).items()}
    calls += [(w.gpt_sp_rank, (GPT_CFG, sd, ids, labels, n, impl)) for impl, n in MODEL_CASES]
    bparams, bids, bmask = _bert_inputs()
    bsd = {k: v.numpy() for k, v in distilbert_state_dict_from_flax({"params": bparams}).items()}
    calls += [(w.distilbert_sp_rank, (BERT_CFG, bsd, bids, bmask, n, impl)) for impl, n in MODEL_CASES]
    calls += [(w.collectives_rank, (_collective_inputs(n), n)) for n in (2, 4)]
    return torch_worker.spawn(torch_worker.run_all, 4, tmp_path_factory.mktemp("sp"), calls)


def _mesh(n):
    return jax_make_mesh(axis_sizes=(n,), axis_names=("seq",), devices=jax.devices()[:n])


def _gather(port, call, n, key):
    res = [port[r][call] for r in range(n)]
    assert [r["index"] for r in res] == list(range(n))
    return res


@pytest.mark.parametrize(
    "case", range(len(ATTN_CASES)),
    ids=[f"{i}-{n}-{'pad' if m else 'causal' if c else 'plain'}" for i, n, m, c in ATTN_CASES],
)
def test_attention_forward_and_gradients_match_jax(port, case):
    impl, n, masked, causal = ATTN_CASES[case]
    q, k, v, cot = (jnp.asarray(a) for a in _qkv_cot(case))
    mask = jnp.asarray(_mask()) if masked else None
    fn = jax_seq.ring_attention if impl == "ring" else jax_seq.ulysses_attention
    sp = P(None, "seq")

    def body(q, k, v, cot, *mask_):
        m = mask_[0] if mask_ else None
        out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, "seq", mask=m, causal=causal), q, k, v)
        return out, vjp(cot)

    args = (q, k, v, cot) + ((mask,) if masked else ())
    out, grads = jax.jit(
        jax.shard_map(body, mesh=_mesh(n), in_specs=(sp,) * len(args), out_specs=(sp, (sp, sp, sp)))
    )(*args)
    res = _gather(port, case, n, "out")
    np.testing.assert_allclose(torch.cat([r["out"] for r in res], 1).numpy(), np.asarray(out), rtol=TOL, atol=TOL)
    for name, g in zip("qkv", grads):
        got = torch.cat([r["grads"][name] for r in res], 1).numpy()
        np.testing.assert_allclose(got, np.asarray(g), rtol=TOL, atol=TOL, err_msg=name)


def test_ulysses_refuses_heads_the_shards_do_not_divide(port):
    for r in range(4):
        assert "must divide" in port[r][len(ATTN_CASES)]["error"]


@pytest.mark.parametrize("case", range(len(MODEL_CASES)), ids=[f"{i}-{n}" for i, n in MODEL_CASES])
def test_sequence_parallel_gpt_matches_jax(port, case):
    impl, n = MODEL_CASES[case]
    params, ids, labels = _gpt_inputs()
    model = jax_gpt.gpt_tiny(seq_axis="seq", seq_impl=impl, **GPT_CFG)

    def body(p, x, y):
        def loss(p):
            logits = model.apply({"params": p}, x)
            return jax.lax.pmean(jax_gpt.next_token_loss(logits, y), "seq"), logits

        (l, logits), g = jax.value_and_grad(loss, has_aux=True)(p)
        return l, logits, g

    sp = P(None, "seq")
    loss, logits, grads = jax.jit(
        jax.shard_map(body, mesh=_mesh(n), in_specs=(P(), sp, sp), out_specs=(P(), sp, P()))
    )(params, jnp.asarray(ids), jnp.asarray(labels))
    res = _gather(port, len(ATTN_CASES) + 1 + case, n, "logits")
    np.testing.assert_allclose(torch.cat([r["logits"] for r in res], 1).numpy(), np.asarray(logits), rtol=TOL, atol=TOL)
    want = gpt_state_dict_from_flax({"params": to_numpy(grads)})
    for r in res:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=TOL, atol=TOL)
        assert set(r["grads"]) == set(want)
        for name, g in want.items():
            np.testing.assert_allclose(r["grads"][name].numpy(), g.numpy(), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("case", range(len(MODEL_CASES)), ids=[f"{i}-{n}" for i, n in MODEL_CASES])
def test_sequence_parallel_distilbert_encoder_matches_jax(port, case):
    impl, n = MODEL_CASES[case]
    params, ids, mask = _bert_inputs()
    enc = jax_distilbert.DistilBertEncoder(jax_distilbert.DistilBertConfig(**BERT_CFG, seq_axis="seq", seq_impl=impl))
    sp = P(None, "seq")
    out = jax.jit(
        jax.shard_map(
            lambda p, i, m: enc.apply({"params": p}, i, m, deterministic=True),
            mesh=_mesh(n), in_specs=(P(), sp, sp), out_specs=sp,
        )
    )(params, jnp.asarray(ids), jnp.asarray(mask))
    res = _gather(port, len(ATTN_CASES) + 1 + len(MODEL_CASES) + case, n, "out")
    np.testing.assert_allclose(torch.cat([r["out"] for r in res], 1).numpy(), np.asarray(out), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_differentiable_collectives_match_jax(port, n):
    """ppermute (ring and shift), the tiled all-to-all and all-gather, and
    the gradient through each (the inverse permutation, the inverse
    all-to-all, a reduce-scatter) against ``lax``'s under ``shard_map``;
    the recorder's kinds and bytes."""
    x = _collective_inputs(n)
    weight = lambda y: jnp.arange(y.size, dtype=y.dtype).reshape(y.shape)  # noqa: E731

    def body(xl):
        xl = xl[0]

        def f(a):
            ring = jax.lax.ppermute(a, "a", [(j, (j + 1) % n) for j in range(n)])
            shifted = jax.lax.ppermute(a, "a", [(j, j + 1) for j in range(n - 1)])
            a2a = jax.lax.all_to_all(a, "a", 0, 1, tiled=True)
            gathered = jax.lax.all_gather(a, "a", axis=0, tiled=True)
            loss = ring.sum() + (2 * shifted).sum() + (a2a * weight(a2a)).sum() + (gathered * weight(gathered)).sum()
            return loss, (ring, shifted, a2a, gathered)

        (_, outs), g = jax.value_and_grad(f, has_aux=True)(xl)
        return tuple(o[None] for o in outs) + (g[None],)

    mesh = jax_make_mesh(axis_sizes=(n,), axis_names=("a",), devices=jax.devices()[:n])
    outs = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("a"), out_specs=(P("a"),) * 5))(jnp.asarray(x))
    call = len(ATTN_CASES) + 1 + 2 * len(MODEL_CASES) + (0 if n == 2 else 1)
    res = [port[r][call] for r in range(n)]
    for name, want in zip(("ring", "shifted", "a2a", "gathered", "grad"), outs):
        got = torch.stack([r[name] for r in res]).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL, err_msg=name)
    nbytes = 4 * 6 * 4
    assert res[0]["kinds"] == [
        ("collective-permute", nbytes), ("collective-permute", nbytes), ("all-to-all", nbytes),
        ("all-gather", n * nbytes), ("reduce-scatter", n * nbytes), ("all-to-all", nbytes),
        ("collective-permute", nbytes), ("collective-permute", nbytes),
    ]
