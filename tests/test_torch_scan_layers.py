"""``GPTConfig.scan_layers`` in the port: the JAX package's stacked layout
(every block parameter one leaf ``(n_layers, ...)`` under
``h_scan.block``), on the CPU.

- The stacked model computes what the unrolled one does, bit for bit:
  the same blocks run on rows of the stacked leaves, so the logits and the
  (unstacked) gradients are equal, in fp32 and bf16, under remat too.
- ``stack_gpt_layer_params`` / ``unstack_gpt_layer_params`` on the port's
  names against the JAX functions on flax's (through
  ``gpt_state_dict_from_flax``, which maps the stacked layout), with the
  loud refusal of a wrong ``n_layers`` on both sides.
- The reducer: a stacked leaf is ONE matrix, as the JAX ``gpt_lm`` compresses
  its scanned flax leaves under ``matricize="last"`` (a stacked kernel
  ``(L, in, out)`` is ``(L * in, out)``), so the shape groups and bits
  equal the JAX reducer's, for the tiny GPT and for GPT-2 small from
  shapes alone.
- ``gpt_lm.run(scan_layers=True)`` against the JAX run: losses,
  parameters and bits, the initial Q carried by name
  (``powersgd_state_from_jax``), at the fp32 class TOL = 1e-5 of
  ``tests/test_torch_gpt.py``.
"""

import collections
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.parallel.mesh import make_mesh
from network_distributed_pytorch_tpu.parallel.reducers import PowerSGDReducer as JaxPowerSGD
from network_distributed_pytorch_tpu_torch.experiments import gpt_lm
from network_distributed_pytorch_tpu_torch.models import gpt
from network_distributed_pytorch_tpu_torch.models.import_weights import (
    gpt_state_dict_from_flax,
    gpt_torch_name,
    powersgd_state_from_jax,
)
from network_distributed_pytorch_tpu_torch.parallel.reducers import (
    PowerSGDReducer,
    embedding_leaves,
    layer_stacked_leaves,
)
from torch_parity import random_gpt_params, to_numpy
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

jax_gpt = importlib.import_module("network_distributed_pytorch_tpu.models.gpt")
jax_gpt_lm = importlib.import_module("network_distributed_pytorch_tpu.experiments.gpt_lm")

TOL = 1e-5
T = 16


def _pair(dtype=torch.float32, attn_impl="flash", remat=False, n_layers=3):
    """An unrolled tiny GPT and the scan_layers one from the same seed."""
    kw = dict(device="cpu", seed=2, dtype=dtype, attn_impl=attn_impl, remat=remat, n_layers=n_layers)
    return gpt.gpt_tiny(**kw), gpt.gpt_tiny(scan_layers=True, **kw)


@pytest.mark.parametrize(
    "dtype,attn_impl,remat",
    [(torch.float32, "flash", False), (torch.float32, "einsum", True), (torch.bfloat16, "flash", True)],
    ids=["fp32-flash", "fp32-einsum-remat", "bf16-flash-remat"],
)
def test_scan_layers_equals_unrolled_bitwise(dtype, attn_impl, remat):
    unrolled, scanned = _pair(dtype, attn_impl, remat)
    n = unrolled.config.n_layers
    assert {k: v.shape for k, v in scanned.state_dict().items()} == {
        k: v.shape for k, v in gpt.stack_gpt_layer_params(unrolled.state_dict(), n).items()
    }
    ids = torch.from_numpy(np.random.RandomState(4).randint(0, 128, (2, T + 1))).long()
    grads = {}
    for name, model in (("unrolled", unrolled), ("scanned", scanned)):
        loss = gpt.next_token_loss(model(ids[:, :-1]), ids[:, 1:])
        loss.backward()
        grads[name] = (loss.detach(), {k: p.grad for k, p in model.named_parameters()})
    assert torch.equal(grads["unrolled"][0], grads["scanned"][0])
    unstacked = gpt.unstack_gpt_layer_params(grads["scanned"][1])
    assert set(unstacked) == set(grads["unrolled"][1])
    for k, g in grads["unrolled"][1].items():
        assert torch.equal(g, unstacked[k]), k


def test_stack_and_unstack_match_jax():
    params = random_gpt_params(jax_gpt.gpt_tiny(), T, seed=6)
    n = jax_gpt.gpt_tiny().config.n_layers
    stacked = gpt_state_dict_from_flax({"params": to_numpy(jax_gpt.stack_gpt_layer_params(params, n))})
    unrolled = gpt_state_dict_from_flax({"params": to_numpy(params)})
    got = gpt.stack_gpt_layer_params(unrolled, n)
    assert set(got) == set(stacked) and any(k.startswith("h_scan.block.") for k in got)
    for k, v in stacked.items():
        assert torch.equal(got[k], v), k
    back = gpt.unstack_gpt_layer_params(got)
    jax_back = gpt_state_dict_from_flax({"params": to_numpy(jax_gpt.unstack_gpt_layer_params(
        jax_gpt.stack_gpt_layer_params(params, n)
    ))})
    assert set(back) == set(unrolled) == set(jax_back)
    for k, v in unrolled.items():
        assert torch.equal(back[k], v) and torch.equal(jax_back[k], v), k
    # a stacked model loads the JAX scanned layout and gives the unrolled logits
    model = gpt.gpt_tiny(device="cpu", scan_layers=True)
    model.load_state_dict(stacked)
    plain = gpt.gpt_tiny(device="cpu")
    plain.load_state_dict(unrolled)
    ids = torch.from_numpy(np.random.RandomState(7).randint(0, 128, (2, T))).long()
    assert torch.equal(model(ids), plain(ids))
    for wrong in (n - 1, n + 1):
        with pytest.raises(ValueError, match="n_layers"):
            gpt.stack_gpt_layer_params(unrolled, wrong)
        with pytest.raises(ValueError, match="n_layers"):
            jax_gpt.stack_gpt_layer_params(params, wrong)


def test_decoding_refuses_the_stacked_layout():
    _, scanned = _pair()
    with pytest.raises(ValueError, match="unrolled"):
        gpt.gpt_prefill(scanned, torch.zeros((1, 4), dtype=torch.long), 8)


def _groups(metas):
    return collections.Counter((m.n, m.m, m.r) for m in metas)


@pytest.mark.parametrize("preset", ["tiny", "gpt2_small"])
def test_stacked_leaves_are_the_jax_reducers_matrices(preset):
    """Each stacked leaf one matrix: the shape groups and bits of the JAX
    reducer over the scanned flax tree, from shapes alone (the port's model
    on ``device="meta"``)."""
    if preset == "tiny":
        jmodel, t, make = jax_gpt.gpt_tiny(scan_layers=True), T, gpt.gpt_tiny
        kw = {}
    else:
        jmodel, t, make = jax_gpt.gpt_small(vocab_size=1024, scan_layers=True), 1024, gpt.gpt_small
        kw = {"vocab_size": 1024}
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, t), jnp.int32)))["params"]
    jreducer = JaxPowerSGD(compression_rank=4, matricize="last")
    model = make(device="meta", scan_layers=True, **kw)
    params = list(model.parameters())
    reducer = PowerSGDReducer(
        compression_rank=4, matricize="last", features_last=embedding_leaves(model),
        layer_stacked=layer_stacked_leaves(model),
    )
    assert len(layer_stacked_leaves(model)) == 16  # every block parameter, stacked
    assert _groups(reducer._metas(params)) == _groups(jreducer._metas(jax.tree_util.tree_leaves(shapes)))
    assert reducer.bits_per_step(params) == jreducer.bits_per_step(shapes)
    if preset == "gpt2_small":
        # 48 (768, 768) q/k/v/out kernels are 4 matrices (9216, 768)
        assert _groups(reducer._metas(params))[(12 * 768, 768, 4)] == 4
        assert reducer.bits_per_step(params) < 25_575_424


@functools.lru_cache(maxsize=None)
def _jax_scan_run():
    """The JAX ``gpt_lm.run(scan_layers=True)`` at the small preset on one
    CPU device; its initial and final states and bits kept from its loop."""
    kept = {}
    train_loop = jax_gpt_lm.train_loop

    def keep(step, state, *args, **kwargs):
        kept["initial"] = state
        state, logger = train_loop(step, state, *args, **kwargs)
        kept.update(state=state, logger=logger, bits=step.bits_per_step)
        return state, logger

    jax_gpt_lm.train_loop = keep
    try:
        out = jax_gpt_lm.run(
            preset="small", mesh=make_mesh(devices=jax.devices()[:1]), max_steps_per_epoch=2, scan_layers=True
        )
    finally:
        jax_gpt_lm.train_loop = train_loop
    return out, kept


def test_gpt_lm_scan_layers_run_matches_jax(monkeypatch):
    jax_out, jax_kept = _jax_scan_run()
    unrolled_bits = gpt_lm.run(preset="small", max_steps_per_epoch=1, device="cpu")["bits_per_step"]
    params = to_numpy(jax_kept["initial"].params)
    assert "h_scan" in params
    kept = {}
    build = gpt_lm.build

    def keep(*args, **kwargs):
        model, step, state = build(*args, **kwargs)
        state.reducer_state = powersgd_state_from_jax(
            np.asarray(jax_kept["initial"].reducer_state.q_memory), params, step.reducer, model,
            name_map=gpt_torch_name,
        )
        kept["model"] = model
        return model, step, state

    monkeypatch.setattr(gpt_lm, "build", keep)
    out = gpt_lm.run(
        preset="small", max_steps_per_epoch=2, device="cpu", scan_layers=True,
        pretrained_state_dict=gpt_state_dict_from_flax({"params": params}),
    )
    assert out["scan_layers"] and out["steps"] == 2
    assert out["bits_per_step"] == jax_kept["bits"]  # + the loss's 32 on both sides
    assert out["bits_per_step"] < unrolled_bits
    np.testing.assert_allclose(out["losses"], [r.loss for r in jax_kept["logger"].records], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out["final_perplexity"], jax_out["final_perplexity"], rtol=TOL)
    want = gpt_state_dict_from_flax({"params": to_numpy(jax_kept["state"].params)})
    got = dict(kept["model"].named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), rtol=TOL, atol=TOL, err_msg=name)
