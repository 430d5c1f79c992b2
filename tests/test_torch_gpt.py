"""The GPT slice against the JAX package, in fp32: ``GPTLM``'s logits on
both attention engines (flash against the JAX flash kernel in interpret
mode), causality, the KV-cache prefill and decode steps against a full
forward, greedy ``generate`` token for token (with ``eos_token_id`` and
``cache_len``), two ``ef_momentum`` PowerSGD steps with Q carried across,
``gpt_lm.run`` and ``gpt_generate.run`` at the small preset, the reducer's
bits for GPT-2 small, the config's slots and the launcher.

Weights are drawn with numpy and carried across by
``gpt_state_dict_from_flax``. Tolerances: fp32, 1e-5 for logits, losses,
parameters, momenta and error memories (the two frameworks sum the same
products in another order); 1e-5 for a decode step's logits against the
full forward's at the same position (the cache path's fp32 einsum against
the forward's attention). The two-step check holds every leaf at PowerSGD
rank 1, and at rank 4 (the experiment's) every leaf whose gradient has at
least the rank r the reducer gives it; Q there is held to Q_TOL_RANK4, since
P-hat's later columns follow M's smaller singular values, along which both
frameworks' fp32 rounding grows (as in ``test_torch_distilbert.py``).
"""

import collections
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.parallel.mesh import make_mesh
from network_distributed_pytorch_tpu.parallel.reducers import PowerSGDReducer as JaxPowerSGD
from network_distributed_pytorch_tpu.parallel.trainer import make_train_step as jax_make_train_step
from network_distributed_pytorch_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
from network_distributed_pytorch_tpu_torch.experiments import gpt_generate, gpt_lm
from network_distributed_pytorch_tpu_torch.models import gpt
from network_distributed_pytorch_tpu_torch.models.import_weights import (
    gpt_state_dict_from_flax,
    gpt_torch_name,
    powersgd_state_from_jax,
)
from network_distributed_pytorch_tpu_torch.parallel.reducers import PowerSGDReducer, embedding_leaves
from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step
from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig
from torch_parity import random_gpt_params, to_numpy
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

jax_gpt = importlib.import_module("network_distributed_pytorch_tpu.models.gpt")
jax_gpt_lm = importlib.import_module("network_distributed_pytorch_tpu.experiments.gpt_lm")
jax_gpt_generate = importlib.import_module("network_distributed_pytorch_tpu.experiments.gpt_generate")

TOL = 1e-5
Q_TOL_RANK4 = 5e-5  # see above
B, T = 2, 32  # logits, decoding
VOCAB = 128


def _jax_model(**overrides):
    return jax_gpt.gpt_tiny(**overrides)


def _port_model(params, **overrides):
    model = gpt.gpt_tiny(device="cpu", **overrides)
    model.load_state_dict(gpt_state_dict_from_flax({"params": to_numpy(params)}))
    return model


@functools.lru_cache(maxsize=None)
def _params(seed=1):
    return random_gpt_params(_jax_model(), T, seed)


def _ids(seed, b=B, t=T, vocab=VOCAB):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(np.int32)


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_logits_match_jax(attn_impl):
    params = _params()
    ids = _ids(2)
    jmodel = jax_gpt.GPTLM(dataclasses.replace(_jax_model().config, attn_impl=attn_impl))
    want = jmodel.apply({"params": params}, jnp.asarray(ids))
    model = _port_model(params, attn_impl=attn_impl)
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (B, T, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_later_tokens_leave_earlier_logits_unchanged(attn_impl):
    model = _port_model(_params(), attn_impl=attn_impl)
    ids = torch.from_numpy(_ids(3))
    changed = ids.clone()
    changed[:, 20:] = (changed[:, 20:] + 1) % VOCAB
    with torch.no_grad():
        a, b = model(ids), model(changed)
    assert torch.equal(a[:, :20], b[:, :20])
    assert not torch.allclose(a[:, 20:], b[:, 20:])


def test_tied_head_gradient_sums_both_uses():
    """``wte`` is the one table of the embedding and the head: its gradient
    is the sum of the gather's and the head's, as flax's ``wte.attend``
    gives it; ``embedding_leaves`` finds both tables."""
    params = _params()
    ids = _ids(4)
    jmodel = _jax_model()
    want = jax.grad(
        lambda p: jax_gpt.next_token_loss(jmodel.apply({"params": p}, jnp.asarray(ids[:, :-1])), jnp.asarray(ids[:, 1:]))
    )(params)["wte"]["embedding"]
    model = _port_model(params)
    tids = torch.from_numpy(ids).long()
    gpt.next_token_loss(model(tids[:, :-1]), tids[:, 1:]).backward()
    np.testing.assert_allclose(model.wte.weight.grad.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    names = [n for n, _ in model.named_parameters()]
    assert [names[i] for i in embedding_leaves(model)] == ["wte.weight", "wpe.weight"]


def test_prefill_and_decode_steps_match_full_forward():
    model = _port_model(_params())
    ids = torch.from_numpy(_ids(5)).long()
    with torch.no_grad():
        full = model(ids)
    t0 = 8
    logits, cache = gpt.gpt_prefill(model, ids[:, :t0], T)
    np.testing.assert_allclose(logits.numpy(), full[:, t0 - 1].numpy(), rtol=TOL, atol=TOL)
    for pos in range(t0, T):
        logits, cache = gpt.gpt_decode_step(model, cache, ids[:, pos], pos)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), rtol=TOL, atol=TOL, err_msg=f"pos {pos}")
    # every step from an empty cache, as the JAX package's own test runs it
    cache = gpt.init_gpt_cache(model.config, B, T, device="cpu")
    for pos in range(T):
        logits, cache = gpt.gpt_decode_step(model, cache, ids[:, pos], pos)
        np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), rtol=TOL, atol=TOL, err_msg=f"pos {pos}")


def test_prefill_and_decode_step_match_jax():
    params = _params()
    jcfg = _jax_model().config
    ids = _ids(6)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want_logits, want_cache = jax_gpt.gpt_prefill(jcfg, jparams, jnp.asarray(ids[:, :8]), T)
    want_step, want_cache = jax_gpt.gpt_decode_step(jcfg, jparams, want_cache, jnp.asarray(ids[:, 8]), 8)
    model = _port_model(params)
    logits, cache = gpt.gpt_prefill(model, torch.from_numpy(ids[:, :8]).long(), T)
    step, cache = gpt.gpt_decode_step(model, cache, torch.from_numpy(ids[:, 8]).long(), 8)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(step.numpy(), np.asarray(want_step), rtol=TOL, atol=TOL)
    for layer, want in zip(cache, want_cache):
        for name in ("k", "v"):
            np.testing.assert_allclose(layer[name].numpy(), np.asarray(want[name]), rtol=TOL, atol=TOL)


def test_decode_step_leaves_its_input_cache_unchanged():
    model = _port_model(_params())
    ids = torch.from_numpy(_ids(7)).long()
    _, cache = gpt.gpt_prefill(model, ids[:, :8], T)
    before = [{k: v.clone() for k, v in layer.items()} for layer in cache]
    _, new = gpt.gpt_decode_step(model, cache, ids[:, 8], 8)
    gpt.decode_tokens(model, cache, ids[:, 8], 8, 4)
    for old, layer, fresh in zip(before, cache, new):
        for name in ("k", "v"):
            assert torch.equal(old[name], layer[name])
            assert not torch.equal(fresh[name][:, 8], layer[name][:, 8])


GENERATE_CASES = {
    "greedy": {},
    "eos": {"eos_token_id": None},  # set to a token the greedy run emits
    "cache_len": {"cache_len": 64},
}


@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_greedy_generate_matches_jax(case):
    params = _params()
    jcfg = _jax_model().config
    prompt = _ids(8, t=12)
    new = 16
    kw = dict(GENERATE_CASES[case])
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    if "eos_token_id" in kw:
        plain = np.asarray(jax_gpt.generate(jcfg, jparams, jnp.asarray(prompt), new))
        kw["eos_token_id"] = int(plain[0, 3])  # row 0 stops at its 4th token
    want = np.asarray(jax_gpt.generate(jcfg, jparams, jnp.asarray(prompt), new, **kw))
    model = _port_model(params)
    got = gpt.generate(model, torch.from_numpy(prompt).long(), new, **kw)
    assert got.shape == (B, new)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "eos":
        assert (got[0, 3:] == kw["eos_token_id"]).all()


def test_sampling_draws_from_the_generator():
    """``temperature > 0`` draws with the given generator: the same seed
    gives the same ids, and every id is a token of the vocabulary."""
    model = _port_model(_params())
    prompt = torch.from_numpy(_ids(9, t=8)).long()
    draws = [
        gpt.generate(model, prompt, 12, temperature=1.0, generator=torch.Generator().manual_seed(seed))
        for seed in (0, 0, 1)
    ]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < VOCAB


# ---- two PowerSGD steps against the JAX trainer ---------------------------

STEP_B, STEP_T, STEP_LR = 4, 16, 0.1  # gpt_lm's lr


def _jax_loss(jmodel):
    def loss_fn(params, model_state, batch):
        x, y = batch
        return jax_gpt.next_token_loss(jmodel.apply({"params": params}, x), y), model_state

    return loss_fn


@functools.lru_cache(maxsize=None)
def _jax_two_steps(rank):
    jmodel = _jax_model(vocab_size=64, max_position_embeddings=STEP_T)
    params = random_gpt_params(jmodel, STEP_T, seed=3)
    step = jax_make_train_step(
        _jax_loss(jmodel), JaxPowerSGD(random_seed=1, compression_rank=rank, matricize="last"),
        params, STEP_LR, momentum=0.9, algorithm="ef_momentum", mesh=None, donate_state=False,
    )
    state = step.init_state(params)
    q0 = np.asarray(jax.device_get(state.reducer_state.q_memory))
    batches = list(gpt_lm.synthetic_lm_batches(64, STEP_B, STEP_T, 2, seed=11))
    states, losses = [], []
    for batch in batches:
        state, loss = step(state, tuple(jnp.asarray(a) for a in batch))
        states.append(state)
        losses.append(float(loss))
    return params, q0, batches, step, states, losses


def _rank_deficient(model, reducer, batch):
    names, params = zip(*model.named_parameters())
    gpt_lm.lm_loss()(model, tuple(torch.from_numpy(a) for a in batch)).backward()
    low = {
        names[m.leaf_index] for m in reducer._metas(list(params))
        if torch.linalg.matrix_rank(params[m.leaf_index].grad) < m.r
    }
    model.zero_grad(set_to_none=True)
    return low


@pytest.mark.parametrize("rank", [1, 4], ids=["rank1", "rank4"])
def test_two_ef_momentum_steps_match_jax(rank):
    """One worker, two PowerSGD ef_momentum steps from the same weights,
    batches and initial Q: after each step the loss, the parameters,
    momenta, error memories and Q of every leaf (none falls short of its
    rank here). The port runs flash attention (its plain version), the
    JAX step einsum (its ``"auto"`` off the TPU)."""
    params, q0, batches, jstep, jstates, jlosses = _jax_two_steps(rank)
    model = _port_model(params, vocab_size=64, max_position_embeddings=STEP_T)
    reducer = PowerSGDReducer(
        random_seed=1, compression_rank=rank, matricize="last", features_last=embedding_leaves(model)
    )
    assert not any(_rank_deficient(model, reducer, b) for b in batches)
    step = make_train_step(gpt_lm.lm_loss(), reducer, model, STEP_LR, 0.9, "ef_momentum")
    assert step.bits_per_step == jstep.bits_per_step
    state = step.init_state()
    state.reducer_state = powersgd_state_from_jax(q0, params, reducer, model, name_map=gpt_torch_name)
    names, leaves = zip(*model.named_parameters())
    metas = reducer._metas(list(leaves))
    _, q_packer, _ = reducer._packers(list(leaves), metas)
    for i, (batch, jstate, jloss) in enumerate(zip(batches, jstates, jlosses)):
        state, loss = step(state, tuple(torch.from_numpy(a) for a in batch))
        np.testing.assert_allclose(float(loss), jloss, rtol=TOL, atol=TOL, err_msg=f"loss of step {i}")
        for what in ("params", "momenta", "memories"):
            want = gpt_state_dict_from_flax({"params": to_numpy(getattr(jstate, what))})
            got = getattr(state, what)
            assert set(got) == set(want)
            for name in sorted(want):
                np.testing.assert_allclose(
                    got[name].detach().numpy(), want[name].numpy(), rtol=TOL, atol=TOL,
                    err_msg=f"step {i}: {what} {name}",
                )
        q_want = powersgd_state_from_jax(
            np.asarray(jstate.reducer_state.q_memory), params, reducer, model, name_map=gpt_torch_name
        ).q_memory
        q_tol = TOL if rank == 1 else Q_TOL_RANK4
        for meta, got, want in zip(metas, q_packer.unpack(state.reducer_state.q_memory), q_packer.unpack(q_want)):
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=q_tol, atol=q_tol, err_msg=f"step {i}: Q {names[meta.leaf_index]}"
            )


def test_gpt_small_bits_per_step_match_jax():
    """GPT-2 small at vocabulary 1024, 1024 positions, rank 4: the port's
    shape groups and bits equal the JAX reducer's, from shapes alone (the
    JAX model through ``jax.eval_shape``, the port's on the meta device)."""
    jmodel = jax_gpt.gpt_small(vocab_size=1024)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 1024), jnp.int32)))["params"]
    jreducer = JaxPowerSGD(compression_rank=4, matricize="last")
    want_groups = collections.Counter((m.n, m.m, m.r) for m in jreducer._metas(jax.tree_util.tree_leaves(shapes)))
    model = gpt.gpt_small(device="meta", vocab_size=1024)
    params = list(model.parameters())
    reducer = PowerSGDReducer(compression_rank=4, matricize="last", features_last=embedding_leaves(model))
    groups = collections.Counter((m.n, m.m, m.r) for m in reducer._metas(params))
    assert sum(p.numel() for p in params) == 86_628_864
    assert groups == want_groups == {
        (1024, 768, 4): 2, (768, 768, 4): 48, (768, 3072, 4): 12, (3072, 768, 4): 12,
    }
    assert reducer.bits_per_step(params) == jreducer.bits_per_step(shapes) == 25_575_424
    assert reducer.n_shape_groups(params) == 4


# ---- the entry points against the JAX runs ---------------------------------


@functools.lru_cache(maxsize=None)
def _jax_gpt_lm_run(reducer):
    """The JAX ``gpt_lm.run`` at the small preset on one CPU device; its
    initial and final states are kept from the run's own training loop."""
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
            preset="small", mesh=make_mesh(devices=jax.devices()[:1]), reducer=reducer, max_steps_per_epoch=2
        )
    finally:
        jax_gpt_lm.train_loop = train_loop
    return out, kept


@pytest.mark.parametrize("reducer", ["powersgd", "exact"])
def test_gpt_lm_run_matches_jax_run(reducer, monkeypatch):
    jax_out, jax_kept = _jax_gpt_lm_run(reducer)
    params = to_numpy(jax_kept["initial"].params)
    kept = {}
    build = gpt_lm.build

    def keep(*args, **kwargs):
        model, step, state = build(*args, **kwargs)
        if reducer == "powersgd":  # the JAX reducer's initial Q
            state.reducer_state = powersgd_state_from_jax(
                np.asarray(jax_kept["initial"].reducer_state.q_memory), params, step.reducer, model,
                name_map=gpt_torch_name,
            )
        kept["model"] = model
        return model, step, state

    monkeypatch.setattr(gpt_lm, "build", keep)
    out = gpt_lm.run(
        preset="small", reducer=reducer, max_steps_per_epoch=2, device="cpu",
        pretrained_state_dict=gpt_state_dict_from_flax({"params": params}),
    )
    assert out["steps"] == 2 and out["num_devices"] == 1 and out["tokens_per_step"] == 32 * 64
    assert out["bits_per_step"] == jax_kept["bits"]  # + the loss's 32 on both sides
    np.testing.assert_allclose(out["losses"], [r.loss for r in jax_kept["logger"].records], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out["final_perplexity"], jax_out["final_perplexity"], rtol=TOL)
    want = gpt_state_dict_from_flax({"params": to_numpy(jax_kept["state"].params)})
    got = dict(kept["model"].named_parameters())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), rtol=TOL, atol=TOL, err_msg=name)


def test_synthetic_batches_match_jax():
    got = list(gpt_lm.synthetic_lm_batches(64, 4, 16, 3, seed=7))
    want = list(jax_gpt_lm.synthetic_lm_batches(64, 4, 16, 3, seed=7))
    for (x, y), (jx, jy) in zip(got, want):
        assert x.dtype == np.int32
        np.testing.assert_array_equal(x, np.asarray(jx))
        np.testing.assert_array_equal(y, np.asarray(jy))


def test_gpt_generate_run_matches_jax_run():
    """The JAX ``gpt_generate.run`` at the small preset and the port's from
    the same weights and prompt: the same greedy tokens."""
    kw = dict(preset="small", batch=4, prompt_len=8, max_new_tokens=12)
    cfg = JaxExperimentConfig()
    want = jax_gpt_generate.run(cfg, **kw)
    total = kw["prompt_len"] + kw["max_new_tokens"]
    jmodel = jax_gpt.gpt_tiny(vocab_size=64, max_position_embeddings=total)
    params = jmodel.init(jax.random.PRNGKey(cfg.seed), jnp.zeros((1, total), jnp.int32))["params"]
    prompt = jax.random.randint(jax.random.PRNGKey(cfg.seed + 1), (kw["batch"], kw["prompt_len"]), 0, 64)
    got = gpt_generate.run(
        ExperimentConfig(), **kw, device="cpu", reps=1,
        pretrained_state_dict=gpt_state_dict_from_flax({"params": to_numpy(params)}),
        prompt=torch.from_numpy(np.array(prompt)),
    )
    assert got["sample_head"] == want["sample_head"]
    assert set(want) - {"device"} <= set(got)
    assert got["prefill_ms"] > 0 and got["decode_ms_per_token"] > 0 and got["generate_tokens_per_sec"] > 0


# ---- options, the launcher ---------------------------------------------------


def test_config_slots_and_dtypes():
    # remat and scan_layers are ported: the unrolled model's weights and logits
    ids = torch.from_numpy(_ids(9, t=8))
    plain = gpt.gpt_tiny(device="cpu", seed=3)
    for field in ({"remat": True}, {"scan_layers": True}):
        model = gpt.gpt_tiny(device="cpu", seed=3, **field)
        assert all(getattr(model.config, k) for k in field)
        assert torch.equal(model(ids), plain(ids))
    # sequence parallelism is ported: any group and either schedule
    assert gpt.GPTConfig(seq_axis=object(), seq_impl="ulysses").seq_impl == "ulysses"
    with pytest.raises(ValueError, match="seq_impl"):
        gpt.GPTConfig(seq_impl="pallas")
    out = gpt_lm.run(preset="small", device="cpu", remat=True, scan_layers=True, max_steps_per_epoch=1)
    assert out["remat"] and out["scan_layers"] and np.isfinite(out["losses"]).all()
    with pytest.raises(ValueError):
        gpt.GPTConfig(dtype=torch.float16)
    with pytest.raises(ValueError):
        gpt.GPTConfig(attn_impl="pallas")
    assert gpt.GPTConfig(dtype=torch.bfloat16).dtype == torch.bfloat16
    assert ExperimentConfig(compute_dtype="bfloat16").compute_dtype == "bfloat16"
    with pytest.raises(ValueError):
        ExperimentConfig(compute_dtype="float16")


@pytest.mark.parametrize(
    "experiment,extra",
    [("gpt_lm", ["--epochs", "1", "--max-steps-per-epoch", "2"]), ("gpt_generate", ["--max-new-tokens", "8"])],
)
def test_launcher_runs_gpt_on_cpu(experiment, extra, capsys):
    from network_distributed_pytorch_tpu_torch import launch

    out = launch.main([experiment, "--device", "cpu", "--dtype", "bfloat16", "--json", *extra])
    assert out["experiment"] == experiment and out["compute_dtype"] == "bfloat16"
    if experiment == "gpt_lm":
        assert out["steps"] == 2 and np.isfinite(out["losses"]).all() and out["final_perplexity"] > 1
    else:
        assert out["max_new_tokens"] == 8 and len(out["sample_head"]) == 8
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")


@pytest.mark.parametrize(
    "args",
    [["gpt_lm", "--max-new-tokens", "4"], ["powersgd_imdb", "--temperature", "1.0"], ["bare_init", "--dtype", "bfloat16"]],
)
def test_launcher_refuses_flags_an_experiment_does_not_take(args):
    from network_distributed_pytorch_tpu_torch import launch

    with pytest.raises(ValueError, match=args[1]):
        launch.main([*args, "--device", "cpu"])


def test_entry_points_raise_without_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt_lm.run(preset="small", max_steps_per_epoch=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt_generate.run(preset="small", max_new_tokens=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt.gpt_tiny()
