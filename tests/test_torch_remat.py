"""Rematerialisation in the port (``GPTConfig.remat``,
``DistilBertConfig.remat``, the pipeline schedules' ``remat``) against the
plain step and against the JAX package, on the CPU.

Each block under ``torch.utils.checkpoint`` (non-reentrant, the RNG state
preserved) recomputes the same operations on the same inputs in the
backward, so on the CPU a remat step's loss and gradients equal the plain
step's bit for bit, dropout included (the replay draws the same masks from
the restored generator). Flash attention's forward runs twice a step under
remat, and its backward reads the ``out`` and ``lse`` of the replay, which
the autograd function saved with ``ctx.save_for_backward``.

The JAX package's remat step equals its plain step, so the port's remat
gradients are held to the JAX remat model's at the fp32 class of
``tests/test_torch_gpt.py`` and ``tests/test_torch_distilbert.py``:
TOL = 1e-5. The pipeline's remat runs on 2 Gloo ranks (GPipe and 1F1B),
bitwise its plain schedule's, and GPipe's against the JAX
``make_pipeline_fn(remat=True)`` under ``shard_map`` at TOL.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

import torch_model_parallel_worker as w
import torch_worker
from network_distributed_pytorch_tpu.parallel.mesh import make_mesh as jax_make_mesh
from network_distributed_pytorch_tpu_torch.experiments import gpt_lm, powersgd_imdb
from network_distributed_pytorch_tpu_torch.models import distilbert, gpt
from network_distributed_pytorch_tpu_torch.models.import_weights import (
    distilbert_state_dict_from_flax,
    gpt_state_dict_from_flax,
)
from network_distributed_pytorch_tpu_torch.ops import flash_attention as fa
from torch_parity import random_distilbert_params, random_gpt_params, to_numpy
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

jax_gpt = importlib.import_module("network_distributed_pytorch_tpu.models.gpt")
jax_distilbert = importlib.import_module("network_distributed_pytorch_tpu.models.distilbert")
jax_pipe = importlib.import_module("network_distributed_pytorch_tpu.parallel.pipeline")

TOL = 1e-5
T = 16
N_STAGES, MICRO, DIM, B = 2, 4, 6, 8


def _gpt_loss(model, ids, deterministic):
    return gpt.next_token_loss(model(ids[:, :-1], deterministic=deterministic), ids[:, 1:])


def _distilbert_loss(model, batch, deterministic):
    ids, mask, labels = batch
    return F.cross_entropy(model(ids, mask, deterministic=deterministic), labels)


def _gpt_batch(seed=1):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, 128, (2, T + 1))).long()


def _distilbert_batch(seed=1):
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(3, 1024, (4, T))).long()
    mask = torch.ones((4, T), dtype=torch.long)
    mask[1, 10:] = 0
    return ids, mask, torch.tensor([0, 1, 1, 0])


def _step(model, loss_fn, batch, deterministic):
    """One forward and backward from a fixed generator state: the loss and
    every gradient."""
    torch.manual_seed(7)
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch, deterministic)
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


CASES = {
    # model, attention, dtype, dropout in training
    "gpt_flash_fp32": ("gpt", "flash", torch.float32, False),
    "gpt_flash_bf16": ("gpt", "flash", torch.bfloat16, False),
    "gpt_einsum_dropout": ("gpt", "einsum", torch.float32, True),
    "distilbert_flash_fp32": ("distilbert", "flash", torch.float32, False),
    "distilbert_einsum_dropout": ("distilbert", "einsum", torch.float32, True),
    "distilbert_einsum_dropout_bf16": ("distilbert", "einsum", torch.bfloat16, True),
}


def _models(name):
    kind, attn, dtype, dropout = CASES[name]
    if kind == "gpt":
        make = lambda remat: gpt.gpt_tiny(  # noqa: E731
            device="cpu", seed=3, attn_impl=attn, dtype=dtype, dropout=0.1 if dropout else 0.0, remat=remat
        )
        return make(False), make(True), _gpt_loss, _gpt_batch(), not dropout
    make = lambda remat: distilbert.distilbert_tiny(  # noqa: E731
        device="cpu", seed=3, attn_impl=attn, dtype=dtype, remat=remat
    )
    return make(False), make(True), _distilbert_loss, _distilbert_batch(), not dropout


@pytest.mark.parametrize("name", sorted(CASES))
def test_remat_step_equals_the_plain_step_bitwise(name):
    plain, remat, loss_fn, batch, deterministic = _models(name)
    assert remat.config.remat and not plain.config.remat
    loss, grads = _step(plain, loss_fn, batch, deterministic)
    remat_loss, remat_grads = _step(remat, loss_fn, batch, deterministic)
    assert torch.equal(loss, remat_loss)
    assert set(grads) == set(remat_grads)
    for k, g in grads.items():
        assert g.dtype == torch.float32, k
        assert torch.equal(g, remat_grads[k]), k
    if not deterministic:  # dropout drew masks: another generator state gives another loss
        torch.manual_seed(8)
        assert not torch.equal(loss_fn(plain, batch, deterministic).detach(), loss)


@pytest.mark.parametrize("kind", ["gpt", "distilbert"])
def test_flash_backward_reads_the_replayed_forward(kind, monkeypatch):
    """Under remat the flash forward runs twice a block (the step's
    forward, then the replay inside the backward), and each backward gets
    the ``out`` and ``lse`` of its block's replay, not of the first
    forward (kept alive here, so no storage is reused)."""
    plain, remat, loss_fn, batch, _ = _models(f"{kind}_flash_fp32")
    n_layers = remat.config.n_layers
    forwards, backwards = [], []
    fwd, vjp = fa.flash_attention_fwd, fa.flash_attention_vjp

    def counted_fwd(*args):
        out = fwd(*args)
        forwards.append(out)
        return out

    def counted_vjp(qf, kf, vf, mask, out, lse, *rest):
        backwards.append((out.data_ptr(), lse.data_ptr()))
        return vjp(qf, kf, vf, mask, out, lse, *rest)

    monkeypatch.setattr(fa, "flash_attention_fwd", counted_fwd)
    monkeypatch.setattr(fa, "flash_attention_vjp", counted_vjp)
    _step(plain, loss_fn, batch, True)
    assert (len(forwards), len(backwards)) == (n_layers, n_layers)
    forwards.clear(), backwards.clear()
    _step(remat, loss_fn, batch, True)
    assert (len(forwards), len(backwards)) == (2 * n_layers, n_layers)
    first = {(o.data_ptr(), l.data_ptr()) for o, l in forwards[:n_layers]}
    replays = [(o.data_ptr(), l.data_ptr()) for o, l in forwards[n_layers:]]
    # the backward walks the blocks last to first, each right after its replay
    assert backwards == replays and not first & set(backwards)


def _jax_gpt_grads(params, ids):
    model = jax_gpt.gpt_tiny(remat=True, attn_impl="einsum")

    def loss(p):
        return jax_gpt.next_token_loss(model.apply({"params": p}, jnp.asarray(ids[:, :-1])), jnp.asarray(ids[:, 1:]))

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), gpt_state_dict_from_flax({"params": to_numpy(grads)})


def _jax_distilbert_grads(params, ids, mask, labels):
    cfg = jax_distilbert.distilbert_tiny(remat=True).config
    model = jax_distilbert.DistilBertForSequenceClassification(cfg.__class__(**{**cfg.__dict__, "attn_impl": "einsum"}))

    def loss(p):
        logits = model.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask))
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), jnp.asarray(labels)[:, None], axis=-1))

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), distilbert_state_dict_from_flax({"params": to_numpy(grads)})


@pytest.mark.parametrize("kind", ["gpt", "distilbert"])
def test_remat_gradients_match_the_jax_remat_model(kind):
    if kind == "gpt":
        params = random_gpt_params(jax_gpt.gpt_tiny(), T, seed=5)
        ids = _gpt_batch(6).numpy().astype(np.int32)
        want_loss, want = _jax_gpt_grads(params, ids)
        model = gpt.gpt_tiny(device="cpu", remat=True, attn_impl="flash")
        model.load_state_dict(gpt_state_dict_from_flax({"params": to_numpy(params)}))
        loss = _gpt_loss(model, torch.from_numpy(ids).long(), True)
    else:
        params = random_distilbert_params(jax_distilbert.distilbert_tiny(), T, seed=5)
        ids, mask, labels = (x.numpy().astype(np.int32) for x in _distilbert_batch(6))
        want_loss, want = _jax_distilbert_grads(params, ids, mask, labels)
        model = distilbert.distilbert_tiny(device="cpu", remat=True, attn_impl="flash")
        model.load_state_dict(distilbert_state_dict_from_flax({"params": to_numpy(params)}))
        batch = tuple(torch.from_numpy(x).long() for x in (ids, mask, labels))
        loss = _distilbert_loss(model, batch, True)
    loss.backward()
    np.testing.assert_allclose(float(loss), want_loss, rtol=TOL, atol=TOL)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("experiment", ["gpt_lm", "powersgd_imdb"])
def test_entry_points_with_remat_equal_their_plain_runs(experiment):
    """``gpt_lm.run(remat=True)`` and ``powersgd_imdb.run(remat=True)``:
    the plain run's losses and bits, bit for bit."""
    mod = {"gpt_lm": gpt_lm, "powersgd_imdb": powersgd_imdb}[experiment]
    outs = {}
    for remat in (False, True):
        cfg = mod.default_config()
        cfg.training_epochs = 1
        outs[remat] = mod.run(cfg, preset="small", device="cpu", max_steps_per_epoch=2, remat=remat)
    assert outs[True]["remat"] and not outs[False]["remat"]
    assert outs[True]["losses"] == outs[False]["losses"]
    assert outs[True]["bits_per_step"] == outs[False]["bits_per_step"]


# ---- the pipeline's remat on two ranks -------------------------------------------


def _stages(seed=40):
    rng = np.random.RandomState(seed)
    return [
        {"w": (rng.randn(DIM, DIM) * 0.5).astype(np.float32), "b": (rng.randn(DIM) * 0.1).astype(np.float32)}
        for _ in range(N_STAGES)
    ]


def _arrays(seed=41):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, DIM).astype(np.float32) for _ in range(3)]  # x, cotangent, labels


@pytest.fixture(scope="module")
def pipeline_ranks(tmp_path_factory):
    x, cot, y = _arrays()
    calls = [(w.pipeline_remat_rank, (_stages(), x, cot, y, MICRO, N_STAGES))]
    return [r[0] for r in torch_worker.spawn(torch_worker.run_all, N_STAGES, tmp_path_factory.mktemp("remat"), calls)]


def test_pipeline_remat_equals_the_plain_schedules_bitwise(pipeline_ranks):
    """GPipe and 1F1B with ``remat``: the plain schedules' outputs, loss
    and gradients bit for bit, each stage call run again in the backward
    (GPipe: M + N - 1 ticks; 1F1B: M microbatches)."""
    for r in pipeline_ranks:
        plain, remat = r[False], r[True]
        assert torch.equal(plain["gpipe_out"], remat["gpipe_out"]) and torch.equal(plain["loss"], remat["loss"])
        for key in ("gpipe_grads", "train_grads"):
            for k, g in plain[key].items():
                assert torch.equal(g, remat[key][k]), (r["stage"], key, k)
        assert (plain["gpipe_calls"], remat["gpipe_calls"]) == (MICRO + N_STAGES - 1, 2 * (MICRO + N_STAGES - 1))
        assert (plain["train_calls"], remat["train_calls"]) == (MICRO, 2 * MICRO)


def test_pipeline_remat_matches_the_jax_remat_pipeline(pipeline_ranks):
    x, cot, _ = (jnp.asarray(a) for a in _arrays())
    stages = _stages()
    stacked = jax_pipe.stacked_stage_params([jax.tree_util.tree_map(jnp.asarray, s) for s in stages])
    mesh = jax_make_mesh(axis_sizes=(N_STAGES,), axis_names=("pipe",), devices=jax.devices()[:N_STAGES])

    def stage(p, a):
        return jnp.tanh(a @ p["w"] + p["b"])

    fwd = jax.shard_map(
        jax_pipe.make_pipeline_fn(stage, "pipe", MICRO, remat=True), mesh=mesh, in_specs=(P("pipe"), P()),
        out_specs=P(),
    )
    out, vjp = jax.vjp(jax.jit(fwd), stacked, x)
    g_stages, g_x = vjp(cot)
    for r in pipeline_ranks:
        got = r[True]
        np.testing.assert_allclose(got["gpipe_out"].numpy(), np.asarray(out), rtol=TOL, atol=TOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(
                got["gpipe_grads"][k][0].numpy(), np.asarray(g_stages[k][r["stage"]]), rtol=TOL, atol=TOL
            )
        if r["stage"] == 0:
            np.testing.assert_allclose(got["gpipe_grads"]["x"].numpy(), np.asarray(g_x), rtol=TOL, atol=TOL)
