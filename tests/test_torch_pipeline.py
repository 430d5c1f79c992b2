"""Pipeline parallelism in the port against the JAX package: GPipe's
forward and its gradients (at 2 and 4 stages, 2 and 4 microbatches, and
with a data axis), the 1F1B schedule's loss and gradients (more and fewer
microbatches than stages, the loss parameters' and the input's
gradients), and the GPT's full-model 1F1B gradients at 2 and 4 stages,
with a data axis, and the 3-D data x pipe x model composition at 1 x 2 x 2
(``tests/test_3d_gpt.py``).

The JAX functions run under ``shard_map`` on the conftest's CPU devices;
the port's in 4 Gloo ranks spawned once for the module (a smaller mesh
runs as replicas). Inputs and weights come from numpy seeds. Tolerance
1e-5 relative and absolute (``tests/test_torch_gpt.py``).
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

jax_pipe = importlib.import_module("network_distributed_pytorch_tpu.parallel.pipeline")
jax_gpt = importlib.import_module("network_distributed_pytorch_tpu.models.gpt")

TOL = 1e-5
B, DIM = 16, 6
GPIPE_CASES = [(2, 2, 1), (4, 4, 1), (4, 2, 1), (2, 2, 2)]  # stages, microbatches, data shards
ONEF1B_CASES = [(2, 2, False), (4, 4, False), (4, 2, False), (2, 8, False), (4, 4, True)]  # + loss params
GPT_CFG = dict(vocab_size=64, max_position_embeddings=16, dim=16, n_layers=4, n_heads=2, hidden_dim=32, dropout=0.0)
GPT_CASES = [(1, 2, 1, 2), (1, 4, 1, 4), (2, 2, 1, 2), (1, 2, 2, 2)]  # data, pipe, model, microbatches
GB, GT = 8, 16


def _stages(n, seed):
    rng = np.random.RandomState(seed)
    return [
        {"w": (rng.randn(DIM, DIM) * 0.5).astype(np.float32), "b": (rng.randn(DIM) * 0.1).astype(np.float32)}
        for _ in range(n)
    ]


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _gpt_inputs():
    params = to_numpy(random_gpt_params(jax_gpt.GPTLM(jax_gpt.GPTConfig(**GPT_CFG)), GT, 11))
    rng = np.random.RandomState(12)
    ids, labels = (rng.randint(0, 64, (GB, GT)).astype(np.int32) for _ in range(2))
    return params, ids, labels


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    calls = []
    for i, (n, m, d) in enumerate(GPIPE_CASES):
        x, cot = _arrays(i, (B, DIM), (B, DIM))
        calls.append((w.gpipe_rank, (_stages(n, 10 + i), x, cot, m, n, d)))
    for i, (n, m, lp) in enumerate(ONEF1B_CASES):
        x, y = _arrays(20 + i, (32, DIM), (32, DIM))
        calls.append((w.onef1b_rank, (_stages(n, 30 + i), x, y, m, n, np.float32(1.5) if lp else None)))
    params, ids, labels = _gpt_inputs()
    sd = {k: v.numpy() for k, v in gpt_state_dict_from_flax({"params": params}).items()}
    calls += [(w.gpt_pipeline_rank, (GPT_CFG, sd, ids, labels, d, p, mo, m)) for d, p, mo, m in GPT_CASES]
    return torch_worker.spawn(torch_worker.run_all, 4, tmp_path_factory.mktemp("pp"), calls)


def _stacked(stages):
    return jax_pipe.stacked_stage_params([jax.tree_util.tree_map(jnp.asarray, s) for s in stages])


def _toy_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("case", range(len(GPIPE_CASES)), ids=[f"s{n}-mb{m}-d{d}" for n, m, d in GPIPE_CASES])
def test_gpipe_forward_and_gradients_match_jax(port, case):
    n, m, d = GPIPE_CASES[case]
    stages = _stages(n, 10 + case)
    x, cot = (jnp.asarray(a) for a in _arrays(case, (B, DIM), (B, DIM)))
    names = ("data", "pipe") if d > 1 else ("pipe",)
    mesh = jax_make_mesh(axis_sizes=(d, n)[-len(names):], axis_names=names, devices=jax.devices()[: n * d])
    batch = P("data") if d > 1 else P()
    fwd = jax.shard_map(
        jax_pipe.make_pipeline_fn(_toy_stage, "pipe", m), mesh=mesh, in_specs=(P("pipe"), batch), out_specs=batch
    )

    @jax.jit
    def fwd_bwd(st, x, cot):
        out, vjp = jax.vjp(fwd, st, x)
        return out, vjp(cot)

    out, (g_stages, g_x) = fwd_bwd(_stacked(stages), x, cot)
    res = [r[case] for r in port]
    for r in res:
        b = B // d
        _close(r["out"], out[r["data"] * b : (r["data"] + 1) * b])
        # each data shard's stage gradient is its own batch's part
        for k in ("w", "b"):
            assert r["grads"][k].shape[0] == 1
    # stage gradients summed over the data shards = JAX's (differentiated through the data sharding)
    for s in range(n):
        for k in ("w", "b"):
            got = sum(r["grads"][k][0] for r in res[: n * d] if r["stage"] == s)
            _close(got, g_stages[k][s], f"stage {s} {k}")
    got_x = torch.cat([next(r["grads"]["x"] for r in res if r["data"] == j and r["stage"] == 0) for j in range(d)])
    _close(got_x, g_x)


@pytest.mark.parametrize("case", range(len(ONEF1B_CASES)), ids=[f"s{n}-mb{m}{'-lp' if lp else ''}" for n, m, lp in ONEF1B_CASES])
def test_1f1b_loss_and_gradients_match_jax(port, case):
    n, m, lp = ONEF1B_CASES[case]
    stages = _stages(n, 30 + case)
    x, y = (jnp.asarray(a) for a in _arrays(20 + case, (32, DIM), (32, DIM)))
    mesh = jax_make_mesh(axis_sizes=(n,), axis_names=("pipe",), devices=jax.devices()[:n])
    if lp:
        fn = jax_pipe.make_pipeline_train_fn(
            _toy_stage, lambda lp_, out, lab: jnp.mean((out * lp_["scale"] - lab) ** 2), "pipe", m,
            loss_has_params=True, return_input_grads=True,
        )
        loss, grads, dlp, dx = jax.jit(
            jax.shard_map(fn, mesh=mesh, in_specs=(P("pipe"), P(), P(), P()), out_specs=(P(), P("pipe"), P(), P()))
        )(_stacked(stages), {"scale": jnp.float32(1.5)}, x, y)
    else:
        fn = jax_pipe.make_pipeline_train_fn(_toy_stage, lambda out, lab: jnp.mean((out - lab) ** 2), "pipe", m)
        loss, grads = jax.jit(
            jax.shard_map(fn, mesh=mesh, in_specs=(P("pipe"), P(), P()), out_specs=(P(), P("pipe")))
        )(_stacked(stages), x, y)
    base = len(GPIPE_CASES)
    res = [r[base + case] for r in port[:n]]
    for r in res:
        _close(r["loss"], loss)
        for k in ("w", "b"):
            _close(r["grads"][k], grads[k][r["stage"]], f"stage {r['stage']} {k}")
    if lp:
        _close(res[-1]["dlp"]["scale"], dlp["scale"])  # the last stage's own
        _close(res[0]["dx"], dx)  # stage 0's own
        assert float(res[0]["dlp"]["scale"]) == 0.0 and not res[-1]["dx"].any()


def _unstack(stage_grads, n_stages, per):
    return {
        f"h_{s * per + j}": jax.tree_util.tree_map(lambda a, s=s, j=j: np.asarray(a)[s, j], stage_grads["layers"])
        for s in range(n_stages)
        for j in range(per)
    }


def _tp_stage_specs():
    col = {"kernel": P("pipe", None, None, "model"), "bias": P("pipe", None, "model")}
    row = {"kernel": P("pipe", None, "model", None), "bias": P("pipe", None)}
    ln = {"scale": P("pipe", None), "bias": P("pipe", None)}
    return {"layers": {"ln_1": ln, "attn": {"q_proj": col, "k_proj": col, "v_proj": col, "out_proj": row},
                       "ln_2": ln, "mlp_fc": col, "mlp_proj": row}}


@pytest.mark.parametrize("case", range(len(GPT_CASES)), ids=[f"d{d}-p{p}-m{mo}-mb{m}" for d, p, mo, m in GPT_CASES])
def test_gpt_1f1b_full_model_gradients_match_jax(port, case):
    d, n, mo, m = GPT_CASES[case]
    params, ids, labels = _gpt_inputs()
    cfg = jax_gpt.GPTConfig(**GPT_CFG)
    per = cfg.n_layers // n
    embed, stages, final = jax_gpt.split_gpt_params(jax.tree_util.tree_map(jnp.asarray, params), n)
    stacked = jax_pipe.stacked_stage_params(stages)
    mesh = jax_make_mesh(
        axis_sizes=(d, n, mo), axis_names=("data", "pipe", "model"), devices=jax.devices()[: d * n * mo]
    )
    train = jax_gpt.make_gpt_pipeline_train_fn(
        cfg, per, m, params_varying_over=("data",),
        stage_fn=jax_gpt.make_gpt_tp_stage_fn(cfg, per) if mo > 1 else None,
    )

    def step(e, st, f, x, y):
        loss, grads = train(e, st, f, x, y)
        return jax.lax.pmean(loss, "data"), jax.tree_util.tree_map(lambda g: jax.lax.pmean(g, "data"), grads)

    sspec = _tp_stage_specs() if mo > 1 else P("pipe")
    loss, (ge, gs, gf) = jax.jit(
        jax.shard_map(
            step, mesh=mesh, in_specs=(P(), sspec, P(), P("data"), P("data")), out_specs=(P(), (P(), sspec, P())),
        )
    )(embed, stacked, final, jnp.asarray(ids), jnp.asarray(labels))
    want = gpt_state_dict_from_flax({"params": {**to_numpy(ge), **to_numpy(gf), **_unstack(gs, n, per)}})
    from network_distributed_pytorch_tpu_torch.models.gpt import GPTConfig, gpt_tp_param_specs

    specs = gpt_tp_param_specs(GPTConfig(**GPT_CFG))
    res = [r[len(GPIPE_CASES) + len(ONEF1B_CASES) + case] for r in port[: d * n * mo]]
    for r in res:
        _close(r["loss"], loss)
        for k in ("wte.weight", "wpe.weight"):
            _close(r["embed"][k], want[k], k)
        for k in ("ln_f.weight", "ln_f.bias"):
            _close(r["final"][k], want[k], k)
    for s in range(n):
        for j in range(per):
            for name in res[0]["stage"]:
                full = f"h.{s * per + j}.{name}"
                shards = [r["stage"][name][j] for r in sorted(res, key=lambda r: r["model"]) if r["pipe"] == s][:mo]
                dim = specs[full]
                got = torch.cat(shards, dim=dim) if dim is not None else shards[0]
                _close(got, want[full], full)
    # bits: an activation or its gradient a microbatch crosses each stage boundary
    kinds = [k for k, _ in res[0]["kinds"]]
    if n > 1:
        assert kinds.count("collective-permute") == m  # stage 0 sends its m activations right
