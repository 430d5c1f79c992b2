"""Rank functions for the PyTorch port's model-parallel tests (tensor,
sequence, pipeline and expert parallelism and their entry points).

Like ``torch_worker``, this module imports torch and the port, never jax,
so the ranks :func:`torch_worker.spawn` starts come up quickly. Each test
module spawns 4 ranks once and runs all its rank functions in them
(``torch_worker.run_all``). A case of fewer ranks runs on a mesh with a
leading ``rep`` axis (:func:`mesh_for`): the 4 ranks form independent
replicas of the smaller mesh, and each replica computes the case.
Inputs arrive as numpy arrays; results go back as tensors, dicts and
numbers (``torch.load(weights_only=True)`` reads them).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from network_distributed_pytorch_tpu_torch.experiments import gpt_moe, gpt_pp, gpt_sp, gpt_tp
from network_distributed_pytorch_tpu_torch.models import distilbert
from network_distributed_pytorch_tpu_torch.models.gpt import (
    GPTConfig,
    GPTLM,
    gpt_tp_param_specs,
    make_gpt_pipeline_train_fn,
    make_gpt_tp_stage_fn,
    next_token_loss,
    split_gpt_params,
    tp_gpt_forward,
    tp_shard,
    vocab_parallel_next_token_loss,
)
from network_distributed_pytorch_tpu_torch.models.import_weights import gpt_torch_name, powersgd_state_from_jax
from network_distributed_pytorch_tpu_torch.parallel.comm import (
    all_gather_tiled,
    all_reduce_mean,
    all_to_all,
    ppermute,
    record_collectives,
)
from network_distributed_pytorch_tpu_torch.parallel.mesh import make_mesh
from network_distributed_pytorch_tpu_torch.parallel.moe import switch_moe
from network_distributed_pytorch_tpu_torch.parallel.pipeline import make_pipeline_fn, make_pipeline_train_fn
from network_distributed_pytorch_tpu_torch.parallel.sequence import ring_attention, ulysses_attention
from network_distributed_pytorch_tpu_torch.parallel.tensor import tp_mlp
from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def mesh_for(world: int, sizes, names):
    """A mesh of ``sizes`` over every rank, with a leading ``rep`` axis of
    independent replicas when it needs fewer ranks than ``world``."""
    rep = world // math.prod(sizes)
    if rep > 1:
        return make_mesh((rep,) + tuple(sizes), ("rep",) + tuple(names))
    return make_mesh(tuple(sizes), tuple(names))


def _grads(loss, leaves):
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


# ---- collectives --------------------------------------------------------------


def collectives_rank(rank, world, group, x, n):
    """``ppermute`` (a ring, and a shift without wraparound),
    ``all_to_all`` and ``all_gather_tiled`` forward, and the gradient of a
    weighted sum of their outputs, on ``n`` ranks (rank-specific inputs
    ``x[index]``), with what ``record_collectives`` saw."""
    mesh = mesh_for(world, (n,), ("a",))
    g, i = mesh.group("a"), mesh.axis_index("a")
    xr = t(x[i]).requires_grad_(True)
    with record_collectives() as recs:
        ring = ppermute(xr, [(j, (j + 1) % n) for j in range(n)], g)
        shifted = ppermute(xr, [(j, j + 1) for j in range(n - 1)], g)
        a2a = all_to_all(xr, 0, 1, g)
        gathered = all_gather_tiled(xr, 0, g)
        weight = lambda y: torch.arange(y.numel(), dtype=y.dtype).view_as(y)  # noqa: E731
        loss = ring.sum() + (2 * shifted).sum() + (a2a * weight(a2a)).sum() + (gathered * weight(gathered)).sum()
        (gx,) = torch.autograd.grad(loss, [xr])
    return {"ring": ring.detach(), "shifted": shifted.detach(), "a2a": a2a.detach(), "gathered": gathered.detach(),
            "grad": gx, "index": i, "kinds": [(r.kind, r.payload_bytes) for r in recs]}


# ---- tensor parallelism -------------------------------------------------------


def tp_forward_rank(rank, world, group, cfg_kw, sd, ids, labels, n_model, vocab_parallel):
    """The TP decoder's loss, logits and every leaf's gradient on this
    rank's shards."""
    mesh = mesh_for(world, (n_model,), ("model",))
    g, i = mesh.group("model"), mesh.axis_index("model")
    cfg = GPTConfig(**cfg_kw)
    specs = gpt_tp_param_specs(cfg, vocab_parallel)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp_shard({k: t(v) for k, v in sd.items()}, specs, i, n_model).items()}
    with record_collectives() as recs:
        logits = tp_gpt_forward(cfg, leaves, t(ids).long(), g, vocab_parallel)
        y = t(labels).long()
        loss = vocab_parallel_next_token_loss(logits, y, g) if vocab_parallel else next_token_loss(logits, y)
        grads = _grads(loss, leaves)
    return {"loss": float(loss), "logits": logits.detach(), "grads": grads, "index": i,
            "kinds": sorted({r.kind for r in recs})}


def tp_mlp_rank(rank, world, group, x, w_up, b_up, w_down, b_down, n_model):
    """``tp_mlp`` on this rank's column and row shards: output and grads."""
    mesh = mesh_for(world, (n_model,), ("model",))
    g, i = mesh.group("model"), mesh.axis_index("model")
    # torch layout: the column shard is rows of (out, in), the row shard columns
    leaves = {
        "x": t(x).requires_grad_(True),
        "w_up": t(w_up).T.chunk(n_model, 0)[i].clone().requires_grad_(True),
        "b_up": t(b_up).chunk(n_model, 0)[i].clone().requires_grad_(True),
        "w_down": t(w_down).T.chunk(n_model, 1)[i].clone().requires_grad_(True),
        "b_down": t(b_down).requires_grad_(True),
    }
    out = tp_mlp(leaves["x"], leaves["w_up"], leaves["b_up"], leaves["w_down"], leaves["b_down"], g)
    return {"out": out.detach(), "grads": _grads((out ** 2).sum(), leaves), "index": i}


def vocab_ce_rank(rank, world, group, logits, labels, n_model):
    mesh = mesh_for(world, (n_model,), ("model",))
    g, i = mesh.group("model"), mesh.axis_index("model")
    shard = t(logits).chunk(n_model, -1)[i].clone().requires_grad_(True)
    loss = vocab_parallel_next_token_loss(shard, t(labels).long(), g)
    (grad,) = torch.autograd.grad(loss, [shard])
    return {"loss": float(loss), "grad": grad, "index": i}


# ---- sequence parallelism -------------------------------------------------------


def attention_rank(rank, world, group, impl, n, q, k, v, mask, causal, cot):
    """Ring or Ulysses attention on this rank's sequence block: output and
    the gradients of ``sum(out * cot)`` for q, k and v."""
    mesh = mesh_for(world, (n,), ("seq",))
    g, i = mesh.group("seq"), mesh.axis_index("seq")
    blk = q.shape[1] // n
    cut = lambda a: t(a)[:, i * blk : (i + 1) * blk].contiguous()  # noqa: E731
    leaves = {name: cut(a).requires_grad_(True) for name, a in (("q", q), ("k", k), ("v", v))}
    fn = ring_attention if impl == "ring" else ulysses_attention
    try:
        out = fn(leaves["q"], leaves["k"], leaves["v"], g, mask=None if mask is None else cut(mask), causal=causal)
    except ValueError as e:
        return {"error": str(e)}
    return {"out": out.detach(), "grads": _grads((out * cut(cot)).sum(), leaves), "index": i}


def gpt_sp_rank(rank, world, group, cfg_kw, sd, ids, labels, n, impl):
    """The sequence-parallel GPT: this rank's logits, the mean loss over
    the shards and the full-sequence gradients (local ones summed over the
    axis)."""
    mesh = mesh_for(world, (n,), ("seq",))
    g, i = mesh.group("seq"), mesh.axis_index("seq")
    model = GPTLM(GPTConfig(**cfg_kw, seq_axis=g, seq_impl=impl), device="cpu")
    model.load_state_dict({k: t(v) for k, v in sd.items()})
    blk = ids.shape[1] // n
    x, y = (t(a)[:, i * blk : (i + 1) * blk].long() for a in (ids, labels))
    logits = model(x)
    loss = next_token_loss(logits, y)
    leaves = dict(model.named_parameters())
    grads = _grads(loss / n, leaves)
    grads = {k: all_reduce_mean(v.contiguous(), g) * n for k, v in grads.items()}
    return {"logits": logits.detach(), "loss": float(all_reduce_mean(loss.detach().reshape(1), g)[0]),
            "grads": grads, "index": i}


def distilbert_sp_rank(rank, world, group, cfg_kw, sd, ids, mask, n, impl):
    """The sequence-parallel DistilBERT encoder's hidden states on this
    rank's block."""
    mesh = mesh_for(world, (n,), ("seq",))
    g, i = mesh.group("seq"), mesh.axis_index("seq")
    cfg = distilbert.DistilBertConfig(**cfg_kw, seq_axis=g, seq_impl=impl)
    enc = distilbert.DistilBertEncoder(cfg)
    enc.load_state_dict({k: t(v) for k, v in sd.items()})
    blk = ids.shape[1] // n
    out = enc(t(ids)[:, i * blk : (i + 1) * blk].long(), t(mask)[:, i * blk : (i + 1) * blk], deterministic=True)
    return {"out": out.detach(), "index": i}


# ---- pipeline parallelism -------------------------------------------------------


def toy_stage(p, x):
    """The JAX tests' stage: ``tanh(x @ w + b)``, ``w`` ``(DIM, DIM)``."""
    return torch.tanh(x @ p["w"] + p["b"])


def gpipe_rank(rank, world, group, stages, x, cot, m, n_stages, n_data):
    """GPipe forward of this rank's stage and the gradients of
    ``sum(out * cot)`` for its stage and the input."""
    sizes, names = ((n_data, n_stages), ("data", "pipe")) if n_data > 1 else ((n_stages,), ("pipe",))
    mesh = mesh_for(world, sizes, names)
    g, s = mesh.group("pipe"), mesh.axis_index("pipe")
    d = mesh.axis_index("data") if n_data > 1 else 0
    b = x.shape[0] // n_data
    xl = t(x)[d * b : (d + 1) * b].requires_grad_(True)
    leaves = {k: t(v)[None].requires_grad_(True) for k, v in stages[s].items()}
    out = make_pipeline_fn(toy_stage, g, m)(leaves, xl)
    grads = _grads((out * t(cot)[d * b : (d + 1) * b]).sum(), {**leaves, "x": xl})
    return {"out": out.detach(), "grads": grads, "stage": s, "data": d}


def onef1b_rank(rank, world, group, stages, x, y, m, n_stages, loss_params=None):
    """The 1F1B schedule on the toy stages with a mean-square loss; with
    ``loss_params`` a scaled loss (``loss_has_params``) and the input's
    gradient (``return_input_grads``)."""
    mesh = mesh_for(world, (n_stages,), ("pipe",))
    g, s = mesh.group("pipe"), mesh.axis_index("pipe")
    params = {k: t(v) for k, v in stages[s].items()}
    if loss_params is None:
        fn = make_pipeline_train_fn(toy_stage, lambda out, lab: torch.mean((out - lab) ** 2), g, m)
        loss, grads = fn(params, t(x), t(y))
        return {"loss": float(loss), "grads": grads, "stage": s}
    fn = make_pipeline_train_fn(
        toy_stage, lambda lp, out, lab: torch.mean((out * lp["scale"] - lab) ** 2), g, m,
        loss_has_params=True, return_input_grads=True,
    )
    loss, grads, dlp, dx = fn(params, {"scale": t(loss_params)}, t(x), t(y))
    return {"loss": float(loss), "grads": grads, "dlp": dlp, "dx": dx, "stage": s}


def pipeline_remat_rank(rank, world, group, stages, x, cot, y, m, n_stages):
    """GPipe's forward and gradients, and 1F1B's loss and gradients, on
    the toy stages with ``remat`` off and on: each run's results and how
    often the stage function ran (a remat run recomputes every call in
    the backward)."""
    mesh = mesh_for(world, (n_stages,), ("pipe",))
    g, s = mesh.group("pipe"), mesh.axis_index("pipe")
    out = {"stage": s}
    for remat in (False, True):
        calls = [0]

        def stage(p, a):
            calls[0] += 1
            return toy_stage(p, a)

        xl = t(x).requires_grad_(True)
        leaves = {k: t(v)[None].requires_grad_(True) for k, v in stages[s].items()}
        y_out = make_pipeline_fn(stage, g, m, remat=remat)(leaves, xl)
        grads = _grads((y_out * t(cot)).sum(), {**leaves, "x": xl})
        gpipe_calls = calls[0]
        fn = make_pipeline_train_fn(stage, lambda o, lab: torch.mean((o - lab) ** 2), g, m, remat=remat)
        loss, train_grads = fn({k: t(v) for k, v in stages[s].items()}, t(x), t(y))
        out[remat] = {
            "gpipe_out": y_out.detach(), "gpipe_grads": grads, "gpipe_calls": gpipe_calls,
            "loss": loss.detach(), "train_grads": train_grads, "train_calls": calls[0] - gpipe_calls,
        }
    return out


def gpt_pipeline_rank(rank, world, group, cfg_kw, sd, ids, labels, n_data, n_stages, n_model, m):
    """Full-model 1F1B GPT training gradients on a (data, pipe[, model])
    mesh, meaned over the data axis: the loss and this rank's embed, stage
    and final gradients."""
    cfg = GPTConfig(**cfg_kw)
    sizes, names = (n_data, n_stages, n_model), ("data", "pipe", "model")
    mesh = make_mesh(sizes, names) if math.prod(sizes) == world else mesh_for(world, sizes, names)
    pg, dg = mesh.group("pipe"), mesh.group("data")
    s, d, mi = mesh.axis_index("pipe"), mesh.axis_index("data"), mesh.axis_index("model")
    n_layers = cfg.n_layers
    params = {k: t(v) for k, v in sd.items()}
    if n_model > 1:
        params = tp_shard(params, gpt_tp_param_specs(cfg), mi, n_model)
        stage_fn = make_gpt_tp_stage_fn(cfg, n_layers // n_stages, mesh.group("model"))
    else:
        stage_fn = None
    embed, stages, final = split_gpt_params(params, n_stages)
    train = make_gpt_pipeline_train_fn(cfg, n_layers // n_stages, m, pg, stage_fn=stage_fn)
    b = ids.shape[0] // n_data
    x, y = (t(a)[d * b : (d + 1) * b].long() for a in (ids, labels))
    with record_collectives() as recs:
        loss, (ge, gs, gf) = train(embed, stages[s], final, x, y)
    mean = lambda tree: {k: all_reduce_mean(v.contiguous(), dg) for k, v in tree.items()}  # noqa: E731
    return {"loss": float(all_reduce_mean(loss.reshape(1), dg)[0]), "embed": mean(ge), "stage": mean(gs),
            "final": mean(gf), "pipe": s, "model": mi,
            "kinds": [(r.kind, r.payload_bytes) for r in recs]}


# ---- expert parallelism ---------------------------------------------------------


def toy_experts(p, tokens):
    """The JAX tests' expert, every local expert at once:
    ``tanh(t @ w1 + b1) @ w2 + b2``."""
    return torch.baddbmm(p["b2"][:, None], torch.tanh(torch.baddbmm(p["b1"][:, None], tokens, p["w1"])), p["w2"])


def moe_rank(rank, world, group, x, router, experts, capacity, top_k, n_dev, cot):
    """``switch_moe`` on this rank's tokens and experts (``n_dev`` ranks;
    0: the single-process path), with the gradients of ``sum(out * cot) +
    aux`` for the tokens, the router and the local experts."""
    if n_dev:
        mesh = mesh_for(world, (n_dev,), ("expert",))
        g, i = mesh.group("expert"), mesh.axis_index("expert")
    else:
        g, i, n_dev = None, 0, 1
    tl = x.shape[0] // n_dev
    el = next(iter(experts.values())).shape[0] // n_dev
    leaves = {"x": t(x)[i * tl : (i + 1) * tl].requires_grad_(True), "router": t(router).requires_grad_(True)}
    leaves.update({k: t(v)[i * el : (i + 1) * el].requires_grad_(True) for k, v in experts.items()})
    res = switch_moe(
        leaves["x"], leaves["router"], {k: leaves[k] for k in experts}, toy_experts, g, capacity, top_k
    )
    loss = (res.out * t(cot)[i * tl : (i + 1) * tl]).sum() + res.aux_loss
    return {"out": res.out.detach(), "aux": float(res.aux_loss), "dropped": float(res.dropped_fraction),
            "grads": _grads(loss, leaves), "index": i}


# ---- the entry points ----------------------------------------------------------


class _Named:
    """What ``powersgd_state_from_jax`` reads of a model: named parameters."""

    def __init__(self, named):
        self.named = named

    def named_parameters(self):
        return iter(self.named)


def carry_name(entry, path):
    """The carry's name of a JAX reducer's leaf path: gpt_tp's are the
    model's names; gpt_moe's reducer tree is ``{"0": base params, "1":
    routers}``; gpt_pp's groups are ``embed``, ``stage`` (the stacked
    ``layers``) and ``final``."""
    if entry == "gpt_tp":
        return gpt_torch_name(path)
    if entry == "stage":
        return "stage/" + gpt_torch_name(path[1:])
    if entry in ("embed", "final"):
        return f"{entry}/" + gpt_torch_name(path)
    if path[0] == "0":
        return "base/" + gpt_torch_name(path[1:])
    return f"router/h.{path[1][2:]}"


def jax_q(module, name, cfg_kw, carry, q):
    """The port's PowerSGD state (a list of them for gpt_pp's three groups)
    holding the JAX reducer's Q: ``q`` is ``(q_memory, tree)``, or a list
    of those for gpt_pp."""
    cfg = ExperimentConfig(**cfg_kw)
    if name != "gpt_pp":
        q_memory, tree = q
        names = list(carry.memories)  # the reduced leaves, in the run's order
        red = module.make_reducer(cfg, "powersgd", names)
        named = _Named([(k, carry.params[k]) for k in names])
        return powersgd_state_from_jax(q_memory, tree, red, named, name_map=functools.partial(carry_name, name))
    states = []
    for group, (q_memory, tree) in zip(gpt_pp.GROUPS, q):
        names = [k for k in carry.memories if k.startswith(group + "/")]
        named = _Named([(k, gpt_pp.reducer_layout(k, carry.params[k])) for k in names])
        red = gpt_pp.make_reducer(cfg, "powersgd", len(names))
        states.append(
            powersgd_state_from_jax(q_memory, tree, red, named, name_map=functools.partial(carry_name, group))
        )
    return states


def entry_rank(rank, world, group, name, cfg_kw, kwargs, state=None):
    """``<name>.run`` on the Gloo ranks, keeping the initial and final
    carries from its ``carry_loop``. ``state`` holds the weights to start
    from: ``{"sd": state dict}``, or for gpt_moe ``{"moe": (base, routers,
    experts by rank)}``; with ``"q"`` the PowerSGD reducer starts from the
    JAX reducer's Q (:func:`jax_q`), joined by name over the JAX reducer's
    leaves in its order."""
    module = {"gpt_tp": gpt_tp, "gpt_sp": gpt_sp, "gpt_pp": gpt_pp, "gpt_moe": gpt_moe}[name]
    kept = {}
    loop = module.carry_loop

    def keep(step, carry, *args, **kw):
        if state is not None and "q" in state:
            carry.reducer_state = jax_q(module, name, cfg_kw, carry, state["q"])
        kept["initial"] = {k: v.detach().clone() for k, v in carry.params.items()}
        carry, logger, audit = loop(step, carry, *args, **kw)
        kept["final"] = {k: v.detach().clone() for k, v in carry.params.items()}
        kept["audit"] = audit
        return carry, logger, audit

    module.carry_loop = keep
    try:
        kw = dict(kwargs)
        if state is not None and "sd" in state:
            kw["pretrained_state_dict"] = {k: t(v) for k, v in state["sd"].items()}
        if state is not None and "moe" in state:
            base, routers, experts = state["moe"]
            kw["pretrained"] = (
                {k: t(v) for k, v in base.items()}, {k: t(v) for k, v in routers.items()},
                {k: t(v) for k, v in experts[rank].items()},
            )
        out = module.run(ExperimentConfig(**cfg_kw), device="cpu", **kw)
    finally:
        module.carry_loop = loop
    return {"summary": out, **kept}
