"""Carry weights and PowerSGD state from the JAX package into the port.

``resnet_state_dict_from_flax`` maps the JAX ResNet's
``{"params", "batch_stats"}`` (numpy arrays) onto the port's ``state_dict``,
and the JAX ``SmallCNN``'s and ``MLP``'s ``{"params"}`` onto theirs:

- conv kernels HWIO -> OIHW;
- Dense kernels (in, out) -> Linear weights (out, in);
- BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
  running_var; GroupNorm scale / bias -> weight / bias.

``distilbert_state_dict_from_flax`` maps the JAX DistilBERT's ``{"params"}``
onto the port's (HuggingFace-named) ``state_dict``, the inverse of the JAX
package's ``distilbert_variables_from_torch``: Dense kernels (in, out) ->
Linear weights (out, in); Embed tables (num, dim) stay as they are, since
``nn.Embedding`` keeps the same layout; LayerNorm scale -> weight.

``gpt_state_dict_from_flax`` maps the JAX GPT's ``{"params"}`` onto the
port ``GPTLM``'s ``state_dict``: Dense kernels (in, out) -> Linear weights
(out, in); the tied ``wte`` and ``wpe`` tables (num, dim) as they are;
LayerNorm scale -> weight.

The model-parallel layouts, from the JAX package's parameters as numpy
arrays, so that both packages compute the same thing:

- ``gpt_tp_shard_from_jax``: one model rank's tensor-parallel shard of a
  GPT (``models.gpt.gpt_tp_param_specs``);
- ``gpt_pipeline_params_from_jax``: the pipeline split, the embedding,
  one stage's stacked blocks and the final LayerNorm
  (``models.gpt.split_gpt_params``);
- ``moe_params_from_jax``: the MoE GPT's base (no MLP leaves), routers
  and one rank's experts (``experiments/gpt_moe.py``).

``powersgd_state_from_jax`` maps the JAX ``PowerSGDState.q_memory`` onto the
port reducer's Q buffer. The two packages order their parameters
differently (``jax.tree_util`` flattens dicts by sorted key, so
``BottleneckBlock_10`` comes before ``BottleneckBlock_2``; torch keeps
registration order), so the Qs are joined by parameter name, never by flat
index (``name_map`` turns a flax path into the port's name: ResNet's by
default, :func:`distilbert_torch_name` for DistilBERT, :func:`gpt_torch_name`
for GPT). Both packages
matricize the same way under ``matricize="last"`` (embedding tables given
to the reducer as ``features_last``), so each Q carries over unchanged.

``train_state_from_jax`` writes a JAX ``TrainState`` (numpy leaves, read
by attribute) into rank ``r``'s port ``TrainState``: the replicated
params, momenta and PowerSGD Q as they are, and row ``r`` of the
per-worker memories and BatchNorm statistics, so both packages can resume
from one state.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..parallel.reducers import PowerSGDState
from .gpt import tp_shard

_BLOCK = re.compile(r"^(?:BasicBlock|BottleneckBlock)_(\d+)$")
_SUB = re.compile(r"^(Conv|BatchNorm|GroupNorm|Dense)_(\d+)$")
_SUB_NAMES = {"Conv": "conv", "BatchNorm": "norm", "GroupNorm": "norm", "Dense": "dense"}
_BN_FIELDS = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix=()) -> List[Tuple[Tuple[str, ...], np.ndarray]]:
    """Leaves with their key paths, in ``jax.tree_util`` order (sorted keys)."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            out.extend(_flatten(value, prefix + (key,)))
        else:
            out.append((prefix + (key,), np.asarray(value)))
    return out


def torch_name(path: Tuple[str, ...]) -> str:
    """The port's parameter or buffer name for a flax ResNet, SmallCNN or
    MLP variable path, e.g. ``("BottleneckBlock_3", "Conv_1", "kernel")`` ->
    ``"blocks.3.conv1.weight"``, ``("Dense_0", "bias")`` -> ``"dense0.bias"``."""
    *modules, leaf = path
    parts = []
    for mod in modules:
        block, sub = _BLOCK.match(mod), _SUB.match(mod)
        if block:
            parts += ["blocks", block.group(1)]
        elif sub:
            parts.append(_SUB_NAMES[sub.group(1)] + sub.group(2))
        else:
            parts.append(mod)  # conv_init, norm_init, conv_proj, norm_proj, head
    parts.append("weight" if leaf == "kernel" else _BN_FIELDS.get(leaf, leaf))
    return ".".join(parts)


def _to_torch_layout(value: np.ndarray) -> np.ndarray:
    if value.ndim == 4:  # conv kernel HWIO -> OIHW
        return value.transpose(3, 2, 0, 1)
    if value.ndim == 2:  # dense kernel (in, out) -> (out, in)
        return value.T
    return value


_LAYER = re.compile(r"^layer_(\d+)$")
_DISTILBERT_MODULES = {
    "word_embeddings": "embeddings.word_embeddings",
    "position_embeddings": "embeddings.position_embeddings",
    "embed_layer_norm": "embeddings.LayerNorm",
    "ffn_lin1": "ffn.lin1",
    "ffn_lin2": "ffn.lin2",
}
_DISTILBERT_LEAVES = {"kernel": "weight", "embedding": "weight", "scale": "weight", "bias": "bias"}


def distilbert_torch_name(path: Tuple[str, ...]) -> str:
    """The port's (HuggingFace) parameter name for a flax DistilBERT path,
    e.g. ``("distilbert", "layer_3", "ffn_lin1", "kernel")`` ->
    ``"distilbert.transformer.layer.3.ffn.lin1.weight"``."""
    *modules, leaf = path
    parts = []
    for mod in modules:
        layer = _LAYER.match(mod)
        if layer:
            parts += ["transformer", "layer", layer.group(1)]
        else:
            parts.append(_DISTILBERT_MODULES.get(mod, mod))
    parts.append(_DISTILBERT_LEAVES[leaf])
    return ".".join(parts)


def distilbert_state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{"params"}`` of ``DistilBertForSequenceClassification`` -> the
    port model's ``state_dict``. Also maps any params-shaped tree given as
    ``{"params": tree}`` (momenta, error memories, gradients)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables["params"]):
        if path[-1] == "kernel":  # Dense (in, out) -> Linear (out, in)
            value = value.T
        sd[distilbert_torch_name(path)] = torch.from_numpy(np.array(value, order="C", copy=True))
    return sd


_GPT_BLOCK = re.compile(r"^h_(\d+)$")
_GPT_LEAVES = {"kernel": "weight", "embedding": "weight", "scale": "weight", "bias": "bias"}


def gpt_torch_name(path: Tuple[str, ...]) -> str:
    """The port's parameter name for a flax GPT path, e.g.
    ``("h_3", "attn", "q_proj", "kernel")`` -> ``"h.3.attn.q_proj.weight"``,
    ``("wte", "embedding")`` -> ``"wte.weight"``."""
    *modules, leaf = path
    parts = []
    for mod in modules:
        block = _GPT_BLOCK.match(mod)
        parts += ["h", block.group(1)] if block else [mod]
    parts.append(_GPT_LEAVES[leaf])
    return ".".join(parts)


def gpt_state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{"params"}`` of ``GPTLM`` (the unrolled ``h_{i}`` layout) ->
    the port model's ``state_dict``. Also maps any params-shaped tree given
    as ``{"params": tree}`` (momenta, error memories, gradients)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables["params"]):
        if path[-1] == "kernel":  # Dense (in, out) -> Linear (out, in)
            value = value.T
        sd[gpt_torch_name(path)] = torch.from_numpy(np.array(value, order="C", copy=True))
    return sd


def gpt_tp_shard_from_jax(
    params: Mapping[str, Any], specs: Mapping[str, Optional[int]], coord: Tuple[int, int]
) -> Dict[str, torch.Tensor]:
    """Model rank ``coord = (index, n)``'s shard of a JAX ``GPTLM``'s
    ``params``: each port parameter cut along its ``specs`` dimension
    (None: whole), the ``index``-th of ``n`` slices."""
    index, n = coord
    return {k: v.clone() for k, v in tp_shard(gpt_state_dict_from_flax({"params": params}), specs, index, n).items()}


def gpt_pipeline_params_from_jax(
    embed: Mapping[str, Any], stacked: Mapping[str, Any], final: Mapping[str, Any], stage: int
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The JAX ``split_gpt_params`` pieces (``stacked`` with the stage axis
    of ``stacked_stage_params``: ``{"layers": {...}}``, leaves ``(S, L,
    ...)``) -> the port's ``(embed, stage's blocks, final)`` dicts for
    stage ``stage``, the blocks stacked on their layer axis: a kernel
    ``(L, in, out)`` becomes a weight ``(L, out, in)``."""
    e = gpt_state_dict_from_flax({"params": embed})
    f = gpt_state_dict_from_flax({"params": final})
    blocks: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(stacked["layers"]):
        value = np.asarray(value)[stage]
        if path[-1] == "kernel":
            value = value.swapaxes(-1, -2)
        blocks[gpt_torch_name(path)] = torch.from_numpy(np.array(value, order="C", copy=True))
    return e, blocks, f


def moe_params_from_jax(
    params: Mapping[str, Any], routers: Mapping[str, Any], experts: Mapping[str, Any], coord: Tuple[int, int]
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The JAX ``gpt_moe`` parameters -> the port's ``(base, routers,
    experts)`` for expert rank ``coord = (index, n)``: ``params`` (a
    ``GPTLM`` tree without MLP leaves) by the port's names, each block's
    ``(dim, E)`` router as it is (``h.{i}``), and rows ``index * E / n ..``
    of each stacked expert leaf, kept ``(E_local, in, out)``
    (``h.{i}.w_up``)."""
    index, n = coord
    base = gpt_state_dict_from_flax({"params": params})

    def tensor(a):
        return torch.from_numpy(np.array(a, order="C", copy=True))

    out_routers = {f"h.{k[2:]}": tensor(v) for k, v in routers.items()}
    out_experts = {}
    for k, leaves in experts.items():
        for leaf, v in leaves.items():
            v = np.asarray(v)
            per = v.shape[0] // n
            out_experts[f"h.{k[2:]}.{leaf}"] = tensor(v[index * per : (index + 1) * per])
    return base, out_routers, out_experts


def resnet_state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{"params"[, "batch_stats"]}`` -> the port ResNet's state_dict
    (either norm), or the port ``SmallCNN``'s or ``MLP``'s.

    Also maps any params-shaped tree given as ``{"params": tree}`` (momenta,
    error memories, gradients). With ``batch_stats`` every BatchNorm also
    gets ``num_batches_tracked = 0``, so ``load_state_dict`` is strict."""
    sd: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            sd[torch_name(path)] = torch.from_numpy(
                np.array(_to_torch_layout(value), order="C", copy=True)
            )
    if "batch_stats" in variables:
        for name in [k for k in sd if k.endswith(".running_mean")]:
            sd[name[: -len("running_mean")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd


def powersgd_state_from_jax(
    q_memory,
    flax_params: Mapping[str, Any],
    reducer,
    model,
    name_map: Callable[[Tuple[str, ...]], str] = torch_name,
):
    """The port's ``PowerSGDState`` whose Q buffers equal the JAX reducer's
    ``q_memory`` (a numpy array), joined by parameter name.

    ``flax_params`` gives the JAX leaf order and shapes; ``reducer`` is the
    port's ``PowerSGDReducer`` (``matricize="last"``, the same rank as the
    JAX one) and ``model`` the port model whose parameters it reduces;
    ``name_map`` names a flax path in the port."""
    if reducer.matricize != "last":
        raise ValueError("Q carries over only under matricize='last'")
    q_memory = np.asarray(q_memory)
    by_name: Dict[str, np.ndarray] = {}
    offset = 0
    for path, value in _flatten(flax_params):
        if value.ndim <= 1:
            continue
        m = value.shape[-1]
        n = math.prod(value.shape[:-1])
        r = min(n, m, reducer.compression_rank)
        by_name[name_map(path)] = q_memory[offset : offset + m * r].reshape(m, r)
        offset += m * r
    if offset != q_memory.size:
        raise ValueError(f"q_memory holds {q_memory.size} values, the parameters need {offset}")

    names, params = zip(*model.named_parameters())
    metas = reducer._metas(list(params))
    _, q_packer, _ = reducer._packers(list(params), metas)
    qs = []
    for meta in metas:
        q = by_name[names[meta.leaf_index]]
        if q.shape != (meta.m, meta.r):
            raise ValueError(f"{names[meta.leaf_index]}: Q {q.shape} vs ({meta.m}, {meta.r})")
        qs.append(torch.from_numpy(np.array(q, order="C", copy=True)))
    device = params[0].device
    state = reducer.init(list(params))
    return PowerSGDState(q_packer.pack(qs).to(device), state.generator)


def _row(tree: Mapping[str, Any], rank: int) -> Dict[str, Any]:
    """Row ``rank`` of every leaf of a per-worker tree."""
    return {k: _row(v, rank) if isinstance(v, Mapping) else np.asarray(v)[rank] for k, v in tree.items()}


@torch.no_grad()
def train_state_from_jax(
    jax_state: Any,
    rank: int,
    state,
    model,
    reducer=None,
    state_dict_from_flax: Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]] = resnet_state_dict_from_flax,
    name_map: Callable[[Tuple[str, ...]], str] = torch_name,
    world_axis: bool = True,
):
    """Write the JAX ``TrainState`` ``jax_state`` into rank ``rank``'s port
    ``TrainState`` ``state`` (built by ``model``'s training step) in place,
    and return ``state``.

    ``jax_state``'s leaves are numpy arrays; it is read by attribute
    (``params``, ``momenta``, ``memories``, ``reducer_state`` with its
    ``q_memory``, ``model_state`` with its ``batch_stats``). With
    ``world_axis`` its ``memories`` and ``model_state`` have the leading
    world axis of the JAX package's distributed step, and row ``rank`` is
    taken; without it they are one worker's. ``state_dict_from_flax``
    names and lays out a params-shaped tree in the port
    (:func:`resnet_state_dict_from_flax` for ResNets, ``SmallCNN`` and
    ``MLP``; :func:`gpt_state_dict_from_flax`,
    :func:`distilbert_state_dict_from_flax`), ``name_map`` a flax path for
    the Q buffer; ``reducer`` is the step's ``PowerSGDReducer`` (None: no
    Q). The port's ``num_batches_tracked`` has no flax counterpart and
    stays as it is."""

    def put(dst: Dict[str, torch.Tensor], tree: Optional[Mapping[str, Any]], collection: str = "params") -> None:
        if not dst or tree is None:
            return
        src = state_dict_from_flax({collection: tree})
        for name, value in src.items():
            if name in dst and not name.endswith("num_batches_tracked"):
                dst[name].copy_(value)

    put(state.params, jax_state.params)
    put(state.momenta, jax_state.momenta)
    per_worker = (lambda tree: _row(tree, rank)) if world_axis else (lambda tree: tree)
    put(state.memories, per_worker(jax_state.memories))
    stats = (jax_state.model_state or {}).get("batch_stats")
    if stats is not None:
        put(state.model_state, per_worker(stats), "batch_stats")
    if reducer is not None:
        q = powersgd_state_from_jax(jax_state.reducer_state.q_memory, jax_state.params, reducer, model, name_map)
        state.reducer_state.q_memory.copy_(q.q_memory)
    return state


def _flax_shape(torch_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The flax shape of a leaf of torch shape ``torch_shape``: the inverse
    of :func:`_to_torch_layout`'s transposes."""
    if len(torch_shape) == 4:  # OIHW -> HWIO
        o, i, h, w = torch_shape
        return (h, w, i, o)
    if len(torch_shape) == 2:  # (out, in) -> (in, out)
        return tuple(reversed(torch_shape))
    return tuple(torch_shape)


def fsdp_state_from_jax(jax_state: Any, model, world: int) -> List[Any]:
    """One port ``parallel.fsdp.FSDPState`` for each of ``world`` ranks
    from the JAX ``FSDPState`` ``jax_state`` (numpy leaves, read by
    attribute), so both packages start from one state: the parameter and
    momentum shards unsharded by the reference's rule (each ``(world,
    chunk)`` leaf flattened and cut to its size), mapped to the port's
    names and layouts by :func:`resnet_state_dict_from_flax` (ResNets,
    ``SmallCNN``, ``MLP``) and sharded again by the port's rule over the
    torch layout; row ``r`` of the per-worker BatchNorm statistics. The
    leaves' shapes come from ``model``'s parameters (read before a step
    releases them). ``opt_shards`` carries the momenta where the JAX
    optimizer state mirrors the parameter shards (``sgd``,
    ``sgd_nesterov``, ``sgd_plain``'s zeros) and is None for an optax
    state, which must be fresh (the port's step makes a fresh
    ``torch.optim`` optimizer)."""
    from ..parallel.fsdp import FSDPState, shard_params

    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}

    def full_tree(shards: Mapping[str, Any], prefix=()) -> Dict[str, Any]:
        out = {}
        for key, value in shards.items():
            path = prefix + (key,)
            if isinstance(value, Mapping):
                out[key] = full_tree(value, path)
            else:
                shape = _flax_shape(shapes[torch_name(path)])
                out[key] = np.asarray(value).reshape(-1)[: math.prod(shape)].reshape(shape)
        return out

    def torch_shards(shards: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        full = resnet_state_dict_from_flax({"params": full_tree(shards)})
        return shard_params({k: full[k] for k in shapes}, world)

    params = torch_shards(jax_state.param_shards)
    opt = jax_state.opt_shards
    mirrors = isinstance(opt, Mapping) and [p for p, _ in _flatten(opt)] == [p for p, _ in _flatten(jax_state.param_shards)]
    if mirrors:
        momenta = torch_shards(opt)
    elif any(np.any(np.asarray(leaf)) for leaf in _leaves_of(opt)):
        raise ValueError("an optax state carries over only fresh (all zeros): the port makes its own optimizer")
    stats = (jax_state.model_state or {}).get("batch_stats")
    states = []
    for r in range(world):
        buffers = resnet_state_dict_from_flax({"batch_stats": _row(stats, r)}) if stats is not None else {}
        states.append(FSDPState(
            {k: v[r].clone() for k, v in params.items()},
            {k: v[r].clone() for k, v in momenta.items()} if mirrors else None,
            buffers,
        ))
    return states


def _leaves_of(tree: Any) -> List[Any]:
    """Every array leaf of a tree of mappings, sequences and NamedTuples."""
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in _leaves_of(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves_of(v)]
    return [] if tree is None else [tree]
