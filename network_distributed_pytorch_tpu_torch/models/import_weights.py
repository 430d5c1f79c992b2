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

``powersgd_state_from_jax`` maps the JAX ``PowerSGDState.q_memory`` onto the
port reducer's Q buffer. The two packages order their parameters
differently (``jax.tree_util`` flattens dicts by sorted key, so
``BottleneckBlock_10`` comes before ``BottleneckBlock_2``; torch keeps
registration order), so the Qs are joined by parameter name, never by flat
index (``name_map`` turns a flax path into the port's name: ResNet's by
default, :func:`distilbert_torch_name` for DistilBERT). Both packages
matricize the same way under ``matricize="last"`` (embedding tables given
to the reducer as ``features_last``), so each Q carries over unchanged.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..parallel.reducers import PowerSGDState

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
