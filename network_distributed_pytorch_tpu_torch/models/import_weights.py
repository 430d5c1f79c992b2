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
LayerNorm scale -> weight. The ``scan_layers`` layout maps too: a stacked
kernel ``(L, in, out)`` under ``h_scan/block`` becomes the port's stacked
weight ``(L, out, in)`` under ``h_scan.block``.

Published checkpoints, the port's counterparts of the JAX package's
``resnet_variables_from_torch``, ``distilbert_variables_from_torch`` and
``gpt2_variables_from_torch``: each maps a state dict (tensors or numpy
arrays, already on disk: nothing here downloads, and nothing imports
``torchvision`` or ``transformers``) onto the port's names and layouts.

- :func:`resnet_state_dict_from_torchvision`: torchvision's ``conv1`` /
  ``bn1`` / ``layer{s}.{b}.conv{c}`` / ``downsample`` / ``fc`` -> the
  port's ``conv_init`` / ``norm_init`` / ``blocks.{i}.conv{c-1}`` /
  ``conv_proj``, ``norm_proj`` / ``head``; the layouts are torch's on both
  sides.
- :func:`distilbert_state_dict_from_hf`: HuggingFace's
  ``DistilBertForSequenceClassification`` names are the port's; its
  parameters are taken, its buffers (``position_ids``) left.
- :func:`gpt2_state_dict_from_hf`: ``GPT2LMHeadModel``'s ``Conv1D``
  weights are ``(in, out)`` and become the port's ``nn.Linear`` ``(out,
  in)``; the fused ``c_attn`` splits into ``q_proj``, ``k_proj`` and
  ``v_proj``; ``lm_head`` is tied to ``wte`` and is not carried.

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
from .gpt import stack_gpt_layer_params, tp_shard

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
    """flax ``{"params"}`` of ``GPTLM`` (the unrolled ``h_{i}`` layout, or
    ``scan_layers``' ``h_scan/block`` with its leading layer axis) -> the
    port model's ``state_dict``. Also maps any params-shaped tree given as
    ``{"params": tree}`` (momenta, error memories, gradients)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables["params"]):
        if path[-1] == "kernel":  # Dense (in, out) -> Linear (out, in), behind any layer axis
            value = value.swapaxes(-1, -2)
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


# ---- published checkpoints: torchvision and HuggingFace state dicts ----------


def _tensor(value) -> torch.Tensor:
    """A checkpoint entry (a tensor or a numpy array) as a contiguous CPU
    tensor of its own."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().contiguous().clone()
    return torch.from_numpy(np.array(value, order="C", copy=True))


_BN_ENTRIES = ("weight", "bias", "running_mean", "running_var")


def resnet_state_dict_from_torchvision(
    state_dict: Mapping[str, Any], stage_sizes, bottleneck: bool
) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet's ``state_dict`` -> the port ResNet's (BatchNorm
    norm; ``stage_sizes`` and ``bottleneck`` as the target model's:
    resnet18 ``[2, 2, 2, 2]`` / False, resnet50 ``[3, 4, 6, 3]`` / True,
    resnet152 ``[3, 8, 36, 3]`` / True). Every BatchNorm gets
    torchvision's ``num_batches_tracked``, or 0 where the checkpoint has
    none, so ``load_state_dict`` is strict."""
    sd = state_dict
    out: Dict[str, torch.Tensor] = {}

    def bn(dst: str, src: str) -> None:
        for entry in _BN_ENTRIES:
            out[f"{dst}.{entry}"] = _tensor(sd[f"{src}.{entry}"])
        tracked = sd.get(f"{src}.num_batches_tracked")
        out[f"{dst}.num_batches_tracked"] = (
            torch.zeros((), dtype=torch.long) if tracked is None else _tensor(tracked).long()
        )

    out["conv_init.weight"] = _tensor(sd["conv1.weight"])
    bn("norm_init", "bn1")
    n_convs = 3 if bottleneck else 2
    index = 0
    for stage, n_blocks in enumerate(stage_sizes):
        for b in range(n_blocks):
            src, dst = f"layer{stage + 1}.{b}", f"blocks.{index}"
            if (f"{src}.conv3.weight" in sd) != bottleneck:
                raise ValueError(f"{src}: the checkpoint's blocks are not {'bottleneck' if bottleneck else 'basic'}")
            for c in range(n_convs):
                out[f"{dst}.conv{c}.weight"] = _tensor(sd[f"{src}.conv{c + 1}.weight"])
                bn(f"{dst}.norm{c}", f"{src}.bn{c + 1}")
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.conv_proj.weight"] = _tensor(sd[f"{src}.downsample.0.weight"])
                bn(f"{dst}.norm_proj", f"{src}.downsample.1")
            index += 1
    out["head.weight"] = _tensor(sd["fc.weight"])
    out["head.bias"] = _tensor(sd["fc.bias"])
    return out


_HF_LAYER = re.compile(r"^distilbert\.transformer\.layer\.(\d+)\.")


def distilbert_state_dict_from_hf(state_dict: Mapping[str, Any], n_layers: int = 6) -> Dict[str, torch.Tensor]:
    """HuggingFace ``DistilBertForSequenceClassification``'s ``state_dict``
    -> the port model's: the same names and layouts, the parameters only
    (not the ``position_ids`` buffer). ``n_layers`` must be the
    checkpoint's: a smaller one would silently drop blocks."""
    layers = {int(m.group(1)) for m in map(_HF_LAYER.match, state_dict) if m}
    if layers != set(range(n_layers)):
        raise ValueError(f"n_layers={n_layers} but the checkpoint has layers {sorted(layers)}")
    out: Dict[str, torch.Tensor] = {}
    for name, value in state_dict.items():
        if name.endswith("position_ids"):
            continue
        out[name] = _tensor(value)
    return out


_HF_GPT2_LINEARS = {"attn.c_proj": "attn.out_proj", "mlp.c_fc": "mlp_fc", "mlp.c_proj": "mlp_proj"}


def gpt2_state_dict_from_hf(
    state_dict: Mapping[str, Any], n_layers: Optional[int] = None, scan_layers: bool = False
) -> Dict[str, torch.Tensor]:
    """HuggingFace ``GPT2LMHeadModel``'s (or ``GPT2Model``'s) ``state_dict``
    -> the port ``GPTLM``'s: ``Conv1D`` weights ``(in, out)`` transposed to
    ``nn.Linear``'s ``(out, in)``, the fused ``c_attn`` split into q, k and
    v, the tied ``lm_head`` left (the port's head is ``wte``). ``n_layers``
    defaults to the checkpoint's and must equal it; ``scan_layers`` stacks
    the blocks into the ``h_scan.block`` layout
    (``models.gpt.stack_gpt_layer_params``)."""
    sd = state_dict
    pfx = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    found = 1 + max((int(k[len(pfx) + 2 :].split(".")[0]) for k in sd if k.startswith(f"{pfx}h.")), default=-1)
    if n_layers is None:
        n_layers = found
    elif n_layers != found:
        raise ValueError(f"n_layers={n_layers} but the checkpoint has {found} layers")
    out = {name: _tensor(sd[f"{pfx}{name}"]) for name in ("wte.weight", "wpe.weight", "ln_f.weight", "ln_f.bias")}
    for i in range(n_layers):
        src, dst = f"{pfx}h.{i}", f"h.{i}"
        for ln in ("ln_1", "ln_2"):
            for entry in ("weight", "bias"):
                out[f"{dst}.{ln}.{entry}"] = _tensor(sd[f"{src}.{ln}.{entry}"])
        weight, bias = _tensor(sd[f"{src}.attn.c_attn.weight"]), _tensor(sd[f"{src}.attn.c_attn.bias"])
        dim = weight.shape[0]
        if weight.shape[1] != 3 * dim:
            raise ValueError(f"{src}.attn.c_attn.weight is {tuple(weight.shape)}, not (dim, 3 * dim)")
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{dst}.attn.{name}.weight"] = weight[:, j * dim : (j + 1) * dim].t().contiguous()
            out[f"{dst}.attn.{name}.bias"] = bias[j * dim : (j + 1) * dim].clone()
        for hf, port in _HF_GPT2_LINEARS.items():
            out[f"{dst}.{port}.weight"] = _tensor(sd[f"{src}.{hf}.weight"]).t().contiguous()
            out[f"{dst}.{port}.bias"] = _tensor(sd[f"{src}.{hf}.bias"])
    return stack_gpt_layer_params(out, n_layers) if scan_layers else out
