"""Deterministic state resharding along the data axis: resume a checkpoint
at another world size. The JAX package's ``resilience/reshard.py`` for
the port, whose checkpoints hold one row file a rank
(``utils.checkpoint``).

- **EF memories fold by summation.** The sum of the per-rank memories is
  the total unsent error. Old ranks ``0..W-W'`` fold into new rank 0 by
  left-to-right addition and the others shift down one to one, so the
  rank-order sum (:func:`memory_total`) is the same chain of fp32
  additions before and after: bit for bit. A widening pads zero rows,
  exact since ``x + 0.0 == x``.
- **Per-worker BN statistics merge** by an average weighted by the samples
  each source rank saw; integer leaves (``num_batches_tracked``) keep the
  first source's value. A widening copies rank 0's.
- **The global batch is kept**; :func:`rescale_accum_steps` gives the
  accumulation steps that keep each device's microbatch.

The functions on per-rank leaves take and return numpy arrays with a
leading world axis, in trees of dicts, lists and tuples: the JAX
package's functions on the same arrays give the same bytes. The tensor-parallel leaf split and merge and an
``fsdp`` degree above 1 wait for the port's tensor parallelism; a
topology with either raises ``NotImplementedError``. ``derive_rank_key``
(JAX PRNG lineage) has no counterpart.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

TOPOLOGY_VERSION = 2

#: Mesh axis order, outermost first, as in the JAX package's records.
MESH_AXES: Tuple[str, ...] = ("data", "fsdp", "tensor")


class RankRows(NamedTuple):
    """The per-rank rows of a checkpoint, each leaf stacked on a leading
    world axis (numpy): ``memories`` and ``model_state`` as the JAX
    package's ``TrainState`` holds them in one controller."""

    memories: Any
    model_state: Any


def _tree_map(fn, tree: Any) -> Any:
    """``fn`` on every leaf of a tree of dicts, lists and tuples (NamedTuples
    rebuilt); ``None`` is an empty subtree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    _tree_map(out.append, tree)
    return out


# -- mesh geometry ------------------------------------------------------------


def normalize_mesh_axes(axes: Optional[Dict[str, int]], world_size: Optional[int] = None) -> Dict[str, int]:
    """Canonical ``{"data": D, "fsdp": F, "tensor": T}``. ``None`` means all
    data: ``{world_size, 1, 1}``. Unknown axes, degrees below 1 and a
    product other than ``world_size`` raise."""
    if axes is None:
        if world_size is None:
            raise ValueError("normalize_mesh_axes needs axes or a world size")
        return {"data": int(world_size), "fsdp": 1, "tensor": 1}
    unknown = set(axes) - set(MESH_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)} — expected a subset of {MESH_AXES}")
    out = {name: int(axes.get(name, 1)) for name in MESH_AXES}
    for name, degree in out.items():
        if degree < 1:
            raise ValueError(f"mesh axis {name!r} must be >= 1, got {degree}")
    if world_size is not None and mesh_world(out) != int(world_size):
        raise ValueError(f"mesh axes {out} have world {mesh_world(out)}, expected {world_size}")
    return out


def mesh_world(axes: Dict[str, int]) -> int:
    """Total rank count of a (possibly partial) mesh-axes dict."""
    world = 1
    for name in MESH_AXES:
        world *= int(axes.get(name, 1))
    return world


def topology_mesh(topology: Dict[str, Any]) -> Dict[str, int]:
    """The mesh a topology record describes (records without
    ``mesh_axes`` mean all data)."""
    return normalize_mesh_axes(topology.get("mesh_axes"), world_size=topology.get("world_size"))


def _require_data_axis(axes: Dict[str, int]) -> None:
    if axes["fsdp"] > 1 or axes["tensor"] > 1:
        raise NotImplementedError(
            f"resharding mesh {axes}: only the data axis is ported (the tensor-parallel and fsdp paths"
            " wait for parallel/tensor.py)"
        )


# -- rank folding -----------------------------------------------------------


def fold_groups(old_world: int, new_world: int) -> List[List[int]]:
    """Which old ranks each new rank absorbs: new rank 0 the leading
    ``W - W' + 1``, every other new rank one, in order."""
    if new_world < 1:
        raise ValueError(f"new_world must be >= 1, got {new_world}")
    if new_world > old_world:
        raise ValueError(
            f"cannot reshard {old_world} ranks up to {new_world} — elastic recovery only shrinks (W' <= W)"
        )
    head = old_world - new_world + 1
    return [list(range(head))] + [[head + d - 1] for d in range(1, new_world)]


def fold_memories(memories: Any, new_world: int) -> Any:
    """Fold the leading per-rank axis of every EF-memory leaf from W rows
    to ``new_world`` by summation, in the leaf's dtype, left to right."""

    def _fold(leaf):
        arr = np.asarray(leaf)
        old_world = arr.shape[0]
        if old_world == new_world:
            return arr
        groups = fold_groups(old_world, new_world)
        head = arr[0].copy()
        for s in groups[0][1:]:
            head = head + arr[s]
        return np.concatenate([head[None], arr[old_world - new_world + 1 :]], axis=0)

    return _tree_map(_fold, memories)


def widen_memories(memories: Any, new_world: int) -> Any:
    """Widen every EF-memory leaf from W rows to ``new_world >= W`` by
    appending zero rows: :func:`memory_total` is unchanged bit for bit."""

    def _widen(leaf):
        arr = np.asarray(leaf)
        old_world = arr.shape[0]
        if old_world == new_world:
            return arr
        if new_world < old_world:
            raise ValueError(f"widen_memories only widens ({old_world} -> {new_world}); use fold_memories to shrink")
        pad = np.zeros((new_world - old_world,) + arr.shape[1:], arr.dtype)
        return np.concatenate([arr, pad], axis=0)

    return _tree_map(_widen, memories)


def widen_model_state(model_state: Any, new_world: int) -> Any:
    """Widen per-worker model state (BN statistics) to ``new_world`` rows:
    the new ranks take rank 0's."""

    def _widen(leaf):
        arr = np.asarray(leaf)
        old_world = arr.shape[0]
        if old_world == new_world:
            return arr
        if new_world < old_world:
            raise ValueError(f"widen_model_state only widens ({old_world} -> {new_world})")
        pad = np.repeat(arr[:1], new_world - old_world, axis=0)
        return np.concatenate([arr, pad], axis=0)

    return _tree_map(_widen, model_state)


def memory_total(memories: Any) -> Any:
    """The conserved quantity: each leaf summed over the rank axis, left to
    right."""

    def _total(leaf):
        arr = np.asarray(leaf)
        total = arr[0].copy()
        for s in range(1, arr.shape[0]):
            total = total + arr[s]
        return total

    return _tree_map(_total, memories)


def merge_model_state(model_state: Any, new_world: int, samples_per_rank: Optional[Sequence[int]] = None) -> Any:
    """Merge per-worker model state down to ``new_world`` rows: each fold
    group's floating leaves averaged, weighted by the samples its source
    ranks saw (``None``: equal weights); integer leaves keep the first
    source's value."""

    def _merge(leaf):
        arr = np.asarray(leaf)
        old_world = arr.shape[0]
        if old_world == new_world:
            return arr
        groups = fold_groups(old_world, new_world)
        weights = np.asarray(
            samples_per_rank if samples_per_rank is not None else [1.0] * old_world, dtype=np.float64
        )
        if weights.shape[0] != old_world:
            raise ValueError(f"samples_per_rank has {weights.shape[0]} entries for {old_world} source ranks")
        rows = []
        for group in groups:
            if len(group) == 1 or not np.issubdtype(arr.dtype, np.floating):
                rows.append(arr[group[0]])
                continue
            gw = weights[group].reshape((len(group),) + (1,) * (arr.ndim - 1))
            merged = (arr[group].astype(np.float64) * gw).sum(axis=0)
            rows.append((merged / gw.sum()).astype(arr.dtype))
        return np.stack(rows, axis=0)

    return _tree_map(_merge, model_state)


def rescale_accum_steps(global_batch: int, old_world: int, new_world: int, old_accum: int = 1) -> int:
    """The smallest accumulation at or above ``old_accum * W / W'`` that
    keeps ``global_batch`` and splits its microbatch over ``new_world``
    devices; ``old_accum`` where none does."""
    if old_accum < 1:
        raise ValueError(f"old_accum must be >= 1, got {old_accum}")
    target = old_accum * old_world / new_world
    k = max(old_accum, math.ceil(target))
    while k * new_world <= global_batch:
        if global_batch % k == 0 and (global_batch // k) % new_world == 0:
            return k
        k += 1
    return old_accum


# -- the topology record ------------------------------------------------------


def make_topology(
    world_size: int,
    global_batch: Optional[int] = None,
    accum_steps: int = 1,
    data_seed: Optional[int] = None,
    partition_seed: int = 1234,
    bits_per_step: Optional[int] = None,
    rng_seed: Optional[int] = None,
    incarnation: int = 0,
    epoch_cursor: Optional[Dict[str, int]] = None,
    mesh_axes: Optional[Dict[str, int]] = None,
    tp_param_axes: Optional[Dict[str, int]] = None,
) -> Dict[str, Any]:
    """The topology record a checkpoint is tagged with (``_TOPOLOGY.json``),
    the JAX package's keys and values: the world, its mesh, the global
    batch, accumulation, seeds, bits per step, the incarnation, the
    per-rank row layout and ``epoch_cursor`` (``{"epoch", "batches_done"}``
    for a mid-epoch preemption save, None on an epoch boundary)."""
    axes = normalize_mesh_axes(mesh_axes, world_size=world_size)
    return {
        "version": TOPOLOGY_VERSION,
        "world_size": int(world_size),
        "mesh_axes": axes,
        "tp_param_axes": {str(k): int(v) for k, v in tp_param_axes.items()} if tp_param_axes else {},
        "global_batch": None if global_batch is None else int(global_batch),
        "accum_steps": int(accum_steps),
        "data_seed": None if data_seed is None else int(data_seed),
        "partition_seed": int(partition_seed),
        "bits_per_step": None if bits_per_step is None else int(bits_per_step),
        "rng_seed": None if rng_seed is None else int(rng_seed),
        "incarnation": int(incarnation),
        # rank r owns row r of every per-worker leaf: its own row file
        "shard_layout": [{"rank": r, "per_worker_row": r} for r in range(int(world_size))],
        "epoch_cursor": dict(epoch_cursor) if epoch_cursor else None,
    }


# -- resharding a training state -------------------------------------------------


def _rows_world(state: Any) -> int:
    leaves = _leaves(getattr(state, "memories", None))
    if not leaves:
        raise TypeError("reshard needs per-rank `memories` with a leading world axis")
    return int(np.asarray(leaves[0]).shape[0])


def reshard_train_state(state: Any, new_world: int, samples_per_rank: Optional[Sequence[int]] = None) -> Any:
    """Move the per-rank rows of ``state`` (a NamedTuple with ``memories``
    and ``model_state`` stacked on a leading world axis: :class:`RankRows`,
    or the JAX package's ``TrainState`` of numpy arrays) to ``new_world``
    ranks. Shrinking: memories fold by summation, model state merges.
    Widening: memories pad zero rows, model state copies rank 0's. Other
    fields pass through."""
    if not hasattr(state, "_fields") or not hasattr(state, "memories"):
        raise TypeError(f"reshard_train_state expects per-rank rows, got {type(state).__name__}")
    old_world = _rows_world(state)
    model_state = state.model_state
    has_state = model_state is not None and bool(_leaves(model_state))
    if new_world >= old_world:
        memories = widen_memories(state.memories, new_world)
        if has_state:
            model_state = widen_model_state(model_state, new_world)
        return state._replace(memories=memories, model_state=model_state)
    folded = fold_memories(state.memories, new_world)
    if has_state:
        model_state = merge_model_state(model_state, new_world, samples_per_rank=samples_per_rank)
    return state._replace(memories=folded, model_state=model_state)


def reshard_mesh_state(
    state: Any,
    old_axes: Dict[str, int],
    new_axes: Dict[str, int],
    tp_param_axes: Optional[Dict[str, int]] = None,
    samples_per_rank: Optional[Sequence[int]] = None,
) -> Any:
    """Move per-rank rows from one mesh to another along the data axis
    (:func:`reshard_train_state`); a tensor or fsdp degree above 1, or
    TP-sharded leaves, raise ``NotImplementedError``."""
    old_axes = normalize_mesh_axes(old_axes)
    new_axes = normalize_mesh_axes(new_axes)
    _require_data_axis(old_axes)
    _require_data_axis(new_axes)
    if tp_param_axes:
        raise NotImplementedError("TP-sharded parameters do not reshard yet (parallel/tensor.py is not ported)")
    return reshard_train_state(state, new_axes["data"], samples_per_rank=samples_per_rank)


def widen_template(template: Any, old_world: int, tp_param_axes: Optional[Dict[str, int]] = None,
                   old_tp: Optional[int] = None) -> RankRows:
    """Per-rank rows shaped as the CHECKPOINT holds them: zeros of
    ``(old_world,) + shape`` for each leaf of ``template``'s (one rank's)
    ``memories`` and ``model_state``, the target the row files are read
    into before the move."""
    if tp_param_axes or (old_tp is not None and old_tp > 1):
        raise NotImplementedError("TP-sharded parameters do not reshard yet (parallel/tensor.py is not ported)")

    def _rerank(leaf):
        if hasattr(leaf, "detach"):  # a torch tensor: its shape and dtype, not its data
            dtype = leaf.detach().new_zeros(()).cpu().numpy().dtype
            return np.zeros((old_world,) + tuple(leaf.shape), dtype)
        arr = np.asarray(leaf)
        return np.zeros((old_world,) + arr.shape, arr.dtype)

    model_state = getattr(template, "model_state", None)
    return RankRows(_tree_map(_rerank, template.memories), _tree_map(_rerank, model_state) if model_state else None)


def reshard_from_checkpoint(
    path: str,
    template: Any,
    saved_topology: Optional[Dict] = None,
    samples_per_rank: Optional[Sequence[int]] = None,
    mesh_axes: Optional[Dict[str, int]] = None,
    group=None,
) -> Any:
    """The resharder ``restore_latest`` routes a world change through:
    restore the replicated fields into ``template`` (this rank's state),
    read every old rank's row into :func:`widen_template`'s rows, move
    them to the world of ``group`` (:func:`reshard_mesh_state`) and write
    this rank's row into ``template``. Every rank of ``group`` calls it.
    ``mesh_axes`` names the new mesh; ``None`` means all data. Returns
    ``template``."""
    import torch

    from ..utils.checkpoint import (
        load_checked,
        per_rank_fields,
        rank_and_world,
        rank_file,
        read_topology,
        state_fields,
    )

    topo = saved_topology if saved_topology is not None else read_topology(path)
    if topo is None or topo.get("world_size") is None:
        raise ValueError(
            f"checkpoint {path} carries no topology record — cannot reshard"
            " (only topology-tagged checkpoints are world-size-elastic)"
        )
    rank, world = rank_and_world(group)
    old_axes = topology_mesh(topo)
    new_axes = normalize_mesh_axes(mesh_axes if mesh_axes is not None else {"data": world})
    if new_axes["data"] != world:
        raise ValueError(f"{world} ranks restore, but the requested mesh has data degree {new_axes['data']}")
    own = per_rank_fields(template)
    extra = [n for n in own if n not in ("memories", "model_state") and _leaves(getattr(template, n, None))]
    if extra:
        raise NotImplementedError(f"per-rank fields {extra} do not reshard yet")
    replicated = [f for f in state_fields(template) if f not in own]
    apply = load_checked(path, template, group, fields=replicated)
    rows = widen_template(template, old_axes["data"], topo.get("tp_param_axes") or None, old_axes["tensor"])
    for r in range(old_axes["data"]):
        saved = torch.load(os.path.join(path, rank_file(r)), map_location="cpu", weights_only=True)
        for name, stacked in (("memories", rows.memories), ("model_state", rows.model_state)):
            if stacked is None:
                continue
            for key, dst in stacked.items():
                src = saved[name][key]
                if tuple(src.shape) != dst.shape[1:]:
                    raise ValueError(f"{name}[{key!r}] of rank {r}: {tuple(src.shape)}, template {dst.shape[1:]}")
                dst[r] = src.numpy()
    moved = reshard_mesh_state(
        rows, old_axes, new_axes, tp_param_axes=topo.get("tp_param_axes") or None, samples_per_rank=samples_per_rank
    )
    apply()
    with torch.no_grad():
        for name in ("memories", "model_state"):
            dst, src = getattr(template, name, None), getattr(moved, name)
            for key in dst or {}:
                dst[key].copy_(torch.from_numpy(np.array(src[key][rank])))  # 0-d stays 0-d
    return template
