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

- **Mesh shapes reshard, not just world sizes.** The topology record
  carries the ``data x fsdp x tensor`` axes and the shard axis of every
  tensor-parallel leaf (``tp_param_axes``): TP leaves merge and re-split
  by pure byte movement (exact, :func:`reshard_tp_params`), memories fold
  or pad along the data axis, and ``fsdp``, a layout axis over unsharded
  parameters, changes degree with no data movement.

The functions on per-rank leaves take and return numpy arrays with a
leading world (or TP-shard) axis, in trees of dicts, lists and tuples: the
JAX package's functions on the same arrays give the same bytes. In the
port's checkpoints a TP leaf lives as one shard in each rank's file, not
as the reference's ``(T,) + shard`` stack: :func:`widen_template` states
that stack, and :func:`reshard_from_checkpoint` fills it from the rank
files. ``derive_rank_key`` (JAX PRNG lineage) has no counterpart: no port
path draws per-rank randomness yet.
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
    """The per-rank rows of a checkpoint (numpy): ``memories`` and
    ``model_state`` with a leading data-axis row for each leaf, as the JAX
    package's ``TrainState`` holds them in one controller, and, where the
    parameters are per rank, ``params`` with each ``tp_param_axes`` leaf a
    ``(T,) + shard`` stack and the others as one rank holds them."""

    memories: Any
    model_state: Any
    params: Any = None


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


def _tree_map_with_path(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """:func:`_tree_map` whose ``fn(path, leaf)`` also gets the leaf's
    ``"/"``-joined path of keys and indices, the JAX package's
    ``tp_param_axes`` keys."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(_tree_map_with_path(fn, v, path + (f,)) for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(path), tree)


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


# -- tensor-parallel leaves ------------------------------------------------------
#
# A TP leaf moves as a stack ``(T,) + shard_shape`` whose ``shard_shape[axis]``
# is ``full_dim / T``, for the axis ``tp_param_axes`` records (an index into
# the unstacked shard's shape). Merge-then-split moves bytes and does no
# arithmetic, so a change of TP degree is exact.


def merge_tp_leaf(stacked: Any, axis: int) -> np.ndarray:
    """Concatenate a ``(T,) + shard_shape`` stack into the full array along
    the shard axis: pure byte movement."""
    arr = np.asarray(stacked)
    if arr.ndim < 2:
        raise ValueError(f"TP leaf must have a leading shard axis, got shape {arr.shape}")
    return np.concatenate([arr[i] for i in range(arr.shape[0])], axis=axis)


def split_tp_leaf(full: Any, tp: int, axis: int) -> np.ndarray:
    """Split a full array into a ``(tp,) + shard_shape`` stack along the
    shard axis, which must divide evenly: a mesh whose TP degree does not
    divide the parameter is no restart shape."""
    arr = np.asarray(full)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if arr.shape[axis] % tp:
        raise ValueError(f"dim {arr.shape[axis]} on axis {axis} does not divide over tp={tp}")
    return np.stack(np.split(arr, tp, axis=axis), axis=0)


def reshard_tp_params(params: Any, old_tp: int, new_tp: int, tp_param_axes: Dict[str, int]) -> Any:
    """Re-split every ``tp_param_axes`` leaf (by its ``"/"``-joined path)
    from ``old_tp`` shards to ``new_tp`` (merge to full, split back); the
    other leaves are replicated and pass through. ``params`` itself where
    the degrees match or nothing is TP-sharded."""
    if old_tp == new_tp or not tp_param_axes:
        return params

    def _move(key, leaf):
        if key not in tp_param_axes:
            return leaf
        axis = int(tp_param_axes[key])
        return split_tp_leaf(merge_tp_leaf(leaf, axis), new_tp, axis)

    return _tree_map_with_path(_move, params)


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
    """Move per-rank rows (a NamedTuple with ``memories``, ``model_state``
    and, optionally, ``params``: :class:`RankRows`, or the JAX package's
    ``TrainState`` of numpy arrays) from one mesh to another: TP leaves of
    ``params`` re-split along their recorded axes (exact byte movement),
    memories and model state fold or widen along the data axis
    (:func:`reshard_train_state`), and ``fsdp`` changes degree with no data
    movement."""
    old_axes = normalize_mesh_axes(old_axes)
    new_axes = normalize_mesh_axes(new_axes)
    params = getattr(state, "params", None)
    if params is not None:
        state = state._replace(
            params=reshard_tp_params(params, old_axes["tensor"], new_axes["tensor"], tp_param_axes or {})
        )
    elif tp_param_axes and old_axes["tensor"] != new_axes["tensor"]:
        raise ValueError("tp_param_axes name leaves of params, and the state holds no per-rank params")
    return reshard_train_state(state, new_axes["data"], samples_per_rank=samples_per_rank)


def _zeros_like(leaf: Any, lead: Tuple[int, ...] = (), shape: Optional[Sequence[int]] = None) -> np.ndarray:
    """numpy zeros of ``lead + shape`` (``shape``: the leaf's) in the
    leaf's dtype; a torch tensor gives its shape and dtype, not its data."""
    if hasattr(leaf, "detach"):
        dtype = leaf.detach().new_zeros(()).cpu().numpy().dtype
    else:
        dtype = np.asarray(leaf).dtype
    return np.zeros(tuple(lead) + tuple(leaf.shape if shape is None else shape), dtype)


def widen_template(
    template: Any,
    old_world: int,
    tp_param_axes: Optional[Dict[str, int]] = None,
    old_tp: Optional[int] = None,
    new_tp: int = 1,
) -> RankRows:
    """Per-rank rows shaped as the CHECKPOINT holds them, the target the
    rank files are read into before the move: zeros of ``(old_world,) +
    shape`` for each leaf of ``template``'s (one rank's) ``memories`` and
    ``model_state``; where ``template`` holds per-rank ``params`` (built
    for a mesh of TP degree ``new_tp``), each ``tp_param_axes`` leaf as the
    ``(old_tp,) + shard`` stack of the checkpoint's TP degree and every
    other leaf as one rank holds it."""
    from ..utils.checkpoint import per_rank_fields

    model_state = getattr(template, "model_state", None)
    memories = _tree_map(lambda leaf: _zeros_like(leaf, (old_world,)), template.memories)
    model_state = _tree_map(lambda leaf: _zeros_like(leaf, (old_world,)), model_state) if model_state else None
    if "params" not in per_rank_fields(template):
        return RankRows(memories, model_state)
    tp_param_axes = tp_param_axes or {}
    old_tp = old_tp or 1

    def _retp(key, leaf):
        if key not in tp_param_axes:
            return _zeros_like(leaf)
        axis = int(tp_param_axes[key])
        shard = list(leaf.shape)
        full_dim = shard[axis] * new_tp
        if full_dim % old_tp:
            raise ValueError(f"param {key!r} dim {full_dim} does not divide over checkpoint tp={old_tp}")
        shard[axis] = full_dim // old_tp
        return _zeros_like(leaf, (old_tp,), shard)

    return RankRows(memories, model_state, _tree_map_with_path(_retp, template.params))


def mesh_rank(coord: Dict[str, int], axes: Dict[str, int]) -> int:
    """The rank at ``coord`` of a mesh laid over the world row-major in
    :data:`MESH_AXES` order, as ``parallel.mesh.make_mesh`` lays it."""
    rank = 0
    for name in MESH_AXES:
        rank = rank * int(axes[name]) + int(coord.get(name, 0))
    return rank


def mesh_coord(rank: int, axes: Dict[str, int]) -> Dict[str, int]:
    """The coordinate of ``rank`` on the mesh (:func:`mesh_rank`'s inverse)."""
    coord = {}
    for name in reversed(MESH_AXES):
        rank, coord[name] = divmod(rank, int(axes[name]))
    return coord


def reshard_from_checkpoint(
    path: str,
    template: Any,
    saved_topology: Optional[Dict] = None,
    samples_per_rank: Optional[Sequence[int]] = None,
    mesh_axes: Optional[Dict[str, int]] = None,
    group=None,
) -> Any:
    """The resharder ``restore_latest`` routes a world or mesh change
    through: restore the replicated fields into ``template`` (this rank's
    state), read the old ranks' rows into :func:`widen_template`'s rows (a
    data row from the first rank of each old data slice; each TP shard of
    per-rank ``params`` from the rank of the first data slice that holds
    it; the other params from rank 0), move them to the new mesh
    (:func:`reshard_mesh_state`) and write this rank's part into
    ``template``: the row of its data coordinate and the shard of its
    tensor coordinate. Every rank of ``group`` calls it. ``mesh_axes``
    names the new mesh, over the ranks of ``group``; ``None`` means all
    data. Returns ``template``."""
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
    if mesh_world(new_axes) != world:
        raise ValueError(f"{world} ranks restore, but the requested mesh {new_axes} has {mesh_world(new_axes)}")
    tp_axes = {str(k): int(v) for k, v in (topo.get("tp_param_axes") or {}).items()}
    own = per_rank_fields(template)
    extra = [n for n in own if n not in ("memories", "model_state", "params") and _leaves(getattr(template, n, None))]
    if extra:
        raise NotImplementedError(f"per-rank fields {extra} do not reshard yet")
    replicated = [f for f in state_fields(template) if f not in own]
    apply = load_checked(path, template, group, fields=replicated)
    rows = widen_template(template, old_axes["data"], tp_axes, old_axes["tensor"], new_axes["tensor"])
    files: Dict[int, Dict[str, Any]] = {}

    def saved(r: int) -> Dict[str, Any]:
        if r not in files:
            files[r] = torch.load(os.path.join(path, rank_file(r)), map_location="cpu", weights_only=True)
        return files[r]

    def fill(dst: np.ndarray, index: Any, r: int, name: str, key: str) -> None:
        """Row ``index`` of ``dst`` (all of it: ``...``) from rank ``r``'s file."""
        src = saved(r)[name][key]
        want = dst.shape if index is Ellipsis else dst.shape[1:]
        if tuple(src.shape) != want:
            raise ValueError(f"{name}[{key!r}] of rank {r}: {tuple(src.shape)}, template {want}")
        dst[index] = src.numpy()

    for d in range(old_axes["data"]):
        for name, stacked in (("memories", rows.memories), ("model_state", rows.model_state)):
            for key, dst in (stacked or {}).items():
                fill(dst, d, mesh_rank({"data": d}, old_axes), name, key)
    for key, dst in (rows.params or {}).items():
        if key in tp_axes:
            for t in range(old_axes["tensor"]):
                fill(dst, t, mesh_rank({"tensor": t}, old_axes), "params", key)
        else:
            fill(dst, Ellipsis, 0, "params", key)
    moved = reshard_mesh_state(rows, old_axes, new_axes, tp_param_axes=tp_axes, samples_per_rank=samples_per_rank)
    apply()
    me = mesh_coord(rank, new_axes)
    with torch.no_grad():
        for name, index in (("memories", me["data"]), ("model_state", me["data"]), ("params", me["tensor"])):
            dst, src = getattr(template, name, None), getattr(moved, name)
            if src is None:
                continue
            for key in dst or {}:
                value = src[key][index] if name != "params" or key in tp_axes else src[key]
                dst[key].copy_(torch.from_numpy(np.array(value)))  # 0-d stays 0-d
    return template
