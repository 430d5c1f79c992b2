"""The port's data-axis resharding against the JAX package's
``resilience/reshard.py``: each function on the same numpy arrays and
arguments gives the same arrays bit for bit (``fold_groups``,
``fold_memories``, ``widen_memories``, ``widen_model_state``,
``merge_model_state`` on float and int leaves, ``memory_total``,
``rescale_accum_steps``, ``normalize_mesh_axes``) and ``make_topology``
the same dict; then a world change on four Gloo ranks (one spawn): a
4-rank checkpoint restored by ranks 0 and 1 as a world of two through the
resharder gives each new rank the rows of the JAX ``reshard_train_state``
on the same stacked arrays, bit for bit, and ``restore_serving_params``
reads that checkpoint into one process with the params bit-identical.

The tensor and fsdp axes: ``merge_tp_leaf``, ``split_tp_leaf`` and
``reshard_tp_params`` against the JAX functions on the same arrays, bit for
bit (reference ``tests/test_reshard.py:382-413``); ``reshard_mesh_state``
and ``widen_template`` against the JAX ones; and the mesh moves of
reference ``tests/test_reshard.py:447-525`` on four Gloo ranks (a 2 data x
2 tensor checkpoint traded for data, folded along data keeping tensor,
collapsed to one rank, spread over an fsdp axis; the same-mesh restore and
the data-degree refusal), each rank holding its part of the JAX
resharder's bytes.
"""

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.parallel.trainer import TrainState as JaxTrainState
from network_distributed_pytorch_tpu.resilience import reshard as jax_reshard
from network_distributed_pytorch_tpu_torch.resilience import reshard
from network_distributed_pytorch_tpu_torch.serving.cache import restore_serving_params
from network_distributed_pytorch_tpu_torch.utils.checkpoint import (
    TopologyMismatchError,
    read_topology,
    restore_checkpoint,
)
from torch_worker import (  # few_torch_threads: autouse
    few_torch_threads,
    mesh_reshard_rank,
    resnet_resume_setup,
    reshard_rank,
    spawn,
)

WORLDS = [(4, 1), (4, 2), (4, 3), (3, 2), (5, 3), (2, 2)]


def _tree(seed, world, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return {
        "conv": {"kernel": rng.randn(world, 3, 3, 2, 4).astype(dtype)},
        "dense": [rng.randn(world, 5).astype(dtype), rng.randn(world, 2, 3).astype(dtype)],
    }


def _equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif want is None:
        assert got is None
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("old,new", WORLDS)
def test_fold_functions_match_jax(old, new):
    assert reshard.fold_groups(old, new) == jax_reshard.fold_groups(old, new)
    mem = _tree(old * 10 + new, old)
    _equal(reshard.fold_memories(mem, new), jax_reshard.fold_memories(mem, new))
    _equal(reshard.memory_total(mem), jax_reshard.memory_total(mem))
    # the conserved quantity, bit for bit across the fold
    _equal(reshard.memory_total(reshard.fold_memories(mem, new)), reshard.memory_total(mem))


@pytest.mark.parametrize("old,new", [(1, 4), (2, 3), (3, 3), (2, 5)])
def test_widen_functions_match_jax(old, new):
    mem = _tree(old + 7 * new, old)
    _equal(reshard.widen_memories(mem, new), jax_reshard.widen_memories(mem, new))
    _equal(reshard.widen_model_state(mem, new), jax_reshard.widen_model_state(mem, new))
    _equal(reshard.memory_total(reshard.widen_memories(mem, new)), reshard.memory_total(mem))
    assert reshard.widen_model_state(None, new) is None
    with pytest.raises(ValueError):
        reshard.widen_memories(_tree(0, new + 1), new)


@pytest.mark.parametrize("old,new", WORLDS)
@pytest.mark.parametrize("weights", [None, "samples"], ids=["equal", "weighted"])
def test_merge_model_state_matches_jax(old, new, weights):
    samples = None if weights is None else [3 + 2 * r for r in range(old)]
    rng = np.random.RandomState(old + new)
    state = {
        "running_mean": rng.randn(old, 6).astype(np.float32),
        "running_var": np.abs(rng.randn(old, 6)).astype(np.float32),
        "num_batches_tracked": np.arange(old, dtype=np.int64) + 5,  # the integer branch
        "scalar": rng.randn(old).astype(np.float32),
    }
    _equal(
        reshard.merge_model_state(state, new, samples_per_rank=samples),
        jax_reshard.merge_model_state(state, new, samples_per_rank=samples),
    )
    assert reshard.merge_model_state(None, new) is None
    if new < old:
        with pytest.raises(ValueError):
            reshard.merge_model_state(state, new, samples_per_rank=[1] * (old + 1))


def test_reshard_train_state_matches_jax_both_ways():
    rng = np.random.RandomState(4)
    for old, new in ((4, 2), (2, 4), (3, 1)):
        mem = {"w": rng.randn(old, 3, 2).astype(np.float32)}
        stats = {"mean": rng.randn(old, 3).astype(np.float32), "count": np.arange(old, dtype=np.int64)}
        got = reshard.reshard_train_state(reshard.RankRows(mem, stats), new)
        want = jax_reshard.reshard_train_state(JaxTrainState({}, {}, mem, None, stats), new)
        _equal(got.memories, want.memories)
        _equal(got.model_state, want.model_state)
    with pytest.raises(TypeError):
        reshard.reshard_train_state({"memories": mem}, 2)


@pytest.mark.parametrize(
    "global_batch,old,new,accum",
    [(64, 4, 3, 1), (64, 4, 2, 1), (96, 8, 3, 2), (10, 4, 3, 1), (256, 8, 1, 1), (48, 2, 4, 3)],
)
def test_rescale_accum_steps_matches_jax(global_batch, old, new, accum):
    assert reshard.rescale_accum_steps(global_batch, old, new, accum) == jax_reshard.rescale_accum_steps(
        global_batch, old, new, accum
    )


@pytest.mark.parametrize(
    "axes,world",
    [(None, 4), ({"data": 2, "tensor": 2}, 4), ({"data": 8}, None), ({"fsdp": 2, "data": 3}, 6)],
)
def test_normalize_mesh_axes_matches_jax(axes, world):
    got = reshard.normalize_mesh_axes(axes, world_size=world)
    assert got == jax_reshard.normalize_mesh_axes(axes, world_size=world)
    assert reshard.mesh_world(got) == jax_reshard.mesh_world(got)


@pytest.mark.parametrize("bad", [({"pipe": 2}, None), ({"data": 0}, None), ({"data": 2}, 3), (None, None)])
def test_normalize_mesh_axes_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        jax_reshard.normalize_mesh_axes(*bad)
    with pytest.raises(ValueError):
        reshard.normalize_mesh_axes(*bad)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"world_size": 1},
        {"world_size": 4, "global_batch": 512, "accum_steps": 2, "data_seed": 714, "bits_per_step": 752912736,
         "rng_seed": 714, "incarnation": 3},
        {"world_size": 2, "epoch_cursor": {"epoch": 1, "batches_done": 3}, "partition_seed": 7},
        {"world_size": 4, "mesh_axes": {"data": 2, "tensor": 2}, "tp_param_axes": {"h_0/attn/q_proj/kernel": 1}},
    ],
    ids=["world1", "exact_cifar10", "cursor", "mesh"],
)
def test_make_topology_matches_jax(kwargs):
    got = reshard.make_topology(**kwargs)
    assert got == jax_reshard.make_topology(**kwargs)
    assert reshard.topology_mesh(got) == jax_reshard.topology_mesh(got)


class MeshState(NamedTuple):
    """The reference test's ``TrainState``-like mini on a data x tensor
    mesh: ``w`` TP-stacked ``(T,) + shard``, memories per data rank."""

    params: Any
    memories: Any
    model_state: Any


def _mesh_state(data, tp, seed=0):
    rng = np.random.RandomState(seed)
    full = rng.randn(6, 8).astype(np.float32)
    return MeshState(
        {"w": reshard.split_tp_leaf(full, tp, 1), "b": rng.randn(8).astype(np.float32)},
        {"m": rng.randn(data, 6, 8).astype(np.float32)}, None,
    )


@pytest.mark.parametrize("tp,axis", [(4, 1), (3, 0), (2, 1), (1, 0)])
def test_tp_leaf_split_and_merge_match_jax(tp, axis):
    full = np.random.RandomState(11 + tp).randn(6, 8).astype(np.float32)
    got = reshard.split_tp_leaf(full, tp, axis)
    _equal(got, jax_reshard.split_tp_leaf(full, tp, axis))
    _equal(reshard.merge_tp_leaf(got, axis), jax_reshard.merge_tp_leaf(got, axis))
    assert reshard.merge_tp_leaf(got, axis).tobytes() == full.tobytes()
    # a torch tensor reads as its array
    _equal(reshard.split_tp_leaf(torch.from_numpy(full), tp, axis), got)


@pytest.mark.parametrize(
    "fn,args",
    [("split_tp_leaf", (np.zeros((6, 8), np.float32), 5, 1)), ("split_tp_leaf", (np.zeros((6, 8), np.float32), 0, 1)),
     ("merge_tp_leaf", (np.zeros(4, np.float32), 0))],
    ids=["does_not_divide", "tp_zero", "no_shard_axis"],
)
def test_tp_leaf_refusals_match_jax(fn, args):
    with pytest.raises(ValueError):
        getattr(jax_reshard, fn)(*args)
    with pytest.raises(ValueError):
        getattr(reshard, fn)(*args)


@pytest.mark.parametrize("old,new", [(2, 1), (1, 2), (2, 4), (4, 2)])
def test_reshard_tp_params_matches_jax(old, new):
    rng = np.random.RandomState(12)
    full, v = rng.randn(6, 8).astype(np.float32), rng.randn(4, 3).astype(np.float32)
    params = {"w": reshard.split_tp_leaf(full, old, 1), "b": rng.randn(8).astype(np.float32),
              "blocks": {"v": reshard.split_tp_leaf(v, old, 0)}}
    axes = {"w": 1, "blocks/v": 0}
    got = reshard.reshard_tp_params(params, old, new, axes)
    _equal(got, jax_reshard.reshard_tp_params(params, old, new, axes))
    assert got["w"].shape[0] == new and got["b"] is params["b"]  # unlisted: replicated, untouched
    _equal(reshard.reshard_tp_params(got, new, old, axes), params)  # pure byte movement both ways
    assert reshard.reshard_tp_params(params, old, old, axes) is params
    assert reshard.reshard_tp_params(params, old, new, {}) is params


MESH_MOVES = [
    ({"data": 2, "tensor": 2}, {"data": 2, "tensor": 1}),
    ({"data": 2, "tensor": 2}, {"data": 1, "tensor": 2}),
    ({"data": 2, "tensor": 2}, {"data": 1, "tensor": 1}),
    ({"data": 1, "fsdp": 2}, {"data": 1}),
    ({"data": 2, "fsdp": 2}, {"data": 1, "fsdp": 4}),
    ({"data": 1, "fsdp": 2, "tensor": 2}, {"data": 2, "fsdp": 2, "tensor": 1}),
]


@pytest.mark.parametrize("old,new", MESH_MOVES, ids=["trade", "fold", "collapse", "fsdp_off", "fsdp_wider", "widen"])
def test_tensor_and_fsdp_degrees_reshard(old, new):
    """A tensor or fsdp degree above 1 reshards: the port's
    ``reshard_mesh_state`` gives the JAX one's bytes (TP leaves re-split,
    memories folded or widened along the data axis, fsdp a layout axis
    that moves nothing)."""
    old_n, new_n = reshard.normalize_mesh_axes(old), reshard.normalize_mesh_axes(new)
    state = _mesh_state(old_n["data"], old_n["tensor"], seed=13)
    got = reshard.reshard_mesh_state(state, old, new, tp_param_axes={"w": 1})
    want = jax_reshard.reshard_mesh_state(state, old, new, tp_param_axes={"w": 1})
    _equal(got.params, want.params)
    _equal(got.memories, want.memories)
    _equal(reshard.memory_total(got.memories), reshard.memory_total(state.memories))
    assert got.params["w"].shape[0] == new_n["tensor"] and got.memories["m"].shape[0] == new_n["data"]


@dataclasses.dataclass
class _RankCarry:
    PER_RANK_FIELDS = ("params", "memories", "model_state")
    params: dict
    memories: dict
    model_state: dict


def test_widen_template_states_the_checkpoint_layout():
    """From one rank's state on the new mesh (TP degree 1 here: ``w``
    whole), the shapes the JAX ``widen_template`` gives from its stacked
    template: ``w`` as the checkpoint's ``(2,) + shard`` stack, memories
    with the checkpoint's data rows; a replicated ``params`` field is no
    part of the rows."""
    one_rank = _RankCarry({"w": torch.zeros(6, 8), "b": torch.zeros(8)}, {"m": torch.zeros(6, 8)}, {})
    got = reshard.widen_template(one_rank, 2, {"w": 1}, old_tp=2, new_tp=1)
    want = jax_reshard.widen_template(_mesh_state(1, 1), 2, {"w": 1}, old_tp=2)
    for tree_got, tree_want in ((got.params, want.params), (got.memories, want.memories)):
        for k, v in tree_want.items():
            assert tree_got[k].shape == v.shape and tree_got[k].dtype == v.dtype and not tree_got[k].any(), k
    assert reshard.widen_template(reshard.RankRows({"m": np.zeros((6, 8))}, None), 3).params is None
    with pytest.raises(ValueError, match="does not divide"):
        reshard.widen_template(one_rank, 2, {"w": 1}, old_tp=3, new_tp=1)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("reshard")
    return root, spawn(reshard_rank, 4, root, str(root))


def test_world_change_4_to_2_matches_the_jax_resharder(four_ranks):
    """Each rank of the new world of two holds row r of the JAX
    ``reshard_train_state`` of the four ranks' stacked memories and BN
    statistics (folded by summation, merged by the weighted mean, the
    integer ``num_batches_tracked`` from the first source), and the
    replicated fields of rank 0's save."""
    _, ranks = four_ranks
    stack = lambda field: {  # noqa: E731
        k: np.stack([r["saved"][field][k].numpy() for r in ranks]) for k in ranks[0]["saved"][field]
    }
    want = jax_reshard.reshard_train_state(JaxTrainState({}, {}, stack("memories"), None, stack("buffers")), 2)
    assert not np.array_equal(stack("memories")["conv_init.weight"][0], stack("memories")["conv_init.weight"][1])
    for r in (0, 1):
        got = ranks[r]["restored"]
        assert ranks[r]["restored_step"] == 0 and ranks[r]["resharded_from"] == [4]
        for field, rows in (("memories", want.memories), ("buffers", want.model_state)):
            for k, v in rows.items():
                assert got[field][k].numpy().tobytes() == np.asarray(v[r]).tobytes(), f"rank {r} {field} {k}"
        for field in ("params", "momenta"):
            for k, v in ranks[0]["saved"][field].items():
                assert torch.equal(got[field][k], v), f"rank {r} {field} {k}"
        assert torch.equal(got["q"], ranks[0]["saved"]["q"])


def test_restore_at_another_world_without_a_resharder_raises(four_ranks):
    root, _ = four_ranks
    _, _, state = resnet_resume_setup(None)
    assert read_topology(str(root / "ckpt" / "step_0"))["world_size"] == 4
    with pytest.raises(TopologyMismatchError):
        restore_checkpoint(str(root / "ckpt" / "step_0"), state)


def test_serving_hot_load_reads_a_4_rank_checkpoint(four_ranks):
    """One process reads the 4-rank training checkpoint's params, bit for
    bit, into a model of other weights; nothing per-rank is read."""
    root, ranks = four_ranks
    model, _, _ = resnet_resume_setup(None, seed=9)
    params = dict(model.named_parameters())
    restored, step = restore_serving_params(str(root / "ckpt"), params)
    assert step == 0 and restored is params
    for k, v in ranks[0]["saved"]["params"].items():
        assert torch.equal(params[k].detach(), v), k


# ---- the mesh moves on four Gloo ranks -------------------------------------------------

MOVES = [
    ("trade_tensor_for_data", [0, 1], {"data": 2, "tensor": 1}),
    ("fold_data_keep_tensor", [0, 1], {"data": 1, "tensor": 2}),
    ("collapse_2x2_to_1x1", [0], {"data": 1, "tensor": 1}),
    ("spread_over_fsdp", [0, 1, 2, 3], {"data": 1, "fsdp": 2, "tensor": 2}),
]
OLD_MESH = {"data": 2, "fsdp": 1, "tensor": 2}


def _mesh_arrays():
    rng = np.random.RandomState(14)
    return rng.randn(6, 8).astype(np.float32), rng.randn(8).astype(np.float32), rng.randn(2, 6, 8).astype(np.float32)


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    return spawn(mesh_reshard_rank, 4, root, str(root), *_mesh_arrays(), MOVES)


@pytest.mark.parametrize("name,members,axes", MOVES, ids=[m[0] for m in MOVES])
def test_mesh_move_gives_the_jax_resharders_bytes(mesh_ranks, name, members, axes):
    """Each rank of the new mesh holds, bit for bit, its TP shard of the
    JAX ``reshard_mesh_state``'s ``w``, its ``b``, and the row of its data
    coordinate of the memories (folded by summation where data shrinks)."""
    full_w, b, mem = _mesh_arrays()
    state = MeshState({"w": reshard.split_tp_leaf(full_w, 2, 1), "b": b}, {"m": mem}, None)
    want = jax_reshard.reshard_mesh_state(state, OLD_MESH, axes, tp_param_axes={"w": 1})
    new = reshard.normalize_mesh_axes(axes)
    for r, rank in enumerate(members):
        got = mesh_ranks[rank][name]
        coord = reshard.mesh_coord(r, new)
        assert got["params.w"].numpy().tobytes() == np.asarray(want.params["w"][coord["tensor"]]).tobytes(), rank
        assert got["params.b"].numpy().tobytes() == np.asarray(want.params["b"]).tobytes(), rank
        assert got["memories.m"].numpy().tobytes() == np.asarray(want.memories["m"][coord["data"]]).tobytes(), rank
    for rank in range(4):
        if rank not in members:
            assert name not in mesh_ranks[rank]


def test_mesh_checkpoint_restores_on_its_mesh_and_refuses_another_data_degree(mesh_ranks):
    """The reference's ``test_check_topology_mesh_data_axis_mismatch``: the
    same 2 x 2 mesh restores every rank's own part bit for bit, though the
    world (4) is not the data degree (2); three ranks at data degree 3 are
    refused with the recorded degree named."""
    full_w, b, mem = _mesh_arrays()
    shards = reshard.split_tp_leaf(full_w, 2, 1)
    for rank, res in enumerate(mesh_ranks):
        coord = reshard.mesh_coord(rank, OLD_MESH)
        got = res["same_mesh"]
        assert got["params.w"].numpy().tobytes() == shards[coord["tensor"]].tobytes()
        assert got["memories.m"].numpy().tobytes() == mem[coord["data"]].tobytes()
        if rank < 3:
            assert res["refused"] is not None and "data degree 2" in res["refused"]
