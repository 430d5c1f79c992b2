"""The port's ``HierarchicalReducer`` on four Gloo ranks as a 2 x 2 grid
(two outer groups of two inner ranks, the JAX study's ``("dcn", "ici")``
mesh), against flat exact DDP and against the JAX package's reducer on a
2 x 2 CPU mesh; and the bandwidth study at world 4, where it adds
``hier_powersgd_r4``.

Tolerances: exact hierarchical against flat exact, rtol 1e-6 (the JAX
test's: a mean of group means against one mean); hierarchical PowerSGD
against JAX, rtol = atol = 1e-5 (the frameworks' matmuls and Gram-Schmidt
sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from network_distributed_pytorch_tpu.parallel import make_mesh
from network_distributed_pytorch_tpu.parallel.hierarchical import HierarchicalReducer as JaxHierarchical
from network_distributed_pytorch_tpu.parallel.reducers import PowerSGDReducer as JaxPowerSGD
from network_distributed_pytorch_tpu.parallel.reducers import PowerSGDState as JaxState
from torch_worker import few_torch_threads, hierarchical_rank, run_all, spawn, study_rank  # few_torch_threads: autouse

WORLD = 4
SHAPES = [(16, 4), (4,), (3, 3, 2, 6)]  # JAX layout: dense (in, out), bias, conv HWIO


def _to_torch(a):
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    elif a.ndim == 2:
        a = a.T
    return torch.from_numpy(np.ascontiguousarray(a))


def _to_jax_layout(t):
    a = t.numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else (a.T if a.ndim == 2 else a)


def _sends():
    rng = np.random.RandomState(50)
    return [[rng.randn(*s).astype(np.float32) for s in SHAPES] for _ in range(WORLD)]


def _jax_hierarchical(per_worker):
    """The JAX reducer on a 2 x 2 mesh: out and each worker's memory, and
    the reducer's initial Q."""
    mesh = make_mesh(axis_sizes=(2, 2), axis_names=("dcn", "ici"), devices=jax.devices()[:WORLD])
    outer = JaxPowerSGD(compression_rank=2, matricize="last")
    hier = JaxHierarchical(outer, mesh, inner_axis="ici", outer_axis="dcn")
    template = [jnp.zeros(s) for s in SHAPES]
    q0 = hier.init(template).q_memory
    n = len(SHAPES)

    def f(*send):
        state = JaxState(q0, jax.random.PRNGKey(0))
        _, out, mem, _ = hier.reduce(state, [s[0] for s in send], ("dcn", "ici"))
        return [o[None] for o in out], [m[None] for m in mem]

    axes = P(("dcn", "ici"))
    stacked = [jnp.stack([jnp.asarray(w[i]) for w in per_worker]) for i in range(n)]
    out, mem = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(axes,) * n, out_specs=([axes] * n, [axes] * n)))(*stacked)
    bits = hier.bits_by_fabric(template)
    return [np.asarray(o) for o in out], [np.asarray(m) for m in mem], np.asarray(q0), bits


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    per_worker = _sends()
    j_out, j_mem, q0, j_bits = _jax_hierarchical(per_worker)
    per_rank = [[_to_torch(a) for a in w] for w in per_worker]
    calls = [(hierarchical_rank, (per_rank, torch.from_numpy(np.array(q0)), 12)), (study_rank, (32,))]
    ranks = spawn(run_all, WORLD, tmp_path_factory.mktemp("ranks"), calls)
    return {
        "jax": (j_out, j_mem, j_bits), "hier": [r[0] for r in ranks], "study": [r[1] for r in ranks],
    }


def test_groups_form_a_2x2_grid(runs):
    for rank, res in enumerate(runs["hier"]):
        assert res["inner_ranks"] == ((0, 1) if rank < 2 else (2, 3))
        assert res["outer_ranks"] == ((0, 2) if rank % 2 == 0 else (1, 3))


def test_exact_hierarchical_equals_flat_exact(runs):
    for res in runs["hier"]:
        (hl, hp, hbits), (fl, fp, fbits) = res["runs"]["hier"], res["runs"]["flat"]
        np.testing.assert_allclose(hl, fl, rtol=1e-6)
        for k in fp:
            np.testing.assert_allclose(hp[k].numpy(), fp[k].numpy(), rtol=1e-6, atol=1e-7)
        # inner exact + outer exact payloads + the loss
        assert hbits == 2 * (fbits - 32) + 32


def test_hierarchical_powersgd_matches_jax(runs):
    """One hierarchical PowerSGD reduction from the same Q: ``out`` the same
    on every rank bit for bit and within 1e-5 of JAX's; each rank's memory
    (the same within an inner group) within 1e-5 of its JAX worker's."""
    j_out, j_mem, _ = runs["jax"]
    ranks = runs["hier"]
    for w, res in enumerate(ranks):
        for i, (o, o0) in enumerate(zip(res["out"], ranks[0]["out"])):
            assert torch.equal(o, o0)
            np.testing.assert_allclose(_to_jax_layout(o), j_out[i][w], rtol=1e-5, atol=1e-5)
        for i, m in enumerate(res["mem"]):
            np.testing.assert_allclose(_to_jax_layout(m), j_mem[i][w], rtol=1e-5, atol=1e-5)
            assert torch.equal(m, ranks[w ^ 1]["mem"][i])  # the inner partner's


def test_bits_by_fabric_equal_the_recorded_split(runs):
    """The collectives over the inner group carry ``bits_by_fabric``'s inner
    bits, those over the outer group its outer bits; both as JAX counts."""
    _, _, j_bits = runs["jax"]
    for res in runs["hier"]:
        inner = 8 * sum(b for _, ranks, b in res["records"] if ranks == res["inner_ranks"])
        outer = 8 * sum(b for _, ranks, b in res["records"] if ranks == res["outer_ranks"])
        assert inner + outer == 8 * sum(b for _, _, b in res["records"]) == res["bits"]
        assert {"inner": inner, "outer": outer} == res["bits_by_fabric"] == j_bits


def test_study_at_world_four_adds_the_hierarchical_row(runs):
    """At four ranks the study adds ``hier_powersgd_r4``: its slow-fabric
    share (the outer group's collectives and the global loss) is the
    compressed one, and the fast and slow shares add up to its bits."""
    for out in runs["study"]:
        res = out["results"]
        assert out["num_devices"] == WORLD and "hier_powersgd_r4" in res
        hier = res["hier_powersgd_r4"]
        assert hier["bits_slow_fabric"] == hier["bits_by_fabric"]["outer"] + 32
        assert hier["bits_fast_fabric"] == hier["bits_by_fabric"]["inner"]
        assert hier["bits_fast_fabric"] + hier["bits_slow_fabric"] == hier["recorded_bits_per_step"] == hier["bits_per_step"]
        assert hier["bits_slow_fabric"] < res["exact"]["bits_per_step"] / 10
        assert hier["slow_collectives"] >= 1
        for name, r in res.items():
            recorded = r.get("recorded_bits_per_step", r.get("recorded_bits_per_round"))
            assert recorded == r.get("bits_per_round", r["bits_per_step"]), name
    # the gathers' bits grow with the world: four contributions each
    assert runs["study"][0]["results"]["signsgd"]["compression_ratio"] < 32 / 4 + 1
