"""The model-parallel GPT entry points against the JAX package's:
``gpt_tp``, ``gpt_sp``, ``gpt_pp`` and ``gpt_moe``'s ``run()`` at preset
small, two steps, from the JAX run's own initial weights (captured from
its ``audited_carry_loop``), on 4 Gloo ranks against 4 CPU devices: the
losses, every parameter after the two steps, and the bits a step by
collective kind. Also the launcher's flags and refusals, the entries'
refusals, and ``gpt_pp`` and ``gpt_sp`` resuming from ``--checkpoint-dir``
bit for bit the uninterrupted run.

Bits: the JAX numbers are its compiled step's HLO audit; the port's are
what ``parallel.comm.record_collectives`` saw on rank 0 in one step. Where
the two programs issue different collectives, the test pins the port's
count from the JAX one and names the difference:

- TP: JAX sums the cotangent of each block's replicated attention input
  once per projection (q, k and v: three ``all-reduce``s), the port once
  (``copy_to_axis`` on the shared input), so JAX has 2 more activation
  all-reduces a block; with one data shard JAX also all-reduces the
  gradients and the loss over the size-1 data axis, which the port skips;
  the vocabulary-parallel loss' ``pmean`` of the gathered maximum (an
  identity) is JAX's alone.
- Ring: the ``collective-permute``s of the ring's loop body appear once in
  the HLO; the loop runs N hops, of which the port makes N - 1 (the JAX
  loop's last permute hands each block back to its owner).
- SP: JAX all-reduces the tied head's part of ``wte``'s gradient apart
  from the lookup's, as a ``(dim, vocab)`` transpose: one table's bytes
  more than the port, which sums the two parts first.
- 1F1B: JAX's lockstep scan body holds one activation and one gradient
  ``collective-permute``; stage 0 of the port sends each of its M
  microbatch activations. JAX's masked psums share the input cotangent
  ``dx`` over the pipe axis; the port sums the embedding's own gradients
  there instead (``wpe`` with ``wte``), in one all-reduce.

Tolerance 1e-5 relative and absolute, as ``tests/test_torch_gpt.py``.
A PowerSGD run starts from the JAX reducer's Q, joined by parameter name
(``powersgd_state_from_jax`` over the entry's own ``make_reducer``).
"""

import functools
import importlib

import jax
import numpy as np
import pytest
import torch

import torch_model_parallel_worker as w
import torch_worker
from network_distributed_pytorch_tpu.parallel.mesh import make_mesh as jax_make_mesh
from network_distributed_pytorch_tpu_torch import launch
from network_distributed_pytorch_tpu_torch.experiments import gpt_pp, gpt_sp, gpt_tp
from network_distributed_pytorch_tpu_torch.models.gpt import GPTConfig, gpt_tp_param_specs, make_gpt_stage_fn
from network_distributed_pytorch_tpu_torch.models.import_weights import (
    gpt_state_dict_from_flax,
    gpt_torch_name,
    moe_params_from_jax,
)
from torch_parity import to_numpy
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

TOL = 1e-5
STEPS = 2
CFG = dict(training_epochs=1, global_batch_size=16, learning_rate=0.1, log_every=0)
# name, the JAX mesh, run() keyword arguments
RUNS = {
    "tp4": ("gpt_tp", ((1, 4), ("data", "model")), dict(model_shards=4)),
    "tp2_vocab": ("gpt_tp", ((2, 2), ("data", "model")), dict(model_shards=2, vocab_parallel=True)),
    "tp2_powersgd": ("gpt_tp", ((2, 2), ("data", "model")), dict(model_shards=2, reducer="powersgd")),
    "sp_ring": ("gpt_sp", ((4,), ("seq",)), dict(seq_impl="ring", seq_len=64)),
    "sp_ulysses": ("gpt_sp", ((4,), ("seq",)), dict(seq_impl="ulysses", seq_len=64)),
    "pp4": ("gpt_pp", ((4,), ("pipe",)), dict()),
    "pp2x2": ("gpt_pp", ((2, 2), ("data", "pipe")), dict(data_shards=2)),
    "pp2x2_powersgd": ("gpt_pp", ((2, 2), ("data", "pipe")), dict(data_shards=2, reducer="powersgd")),
    "moe": ("gpt_moe", ((4,), ("expert",)), dict()),
    "moe_powersgd": ("gpt_moe", ((4,), ("expert",)), dict(reducer="powersgd", experts_per_device=2, top_k=2)),
}
NAMES = list(RUNS)


@functools.lru_cache(maxsize=None)
def _jax_run(key):
    """The JAX run, its initial and final carries (numpy) and audit."""
    name, (sizes, axes), kwargs = RUNS[key]
    module = importlib.import_module(f"network_distributed_pytorch_tpu.experiments.{name}")
    cfg = importlib.import_module("network_distributed_pytorch_tpu.utils.config").ExperimentConfig(**CFG)
    kept = {}
    loop = module.audited_carry_loop

    def keep(jitted, carry, *args, **kw):
        kept["initial"] = to_numpy(carry)  # before the donated first call
        carry, logger, audit = loop(jitted, carry, *args, **kw)
        kept.update(final=to_numpy(carry), audit=audit, losses=[r.loss for r in logger.records])
        return carry, logger, audit

    module.audited_carry_loop = keep
    try:
        mesh = jax_make_mesh(axis_sizes=sizes, axis_names=axes, devices=jax.devices()[: int(np.prod(sizes))])
        kept["summary"] = module.run(cfg, mesh=mesh, max_steps_per_epoch=STEPS, **kwargs)
    finally:
        module.audited_carry_loop = loop
    return kept


def _unstacked(embed, stacked, final):
    """The JAX pipeline pieces as one GPTLM tree."""
    n, per = np.asarray(stacked["layers"]["ln_1"]["scale"]).shape[:2]
    tree = {**embed, **final}
    for s in range(n):
        for j in range(per):
            tree[f"h_{s * per + j}"] = jax.tree_util.tree_map(lambda a, s=s, j=j: np.asarray(a)[s, j], stacked["layers"])
    return tree


def _port_state(key):
    """The ``state`` argument of ``entry_rank``: the JAX run's initial weights."""
    name = RUNS[key][0]
    carry = _jax_run(key)["initial"]
    if name == "gpt_moe":
        params, routers, experts = carry[0]
        return {"moe": tuple(zip(*[moe_params_from_jax(params, routers, experts, (r, 4)) for r in range(4)]))[:2]
                + ([moe_params_from_jax(params, routers, experts, (r, 4))[2] for r in range(4)],)}
    params = _unstacked(*carry[0]) if name == "gpt_pp" else carry[0]
    return {"sd": {k: v.numpy() for k, v in gpt_state_dict_from_flax({"params": params}).items()}}


def _tp_local_tree(params, vocab_parallel, n_model):
    """The JAX TP reducer's leaves: the model-sharded ones (model rank 0's
    shard; every rank's has the same shape), in the flax tree."""
    specs = gpt_tp_param_specs(GPTConfig(n_layers=2, dim=32, n_heads=8, hidden_dim=64, vocab_size=64), vocab_parallel)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                sub = walk(v, path + (k,))
                if sub:
                    out[k] = sub
                continue
            d = specs[gpt_torch_name(path + (k,))]
            if d is not None:
                axis = 1 - d if k == "kernel" else d  # a kernel is the (in, out) transpose
                out[k] = np.split(np.asarray(v), n_model, axis=axis)[0]
        return out

    return walk(params, ())


def _state(key):
    st = _port_state(key)
    if "moe" in st:
        bases, routers, experts = st["moe"]
        st = {"moe": ({k: v.numpy() for k, v in bases[0].items()}, {k: v.numpy() for k, v in routers[0].items()},
                      [{k: v.numpy() for k, v in e.items()} for e in experts])}
    name, _, kwargs = RUNS[key]
    if kwargs.get("reducer") == "powersgd":  # start from the JAX reducer's Q
        carry = _jax_run(key)["initial"]
        q = None if name == "gpt_pp" else np.asarray(carry[3].q_memory)
        if name == "gpt_tp":
            st["q"] = (q[0], _tp_local_tree(carry[0], kwargs.get("vocab_parallel", False), kwargs["model_shards"]))
        elif name == "gpt_pp":  # embed, this stage's slice of the stacked blocks, final
            embed, stacked, final = carry[0]
            local = {"layers": jax.tree_util.tree_map(lambda a: np.asarray(a)[:1], stacked["layers"])}
            rs_e, rs_s, rs_f = carry[3]
            st["q"] = [(np.asarray(rs_e.q_memory), embed), (np.asarray(rs_s.q_memory)[0], local),
                       (np.asarray(rs_f.q_memory), final)]
        else:
            st["q"] = (q, {"0": carry[0][0], "1": carry[0][1]})
    return st


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    root = tmp_path_factory.mktemp("gpt_parallel")
    calls = [(w.entry_rank, (RUNS[k][0], CFG, {**RUNS[k][2], "max_steps_per_epoch": STEPS}, _state(k))) for k in NAMES]
    # resume: 2 epochs uninterrupted, then 1 epoch and a resumed second into a checkpoint directory
    for name, kwargs in (("gpt_sp", dict(seq_impl="ring", seq_len=64)), ("gpt_pp", dict(data_shards=2))):
        kw = {**kwargs, "max_steps_per_epoch": STEPS}
        ckpt = str(root / f"ckpt_{name}")
        calls.append((w.entry_rank, (name, {**CFG, "training_epochs": 2}, kw)))
        calls.append((w.entry_rank, (name, CFG, {**kw, "checkpoint_dir": ckpt})))
        calls.append((w.entry_rank, (name, {**CFG, "training_epochs": 2}, {**kw, "checkpoint_dir": ckpt})))
    return torch_worker.spawn(torch_worker.run_all, 4, root, calls)


def _result(port, key, rank=0):
    return port[rank][NAMES.index(key)]


def _jax_bytes(audit):
    out = {}
    for op in audit["ops"]:
        out[op.kind] = out.get(op.kind, 0) + op.payload_bytes
    return out


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL, err_msg=what)


def _check_losses(port, key, full=True):
    want = _jax_run(key)["losses"]
    for r in range(4):
        got = _result(port, key, r)["summary"]["losses"]
        assert len(got) == len(want) == STEPS
        _close(got if full else got[:1], want if full else want[:1], key)


def _port_bytes(port, key):
    return _result(port, key)["summary"]["collective_bytes"]


# ---- gpt_tp -----------------------------------------------------------------


@pytest.mark.parametrize("key", ["tp4", "tp2_vocab", "tp2_powersgd"])
def test_gpt_tp_run_matches_jax(port, key):
    _check_losses(port, key)
    kwargs = RUNS[key][2]
    n_model = kwargs["model_shards"]
    vp = kwargs.get("vocab_parallel", False)
    specs = gpt_tp_param_specs(GPTConfig(n_layers=2, dim=32, n_heads=8, hidden_dim=64, vocab_size=64), vp)
    want = gpt_state_dict_from_flax({"params": _jax_run(key)["final"][0]})
    shards = [_result(port, key, r)["final"] for r in range(n_model)]  # data replica 0
    for name, v in want.items():
        d = specs[name]
        got = torch.cat([s[name] for s in shards], dim=d) if d is not None else shards[0][name]
        _close(got, v, name)
    # bits, by kind: JAX's three q/k/v cotangent sums a block and more (module docstring)
    n_data = 4 // n_model
    act = 16 // n_data * 32 * 32 * 4  # (local batch, T, dim) fp32
    jax_bytes = _jax_bytes(_jax_run(key)["audit"])
    extra = 2 * 2 * act  # 2 layers
    if n_data == 1:
        extra += 4 + sum(v.numel() * 4 for v in shards[0].values())
    if vp:
        extra += 16 // n_data * 32 * 4
    assert _port_bytes(port, key)["all-reduce"] == jax_bytes["all-reduce"] - extra
    assert {k: v for k, v in _port_bytes(port, key).items() if k != "all-reduce"} == {
        k: v for k, v in jax_bytes.items() if k != "all-reduce"
    }


# ---- gpt_sp -----------------------------------------------------------------


@pytest.mark.parametrize("key", ["sp_ring", "sp_ulysses"])
def test_gpt_sp_run_matches_jax(port, key):
    _check_losses(port, key)
    want = gpt_state_dict_from_flax({"params": _jax_run(key)["final"][0]})
    for r in range(4):
        got = _result(port, key, r)["final"]
        for name, v in want.items():
            _close(got[name], v, name)
    jax_bytes = _jax_bytes(_jax_run(key)["audit"])
    got = _port_bytes(port, key)
    # JAX all-reduces the tied head's part of wte's gradient on its own, as
    # a (dim, vocab) transpose; the port sums wte's two parts first
    assert got["all-reduce"] == jax_bytes["all-reduce"] - 64 * 32 * 4
    if key == "sp_ring":  # the loop body once in the HLO; N - 1 hops made
        assert got["collective-permute"] == 3 * jax_bytes["collective-permute"]
    else:
        assert got["all-to-all"] == jax_bytes["all-to-all"]
    assert set(got) == set(jax_bytes)


# ---- gpt_pp -----------------------------------------------------------------


@pytest.mark.parametrize("key", ["pp4", "pp2x2", "pp2x2_powersgd"])
def test_gpt_pp_run_matches_jax(port, key):
    _check_losses(port, key)
    n_data = RUNS[key][2].get("data_shards", 1)
    n_stages = 4 // n_data
    want = gpt_state_dict_from_flax({"params": _unstacked(*_jax_run(key)["final"][0])})
    for r in range(4):
        got = _result(port, key, r)["final"]
        s = r % n_stages
        for k, v in got.items():
            group, name = k.split("/", 1)
            full = f"h.{s}.{name}" if group == "stage" else name
            _close(v[0] if group == "stage" else v, want[full], k)
    mb_act = 16 // n_data // 4 * 32 * 32 * 4  # a microbatch's activation
    dx, wpe = 16 // n_data * 32 * 32 * 4, 32 * 32 * 4
    jax_bytes = _jax_bytes(_jax_run(key)["audit"])
    assert jax_bytes["collective-permute"] == 2 * mb_act
    assert _port_bytes(port, key) == {
        "collective-permute": 4 * mb_act, "all-reduce": jax_bytes["all-reduce"] - dx + wpe,
    }


# ---- gpt_moe ----------------------------------------------------------------


@pytest.mark.parametrize("key", ["moe", "moe_powersgd"])
def test_gpt_moe_run_matches_jax(port, key):
    _check_losses(port, key)
    params, routers, experts = _jax_run(key)["final"][0]
    assert _result(port, key)["summary"]["reducer"] == RUNS[key][2].get("reducer", "exact")
    for r in range(4):
        base, rts, exps = moe_params_from_jax(params, routers, experts, (r, 4))
        got = _result(port, key, r)["final"]
        want = {**{f"base/{k}": v for k, v in base.items()}, **{f"router/{k}": v for k, v in rts.items()},
                **{f"expert/{k}": v for k, v in exps.items()}}
        assert set(got) == set(want)
        for name, v in want.items():
            _close(got[name], v, name)
    summary, jax_summary = _result(port, key)["summary"], _jax_run(key)["summary"]
    for k in ("n_experts", "capacity", "top_k"):
        assert summary[k] == jax_summary[k]
    for k in ("final_ce", "final_aux_loss", "final_dropped_fraction"):
        _close(summary[k], jax_summary[k], k)
    assert _port_bytes(port, key) == _jax_bytes(_jax_run(key)["audit"])


# ---- resume ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gpt_sp", "gpt_pp"])
def test_resume_from_checkpoint_dir_is_bitwise_the_uninterrupted_run(port, name):
    base = len(NAMES) + (0 if name == "gpt_sp" else 3)
    for r in range(4):
        whole, first, resumed = (port[r][base + i] for i in range(3))
        assert first["summary"]["steps"] == STEPS and resumed["summary"]["steps"] == STEPS  # one epoch each
        assert resumed["summary"]["losses"] == whole["summary"]["losses"][STEPS:]
        for k, v in whole["final"].items():
            assert torch.equal(resumed["final"][k], v), k


# ---- refusals and the launcher -------------------------------------------------


@pytest.mark.parametrize(
    "args",
    [
        ["gpt_lm", "--model-shards", "2"],
        ["gpt_pp", "--tp-reducer", "powersgd"],
        ["gpt_tp", "--data-shards", "2"],
        ["gpt_moe", "--vocab-parallel"],
        ["gpt_tp", "--checkpoint-dir", "d"],
        ["gpt_sp", "--moe-top-k", "2"],
        ["gpt_moe", "--pp-reducer", "exact"],
        ["exact_cifar10", "--experts-per-device", "2"],
    ],
)
def test_launcher_refuses_model_parallel_flags_elsewhere(args):
    with pytest.raises(ValueError, match=args[1]):
        launch.main([*args, "--device", "cpu"])


@pytest.mark.parametrize(
    "args",
    [
        ["gpt_tp", "--model-shards", "1", "--vocab-parallel"],
        ["gpt_sp", "--dtype", "bfloat16"],
        ["gpt_pp", "--max-steps-per-epoch", "1"],
        ["gpt_moe", "--experts-per-device", "2", "--moe-top-k", "2", "--moe-reducer", "powersgd"],
    ],
)
def test_launcher_runs_the_model_parallel_entries_on_cpu(args, capsys):
    out = launch.main([*args, "--device", "cpu", "--epochs", "1", "--global-batch", "8", "--json"]
                      + ([] if "--max-steps-per-epoch" in args else ["--max-steps-per-epoch", "2"]))
    assert out["experiment"] == args[0] and np.isfinite(out["final_loss"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")


def test_entries_refuse_what_the_reference_refuses():
    from network_distributed_pytorch_tpu_torch.experiments import gpt_moe

    with pytest.raises(ValueError, match="data axis"):
        gpt_tp.run(model_shards=1, reducer="powersgd", device="cpu", max_steps_per_epoch=1)
    with pytest.raises(ValueError, match="must divide the device count"):
        gpt_tp.run(model_shards=2, device="cpu", max_steps_per_epoch=1)
    with pytest.raises(ValueError, match="data_shards"):
        gpt_pp.run(reducer="powersgd", device="cpu", max_steps_per_epoch=1)
    with pytest.raises(ValueError, match="reducer"):
        gpt_moe.run(reducer="topk", device="cpu", max_steps_per_epoch=1)
    with pytest.raises(ValueError, match="dropout"):
        make_gpt_stage_fn(GPTConfig(dropout=0.1), 1)
    with pytest.raises(ValueError, match="seq_impl"):
        gpt_sp.run(seq_impl="star", device="cpu", max_steps_per_epoch=1)


def test_entry_points_raise_without_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    for run in (gpt_tp.run, gpt_sp.run, gpt_pp.run):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(max_steps_per_epoch=1)
