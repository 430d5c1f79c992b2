"""The slice as a whole: two ``ef_momentum`` PowerSGD training steps of the
port's ``make_train_step`` against the JAX package's, on the small ResNet-18
from carried weights, the same batches and the same initial Q, on one
worker (with either of the port's compress pipelines) and on two (two Gloo ranks against a two-device JAX mesh); the
exact-DDP identity; gradient accumulation and clipping; and the entry point
on the CPU.

Tolerance: fp32, rtol = atol = 1e-4 for parameters, momenta and error
memories after two steps. The per-parameter gradients already differ by up
to ~5e-5 (``test_torch_resnet.py``: XLA and PyTorch sum the convolution
backward in different orders), and PowerSGD's Gram-Schmidt divides by
column norms, which carries that difference into the compressed update.
Losses: 1e-5, as the logits.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.experiments.common import image_classifier_loss as jax_loss_fn
from network_distributed_pytorch_tpu.models import resnet18 as jax_resnet18
from network_distributed_pytorch_tpu.parallel import make_mesh
from network_distributed_pytorch_tpu.parallel.reducers import PowerSGDReducer as JaxPowerSGD
from network_distributed_pytorch_tpu.parallel.trainer import make_train_step as jax_make_train_step
from network_distributed_pytorch_tpu_torch.experiments import powersgd_cifar10
from network_distributed_pytorch_tpu_torch.experiments.common import image_classifier_loss
from network_distributed_pytorch_tpu_torch.models.import_weights import (
    powersgd_state_from_jax,
    resnet_state_dict_from_flax,
)
from network_distributed_pytorch_tpu_torch.models.resnet import resnet18
from network_distributed_pytorch_tpu_torch.parallel.reducers import ExactReducer, PowerSGDReducer
from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step
from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig
from torch_parity import random_flax_variables, to_numpy
from torch_worker import TinyConvNet, exact_ddp_steps, few_torch_threads, numpy_batches, powersgd_train_rank, run_all, spawn  # few_torch_threads: autouse

TOL = 1e-4
LOSS_TOL = 1e-5
LR = 0.01


def _jax_setup(mesh, accum_steps=1, max_grad_norm=None):
    model = jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16)
    variables = random_flax_variables(model, (1, 32, 32, 3), seed=11)
    step = jax_make_train_step(
        jax_loss_fn(model, has_batch_stats=True),
        JaxPowerSGD(random_seed=1, compression_rank=4, matricize="last"),
        variables["params"], LR, momentum=0.9, algorithm="ef_momentum", mesh=mesh,
        donate_state=False, accum_steps=accum_steps, max_grad_norm=max_grad_norm,
    )
    state = step.init_state(variables["params"], model_state={"batch_stats": variables["batch_stats"]})
    return variables, step, state


def _torch_named(tree, stats=None):
    variables = {"params": to_numpy(tree)}
    if stats is not None:
        variables["batch_stats"] = to_numpy(stats)
    return resnet_state_dict_from_flax(variables)


def _close(got, want, tol, what):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=tol, atol=tol, err_msg=f"{what} {k}")


@functools.lru_cache(maxsize=None)
def _jax_two_steps(accum_steps, max_grad_norm):
    """The JAX ``"xla"`` side of the one-worker check, run once per
    (accumulation, clipping) and shared by the port's compress pipelines."""
    variables, jstep, jstate = _jax_setup(None, accum_steps, max_grad_norm)
    batches = numpy_batches(seed=12, n_steps=2, batch=8)
    if accum_steps > 1:
        batches = [tuple(a.reshape((accum_steps, -1) + a.shape[1:]) for a in b) for b in batches]
    jlosses = []
    for b in batches:
        jstate, loss = jstep(jstate, tuple(jnp.asarray(a) for a in b))
        jlosses.append(float(loss))
    return variables, jstep, jstate, batches, jlosses


@pytest.mark.parametrize(
    "accum_steps,max_grad_norm,compress_impl",
    [(1, None, "xla"), (2, 0.5, "xla"), (1, None, "pallas")],
    ids=["plain", "accum2_clip", "plain_fused"],
)
def test_one_worker_two_steps_match_jax(accum_steps, max_grad_norm, compress_impl):
    """The port's step, on either compress pipeline, against the JAX
    ``"xla"`` step."""
    variables, jstep, jstate, batches, jlosses = _jax_two_steps(accum_steps, max_grad_norm)

    model = resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device="cpu")
    model.load_state_dict(resnet_state_dict_from_flax(to_numpy(variables)))
    reducer = PowerSGDReducer(random_seed=1, compression_rank=4, matricize="last", compress_impl=compress_impl)
    step = make_train_step(
        image_classifier_loss(), reducer, model, LR, 0.9, "ef_momentum",
        accum_steps=accum_steps, max_grad_norm=max_grad_norm,
    )
    state = step.init_state()
    q0 = np.asarray(jax.device_get(jstep.init_state(variables["params"]).reducer_state.q_memory))
    state.reducer_state = powersgd_state_from_jax(q0, variables["params"], reducer, model)
    losses = []
    for b in batches:
        state, loss = step(state, tuple(torch.from_numpy(a) for a in b))
        losses.append(float(loss))

    assert step.bits_per_step == jstep.bits_per_step
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)
    _close(state.params, _torch_named(jstate.params), TOL, "params")
    _close(state.momenta, _torch_named(jstate.momenta), TOL, "momenta")
    _close(state.memories, _torch_named(jstate.memories), TOL, "memories")
    stats = _torch_named({}, jstate.model_state["batch_stats"])
    _close(state.model_state, {k: v for k, v in stats.items() if k.endswith("running_mean")}, TOL, "bn")
    # Q after two steps, joined by name
    q_now = powersgd_state_from_jax(
        np.asarray(jstate.reducer_state.q_memory), variables["params"], reducer, model
    ).q_memory
    np.testing.assert_allclose(state.reducer_state.q_memory.numpy(), q_now.numpy(), rtol=TOL, atol=TOL)


DDP_BATCHES = numpy_batches(seed=14, n_steps=3, batch=16, hw=8)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two Gloo ranks for both two-rank checks of this module:
    the two PowerSGD steps from the weights, Q and batches of the JAX
    two-device run, and the exact-DDP steps on ``DDP_BATCHES``."""
    mesh = make_mesh(devices=jax.devices()[:2])
    variables, jstep, jstate = _jax_setup(mesh)
    batches = numpy_batches(seed=13, n_steps=2, batch=16)
    jlosses = []
    for b in batches:
        jstate, loss = jstep(jstate, tuple(jnp.asarray(a) for a in b))
        jlosses.append(float(loss))

    q0 = np.asarray(jax.device_get(jstep.init_state(variables["params"]).reducer_state.q_memory))
    model = resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device="cpu")
    reducer = PowerSGDReducer(random_seed=1, compression_rank=4, matricize="last")
    q_port = powersgd_state_from_jax(q0, variables["params"], reducer, model).q_memory
    sd = resnet_state_dict_from_flax(to_numpy(variables))
    calls = [(powersgd_train_rank, (sd, q_port, batches, LR)), (exact_ddp_steps, (DDP_BATCHES,))]
    powersgd, exact_ddp = zip(*spawn(run_all, 2, tmp_path_factory.mktemp("ranks"), calls))
    return {
        "jax": (jstep, jstate, jlosses), "powersgd": powersgd, "exact_ddp": exact_ddp,
    }


def test_two_workers_two_steps_match_jax(two_ranks):
    """Two Gloo ranks against a two-device JAX mesh: the same global
    batches, each worker its half; parameters and momenta are the same on
    both ranks, each rank keeps its own error memory and BN statistics."""
    jstep, jstate, jlosses = two_ranks["jax"]
    ranks = two_ranks["powersgd"]
    for res in ranks:
        assert res["bits_per_step"] == jstep.bits_per_step
        np.testing.assert_allclose(res["losses"], jlosses, rtol=LOSS_TOL, atol=LOSS_TOL)
        _close(res["params"], _torch_named(jstate.params), TOL, "params")
        _close(res["momenta"], _torch_named(jstate.momenta), TOL, "momenta")
    for k in ranks[0]["params"]:
        assert torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
    memories = to_numpy(jstate.memories)
    stats = to_numpy(jstate.model_state["batch_stats"])
    for w, res in enumerate(ranks):
        _close(res["memories"], _torch_named(jax.tree_util.tree_map(lambda a: a[w], memories)), TOL, "memories")
        bn = _torch_named({}, jax.tree_util.tree_map(lambda a: a[w], stats))
        _close(res["buffers"], {k: v for k, v in bn.items() if k.endswith("running_mean")}, TOL, "bn")


def test_exact_ddp_equals_single_process_large_batch(two_ranks):
    """Two ranks, each on half of every batch, give the parameters one
    process gets from the whole batch: the mean of the ranks' gradients is
    the large-batch gradient. Tolerance 1e-5: only the order of the sums
    differs."""
    single = exact_ddp_steps(0, 1, None, DDP_BATCHES)
    for res in two_ranks["exact_ddp"]:
        np.testing.assert_allclose(res["losses"], single["losses"], rtol=1e-5, atol=1e-5)
        for k, v in single["params"].items():
            torch.testing.assert_close(res["params"][k], v, rtol=1e-5, atol=1e-5)


def test_accumulation_equals_big_batch():
    """``accum_steps=4`` over quarter batches gives the big-batch step on a
    stateless model (tolerance 1e-5: only the summation order differs)."""
    batches = numpy_batches(seed=15, n_steps=2, batch=16, hw=8)
    finals = []
    for k in (1, 4):
        model = TinyConvNet()
        step = make_train_step(image_classifier_loss(), ExactReducer(), model, 0.05, 0.9, "sgd", accum_steps=k)
        state = step.init_state()
        for x, y in batches:
            b = (torch.from_numpy(x), torch.from_numpy(y))
            if k > 1:
                b = tuple(t.reshape((k, -1) + t.shape[1:]) for t in b)
            state, _ = step(state, b)
        finals.append(state.params)
    for name in finals[0]:
        torch.testing.assert_close(finals[1][name], finals[0][name], rtol=1e-5, atol=1e-5)


def test_run_on_cpu_end_to_end():
    cfg = ExperimentConfig(training_epochs=1, global_batch_size=16, learning_rate=0.01, reducer_rank=4)
    out = powersgd_cifar10.run(cfg, preset="small", device="cpu", max_steps_per_epoch=2)
    assert out["steps"] == 2 and out["num_devices"] == 1 and not out["real_data"]
    assert all(np.isfinite(out["losses"]))
    # one rank still sums the loss through its (Gloo) group: + 32 bits
    reducer = PowerSGDReducer(compression_rank=4, matricize="last")
    model = resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device="cpu")
    assert out["bits_per_step"] == reducer.bits_per_step(list(model.parameters())) + 32
    assert out["bits_communicated"] == 2 * out["bits_per_step"]


def test_entry_points_raise_without_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    cfg = ExperimentConfig(training_epochs=1, global_batch_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        powersgd_cifar10.run(cfg, preset="small", max_steps_per_epoch=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        powersgd_cifar10.build_model("small")


def test_the_telemetry_fields_construct_and_run(tmp_path):
    """``event_log``, ``trace_dir``, ``audit_wire`` and ``health_every`` are
    ported: they construct, and a run writes the log, the audit, the probes
    and the trace they ask for."""
    cfg = ExperimentConfig(
        training_epochs=1, global_batch_size=16, event_log=str(tmp_path / "run.jsonl"),
        trace_dir=str(tmp_path / "trace"), audit_wire=True, health_every=2,
    )
    out = powersgd_cifar10.run(cfg, preset="small", device="cpu", max_steps_per_epoch=2)
    kinds = [json.loads(line)["event"] for line in open(cfg.event_log)]
    assert kinds.count("step") == 2 and kinds.count("compile") == 1 and kinds.count("train_health") == 1
    assert np.isfinite(out["losses"]).all() and (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_config_rejects_unported_options():
    """The comm fields are ported and validated; the fields still unported
    raise rather than being ignored."""
    assert ExperimentConfig(compress_impl="pallas").compress_impl == "pallas"
    with pytest.raises(ValueError):
        ExperimentConfig(compress_impl="bogus")
    cfg = ExperimentConfig(bucket_bytes=1 << 20, comm_chunks=4, comm_strategy="ring")
    assert (cfg.bucket_bytes, cfg.comm_chunks, cfg.comm_strategy) == (1 << 20, 4, "ring")
    for bad in ({"comm_chunks": 0}, {"bucket_bytes": 0}, {"comm_strategy": "tree"}):
        with pytest.raises(ValueError):
            ExperimentConfig(**bad)
    for unported in ({"chaos_plan": "plan.json"}, {"comm_fabric": "DCN"}, {"adaptive_comm": True}):
        with pytest.raises(NotImplementedError):
            ExperimentConfig(**unported)
    # compute_dtype is ported, the ResNet's bf16 included (held to JAX in test_torch_resnet_bf16.py)
    with pytest.raises(ValueError):
        ExperimentConfig(compute_dtype="float16")
    model, _, _ = powersgd_cifar10.build(ExperimentConfig(compute_dtype="bfloat16"), "small", "cpu", None)
    assert model.dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError):
        ExperimentConfig(orthogonalize_impl="pallas")
