"""The baselines' pieces in the PyTorch port against the JAX package: the
trainer's ``sgd_nesterov``, ``sgd_plain`` and ``"optax"`` (AdamW) updates;
``SmallCNN``, ``MLP`` and the GroupNorm ResNet; ``imdb_baseline.run`` with
either optimizer; both evaluators on a ragged last batch; and the launcher's
``imdb_baseline`` and ``bare_init``.

Tolerances: fp32, 1e-5 for logits, losses and parameters after two steps
(the frameworks sum the same products in other orders). AdamW is held to
the same 1e-5: optax adds ``wd * p`` to the update where torch scales ``p``
by ``1 - lr * wd`` first, equal in exact arithmetic and within rounding
here (SmallCNN, lr 1e-3). In ``imdb_baseline`` Adam divides by the
gradient's own size, which turns fp32 rounding into a part of a step:
where two steps' gradients nearly cancel in Adam's first moment (some
position-embedding entries), the two frameworks' parameters differ by up to
0.25 % of lr. So the AdamW run takes the reference's lr 5e-5 and holds
parameters to 1e-6 (2 % of a step), losses to 1e-5. The attention's key
bias (``k_lin.bias``) has a zero gradient in exact arithmetic (a softmax
does not change when every score of a query moves by the same amount), so
both frameworks hand Adam rounding noise, which it scales up to a step of
about lr: those leaves are held to Adam's bound, 2 lr a step
(``ADAM_NOISE_BOUND``). The evaluators' accuracies are equal exactly, on
labels built from the JAX predictions so that every prediction counts.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from network_distributed_pytorch_tpu.experiments import common as jax_common
from network_distributed_pytorch_tpu.experiments import imdb_baseline as jax_imdb_baseline
from network_distributed_pytorch_tpu.models import distilbert as jax_distilbert
from network_distributed_pytorch_tpu.models import resnet18 as jax_resnet18
from network_distributed_pytorch_tpu.models.cnn import SmallCNN as JaxSmallCNN
from network_distributed_pytorch_tpu.models.mlp import MLP as JaxMLP
from network_distributed_pytorch_tpu.parallel.reducers import ExactReducer as JaxExactReducer
from network_distributed_pytorch_tpu.parallel.trainer import init_train_state, make_step_fn
from network_distributed_pytorch_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
from network_distributed_pytorch_tpu.utils.losses import cross_entropy_loss as jax_cross_entropy
from network_distributed_pytorch_tpu_torch import launch
from network_distributed_pytorch_tpu_torch.experiments import common, imdb_baseline
from network_distributed_pytorch_tpu_torch.models import distilbert
from network_distributed_pytorch_tpu_torch.models.cnn import SmallCNN
from network_distributed_pytorch_tpu_torch.models.import_weights import (
    distilbert_state_dict_from_flax,
    resnet_state_dict_from_flax,
)
from network_distributed_pytorch_tpu_torch.models.mlp import MLP
from network_distributed_pytorch_tpu_torch.models.resnet import resnet18
from network_distributed_pytorch_tpu_torch.parallel.reducers import ExactReducer
from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step
from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig
from network_distributed_pytorch_tpu_torch.utils.losses import cross_entropy_loss
from torch_parity import random_distilbert_params, random_flax_variables, to_numpy
from torch_worker import few_torch_threads, numpy_batches  # noqa: F401  (autouse)

TOL = 1e-5
# Adam's |m-hat| / (sqrt(v-hat) + eps) is at most 1.0014 in the first two
# steps, so one run moves a parameter at most about lr a step, and two runs
# differ by at most 2 lr a step
ADAM_NOISE_BOUND = 2.01
NOISE_LEAVES = "attention.k_lin.bias"  # a zero gradient in exact arithmetic


def _close(got, want, what, tol=TOL, skip=()):
    assert set(got) == set(want), what
    for name, w in want.items():
        if name not in skip:
            np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), rtol=tol, atol=tol, err_msg=f"{what} {name}")


# ---- models -------------------------------------------------------------------

MODELS = {
    "small_cnn": (lambda: JaxSmallCNN(width=8), lambda: SmallCNN(width=8, device="cpu"), (1, 32, 32, 3), {}),
    "mlp": (lambda: JaxMLP((64, 32, 10)), lambda: MLP(16 * 16 * 3, (64, 32, 10), device="cpu"), (1, 16, 16, 3), {}),
    # flax's GroupNorm needs channels divisible by its 32 groups: width 32
    "resnet18_group": (
        lambda: jax_resnet18(num_classes=10, norm="group", stem="cifar", width=32),
        lambda: resnet18(num_classes=10, norm="group", stem="cifar", width=32, device="cpu"),
        (1, 32, 32, 3), None,
    ),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_match_flax(name):
    make_jax, make_port, input_shape, init_kwargs = MODELS[name]
    jax_model = make_jax()
    variables = to_numpy(random_flax_variables(jax_model, input_shape, seed=30, init_kwargs=init_kwargs))
    assert set(variables) == {"params"}  # none of them keeps running statistics
    model = make_port()
    model.load_state_dict(resnet_state_dict_from_flax(variables))
    x = np.random.RandomState(31).uniform(-1, 1, (5,) + input_shape[1:]).astype(np.float32)
    kwargs = {"train": True} if init_kwargs is None else {}
    want = np.asarray(jax_model.apply(variables, jnp.asarray(x), **kwargs))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == want.shape == (5, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_group_norm_is_flax_s():
    norm = resnet18(norm="group", stem="cifar", width=32, device="cpu").norm_init
    assert isinstance(norm, torch.nn.GroupNorm)
    assert (norm.num_groups, norm.eps) == (32, 1e-6)


# ---- the trainer's update rules ------------------------------------------------

LR = {"sgd_nesterov": 0.05, "sgd_plain": 0.05, "optax": 1e-3}


@functools.lru_cache(maxsize=None)
def _jax_two_steps(algorithm):
    """Two steps of the JAX ``make_step_fn`` on one worker (no axis), from
    numpy weights of a ``SmallCNN``: the weights, the batches, the losses
    and the state after each step."""
    jmodel = JaxSmallCNN(width=8)
    params = to_numpy(random_flax_variables(jmodel, (1, 32, 32, 3), seed=32, init_kwargs={}))["params"]

    def loss_fn(p, model_state, batch):
        x, y = batch
        return jax_cross_entropy(jmodel.apply({"params": p}, x), y), model_state

    optimizer = optax.adamw(LR[algorithm]) if algorithm == "optax" else None
    reducer = JaxExactReducer()
    step = jax.jit(make_step_fn(loss_fn, reducer, LR[algorithm], 0.9, algorithm, axis_name=None, optimizer=optimizer))
    state = init_train_state(params, reducer, optimizer=optimizer)
    batches = numpy_batches(seed=33, n_steps=2, batch=8)
    states, losses = [], []
    for b in batches:
        state, loss = step(state, tuple(jnp.asarray(a) for a in b))
        states.append(state)
        losses.append(float(loss))
    return params, batches, losses, states


@pytest.mark.parametrize("algorithm", ["sgd_nesterov", "sgd_plain", "optax"])
def test_update_rules_match_jax(algorithm):
    params, batches, jlosses, jstates = _jax_two_steps(algorithm)
    model = SmallCNN(width=8, device="cpu")
    model.load_state_dict(resnet_state_dict_from_flax({"params": params}))
    optimizer = imdb_baseline.adamw(LR[algorithm]) if algorithm == "optax" else None

    def loss_fn(m, batch):
        x, y = batch
        return cross_entropy_loss(m(x), y)

    step = make_train_step(loss_fn, ExactReducer(), model, LR[algorithm], 0.9, algorithm, optimizer=optimizer)
    state = step.init_state()
    assert (state.optimizer is not None) == (algorithm == "optax")
    for i, (b, jloss, jstate) in enumerate(zip(batches, jlosses, jstates)):
        state, loss = step(state, tuple(torch.from_numpy(a) for a in b))
        np.testing.assert_allclose(float(loss), jloss, rtol=TOL, atol=TOL)
        _close(state.params, resnet_state_dict_from_flax({"params": to_numpy(jstate.params)}), f"step {i} params")
        if algorithm == "sgd_nesterov":
            _close(state.momenta, resnet_state_dict_from_flax({"params": to_numpy(jstate.momenta)}), f"step {i} momenta")
        else:
            assert state.momenta == {}
        assert all(p.grad is None for p in state.params.values())


def test_optimizer_goes_with_optax_only():
    model = MLP(12, (4, 2), device="cpu")
    loss = lambda m, b: m(b[0]).sum()
    with pytest.raises(ValueError, match="optax"):
        make_train_step(loss, ExactReducer(), model, 0.1, algorithm="optax")
    with pytest.raises(ValueError, match="optax"):
        make_train_step(loss, ExactReducer(), model, 0.1, algorithm="sgd", optimizer=imdb_baseline.adamw(0.1))
    with pytest.raises(ValueError, match="algorithm"):
        make_train_step(loss, ExactReducer(), model, 0.1, algorithm="lamb")


# ---- imdb_baseline ---------------------------------------------------------------

BASELINE_LR = {"sgd_nesterov": 0.01, "adamw": 5e-5}  # AdamW: the reference's lr (see above)
BASELINE_TOL = {"sgd_nesterov": TOL, "adamw": 1e-6}


def _baseline_config(optimizer_name, config_cls):
    return config_cls(training_epochs=1, global_batch_size=16, learning_rate=BASELINE_LR[optimizer_name])


@functools.lru_cache(maxsize=None)
def _jax_baseline(optimizer_name):
    """The JAX ``imdb_baseline.run`` of the small preset for two steps from
    numpy weights; its final state is kept from the run's own loop."""
    params = random_distilbert_params(jax_distilbert.distilbert_tiny(), 64, seed=34)
    kept = {}
    train_loop = jax_imdb_baseline.train_loop

    def keep(step, state, *args, **kwargs):
        state, logger = train_loop(step, state, *args, **kwargs)
        kept.update(state=state, logger=logger, bits=step.bits_per_step)
        return state, logger

    jax_imdb_baseline.train_loop = keep
    try:
        jax_imdb_baseline.run(
            _baseline_config(optimizer_name, JaxExperimentConfig), preset="small",
            pretrained_variables={"params": params},
            max_steps_per_epoch=2, optimizer_name=optimizer_name,
        )
    finally:
        jax_imdb_baseline.train_loop = train_loop
    return params, kept


@pytest.mark.parametrize("optimizer_name", ["sgd_nesterov", "adamw"])
def test_imdb_baseline_matches_jax_run(optimizer_name, monkeypatch):
    """Two steps of the port's run (flash attention's plain version) against
    the JAX run (einsum off the TPU) from the same weights."""
    params, jax_out = _jax_baseline(optimizer_name)
    kept = {}
    build = imdb_baseline.build

    def keep(*args, **kwargs):
        kept["model"], step, state = build(*args, **kwargs)
        return kept["model"], step, state

    monkeypatch.setattr(imdb_baseline, "build", keep)
    out = imdb_baseline.run(
        _baseline_config(optimizer_name, ExperimentConfig), preset="small", device="cpu", max_steps_per_epoch=2,
        optimizer_name=optimizer_name, pretrained_state_dict=distilbert_state_dict_from_flax({"params": params}),
        eval_after=True,
    )
    assert out["steps"] == 2 and out["optimizer"] == optimizer_name and out["max_len"] == 64
    # no group and no loss sync: the gradient's bits alone
    assert out["bits_per_step"] == jax_out["bits"] == 32 * sum(p.numel() for p in kept["model"].parameters())
    np.testing.assert_allclose(out["losses"], [r.loss for r in jax_out["logger"].records], rtol=TOL, atol=TOL)
    got = dict(kept["model"].named_parameters())
    want = distilbert_state_dict_from_flax({"params": to_numpy(jax_out["state"].params)})
    noise = {k for k in want if k.endswith(NOISE_LEAVES)} if optimizer_name == "adamw" else set()
    assert len(noise) == (2 if optimizer_name == "adamw" else 0)  # one a layer
    _close(got, want, "params", tol=BASELINE_TOL[optimizer_name], skip=noise)
    bound = ADAM_NOISE_BOUND * BASELINE_LR[optimizer_name] * 2  # two steps
    _close({k: got[k] for k in noise}, {k: want[k] for k in noise}, "params", tol=bound)
    assert 0.0 <= out["eval_accuracy"] <= 1.0


def test_imdb_baseline_bits_of_distilbert_base():
    """``distilbert_base``'s 66,955,010 parameters in fp32, with no loss
    sync: 2,142,560,320 bits a step."""
    leaves = list(distilbert.distilbert_base(device="cpu").parameters())
    assert sum(p.numel() for p in leaves) == 66_955_010
    assert ExactReducer().bits_per_step(leaves) == 2_142_560_320


def test_imdb_baseline_refuses_what_it_does_not_use():
    for config in (None, ExperimentConfig()):
        with pytest.raises(ValueError, match="optimizer_name"):
            imdb_baseline.run(config, preset="small", device="cpu", optimizer_name="lamb")
    with pytest.raises(ValueError, match="comm_chunks"):
        imdb_baseline.build(ExperimentConfig(comm_chunks=2), "small", "cpu")
    with pytest.raises(ValueError, match="one process"):
        imdb_baseline.run(ExperimentConfig(num_processes=2), preset="small", device="cpu")
    assert imdb_baseline.default_config("adamw").training_epochs == 3
    assert imdb_baseline.default_config().training_epochs == 5


# ---- evaluation -------------------------------------------------------------------

N_EVAL, EVAL_BATCH = 37, 16  # a ragged last batch of 5


def _labels_from(predictions):
    """Labels equal to ``predictions`` but for every third, moved by one:
    every prediction counts towards the accuracy."""
    labels = np.asarray(predictions).astype(np.int32).copy()
    labels[::3] = (labels[::3] + 1) % 2 if labels.max() <= 1 else (labels[::3] + 1) % 10
    return labels


def test_evaluate_image_classifier_matches_jax():
    jmodel = jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16)
    variables = to_numpy(random_flax_variables(jmodel, (1, 32, 32, 3), seed=35))
    images = np.random.RandomState(36).uniform(-1, 1, (N_EVAL, 32, 32, 3)).astype(np.float32)
    predictions = jnp.argmax(jmodel.apply(variables, jnp.asarray(images), train=False), axis=-1)
    labels = _labels_from(predictions)
    want = jax_common.evaluate_image_classifier(
        jmodel, variables["params"], variables["batch_stats"], images, labels, batch_size=EVAL_BATCH
    )
    model = resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device="cpu")
    model.load_state_dict(resnet_state_dict_from_flax(variables))
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    got = common.evaluate_image_classifier(model, images, labels, batch_size=EVAL_BATCH)
    assert got == want == 24 / 37
    assert model.training  # left in the mode it was found in
    assert all(torch.equal(v, buffers[k]) for k, v in model.named_buffers())  # eval mode: stats untouched


def test_evaluate_text_classifier_matches_jax():
    jmodel = jax_distilbert.distilbert_tiny()
    params = random_distilbert_params(jmodel, 64, seed=37)
    rng = np.random.RandomState(38)
    ids = rng.randint(3, 1024, (N_EVAL, 64)).astype(np.int32)
    mask = np.ones_like(ids)
    for row in range(N_EVAL):
        mask[row, 10 + row :] = 0
    predictions = jnp.argmax(jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)), axis=-1)
    split = {"input_ids": ids, "attention_mask": mask, "labels": _labels_from(predictions)}
    want = jax_common.evaluate_text_classifier(jmodel, params, split, batch_size=EVAL_BATCH)
    model = distilbert.distilbert_tiny(device="cpu")
    model.load_state_dict(distilbert_state_dict_from_flax({"params": to_numpy(params)}))
    assert common.evaluate_text_classifier(model, split, batch_size=EVAL_BATCH) == want == 24 / 37


def test_powersgd_cifar10_evaluates_after_training():
    from network_distributed_pytorch_tpu_torch.experiments import powersgd_cifar10

    cfg = ExperimentConfig(training_epochs=1, global_batch_size=16, learning_rate=0.01, reducer_rank=4)
    out = powersgd_cifar10.run(cfg, preset="small", device="cpu", max_steps_per_epoch=1, eval_after=True)
    assert out["steps"] == 1 and 0.0 <= out["eval_accuracy"] <= 1.0
    with pytest.raises(ValueError, match="bucket_bytes"):
        powersgd_cifar10.build(ExperimentConfig(bucket_bytes=1024), "small", "cpu", None)


# ---- the launcher ---------------------------------------------------------------------


def test_launcher_runs_imdb_baseline_on_cpu(capsys):
    args = ["imdb_baseline", "--device", "cpu", "--epochs", "1", "--max-steps-per-epoch", "2"]
    cfg = launch.config_from_args(launch.build_parser().parse_args(args))
    assert (cfg.learning_rate, cfg.global_batch_size) == (5e-5, 16)
    out = launch.main(args)
    assert out["experiment"] == "imdb_baseline" and out["steps"] == 2 and not out["real_data"]
    assert out["optimizer"] == "sgd_nesterov" and np.isfinite(out["losses"]).all()
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"experiment": "imdb_baseline"')


def test_launcher_runs_bare_init_on_cpu(capsys):
    out = launch.main(["bare_init", "--device", "cpu"])
    assert out == {"experiment": "bare_init", "num_devices": 1, "process_id": 0, "backend": "gloo", "device": "cpu"}
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"experiment": "bare_init"')
