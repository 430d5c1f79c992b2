"""The ResNet at ``compute_dtype="bfloat16"`` against the JAX package's, on
the CPU: flax's cast points, the logits, the fp32 gradients and the
BatchNorm running statistics.

flax's cast points for a ResNet in bf16 (``models/resnet.py``, flax 0.12.3
``linen/normalization.py``): the input is cast to bf16; a ``Conv`` casts
its input and kernel to bf16 and returns bf16; ``BatchNorm`` and
``GroupNorm`` widen their input to fp32, take the statistics and normalise
with the fp32 parameters, and return bf16; the residual add, ReLU, the
max-pool and the mean pool run in bf16; the ``head`` Dense rounds its
product, then adds its bias in bf16; the logits leave in fp32.

Each layer of the port is fed the JAX layer's own bf16 input
(``capture_intermediates``) and its output held to the JAX layer's with
``assert_bf16_match`` (``tests/test_torch_bf16.py``): at most 1 bf16 ulp
apart anywhere, bitwise equal in all but 1 % of the elements. The
convolutions of both frameworks on the CPU sum their fp32 products in
another order before the one rounding to bf16, so a sum that lands near a
rounding boundary can round the other way. Where an output cancels (a
sum of terms of order 1 that comes to 1e-6), the two fp32 sums can differ
by more than the result's own bf16 ulp: a convolution's difference is
therefore first reduced by CONV_SLACK, the bound of two fp32 sums of its
``n`` terms (``2 n 2^-24 sum |x w|``), and the rest held to 1 ulp. A
normalisation's output cancels the same way where ``(x - mean) * mul``
meets ``-bias``: its difference is first reduced by how far the output
moves when the fp32 statistics move by STATS_TOL (relative to the rms of
the group normalised), the tolerance its running statistics are held to,
``STATS_TOL * mul * (rms + |x - mean|)``. A wrong
cast point fails the mismatch share: a BatchNorm that normalised in bf16,
or a convolution that rounded its input after the product, differs in far
more of its outputs.

BatchNorm's running statistics, updated from those same bf16 inputs, are
held at fp32's RTOL = ATOL = 1e-5, with torch's unbiased running variance
(``tests/test_torch_resnet.py``). End to end the logits are held to
LOGIT_ULPS bf16 ulps of the largest logit: each layer's 1-ulp differences
run through every later layer.

Gradients come back fp32. The bf16 gradient of these random ResNets is
ill-conditioned in either framework: at batch 8 JAX's own bf16 gradient is
up to 43 % of a leaf's largest entry away from its fp32 gradient (every
BatchNorm's backward subtracts means of bf16-rounded terms), so no
per-leaf bound between the two frameworks' bf16 gradients could hold
tighter than that. The class is taken over the whole gradient as one
vector: the port's bf16 gradient is at most GRAD_RATIO times as far from
the fp32 gradient as JAX's bf16 gradient is (both about 6 to 16 % here),
and the two bf16 gradients are nearer each other than JAX's is to fp32.
A wrong cast point in the backward (a gradient rounded to bf16 twice, or
a BatchNorm differentiated in bf16) moves the port's farther.

The experiments: ``powersgd_cifar10``, ``exact_cifar10`` (DDP and FSDP) and
``diloco_cifar10`` run in bf16 at the small preset from the JAX run's
weights, and their losses are held to the JAX runs' at LOSS_REL, with the
bits of the fp32 run.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from network_distributed_pytorch_tpu.models.resnet import BasicBlock as JaxBasic
from network_distributed_pytorch_tpu.models.resnet import BottleneckBlock as JaxBottleneck
from network_distributed_pytorch_tpu.models.resnet import ResNet as JaxResNet
from network_distributed_pytorch_tpu.models.resnet import resnet18 as jax_resnet18
from network_distributed_pytorch_tpu.parallel.mesh import make_mesh
from network_distributed_pytorch_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
from network_distributed_pytorch_tpu.utils.losses import cross_entropy_loss as jax_ce
from network_distributed_pytorch_tpu_torch.experiments import (
    bandwidth_study,
    diloco_cifar10,
    exact_cifar10,
    powersgd_cifar10,
)
from network_distributed_pytorch_tpu_torch.models.import_weights import resnet_state_dict_from_flax
from network_distributed_pytorch_tpu_torch.models.layers import conv, dense, norm
from network_distributed_pytorch_tpu_torch.models.resnet import BasicBlock, BottleneckBlock, ResNet, resnet18
from network_distributed_pytorch_tpu_torch.utils.losses import cross_entropy_loss
from test_torch_bf16 import MISMATCH, assert_bf16_match, bf16_ulp
from torch_parity import random_flax_variables, to_numpy
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

BF16 = torch.bfloat16
RTOL = ATOL = 1e-5
STATS_TOL = 1e-5  # see above
LOGIT_ULPS = 2  # see above
GRAD_RATIO = 1.25  # see above
LOSS_REL = 0.01  # bf16 losses of two runs: each logit within LOGIT_ULPS, the weights a few steps apart
B = 8

MODELS = {
    "resnet18_small": (
        lambda: jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16, dtype=jnp.bfloat16),
        lambda: resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device="cpu", dtype=BF16),
    ),
    "resnet50_cut": (
        lambda: JaxResNet(stage_sizes=[1, 1], block_cls=JaxBottleneck, width=8, stem="imagenet", dtype=jnp.bfloat16),
        lambda: ResNet([1, 1], BottleneckBlock, width=8, stem="imagenet", device="cpu", dtype=BF16),
    ),
    # flax's GroupNorm needs channels divisible by its 32 groups: width 32,
    # two stages of one basic block (one with the conv_proj shortcut)
    "resnet_group_cut": (
        lambda: JaxResNet(stage_sizes=[1, 1], block_cls=JaxBasic, width=32, norm="group", stem="cifar",
                          dtype=jnp.bfloat16),
        lambda: ResNet([1, 1], BasicBlock, width=32, norm="group", stem="cifar", device="cpu", dtype=BF16),
    ),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _nchw(x):
    """A JAX NHWC activation as the port's bf16 NCHW tensor."""
    return torch.from_numpy(np.array(_np(x))).to(BF16).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _jax_forward(name):
    """The JAX model's variables, batch, train-mode logits, new batch
    statistics, every module's output, and the gradients of the loss."""
    jax_model = MODELS[name][0]()
    variables = random_flax_variables(jax_model, (1, 32, 32, 3), seed=1)
    rng = np.random.RandomState(2)
    x = rng.randn(B, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=B).astype(np.int32)
    stats = variables.get("batch_stats", {})

    def loss(params):
        logits, new = jax_model.apply(
            {"params": params, "batch_stats": stats}, x, train=True, mutable=["batch_stats", "intermediates"],
            capture_intermediates=True,
        )
        return jax_ce(logits, y), (logits, new)

    # op by op, as flax runs it un-jitted: under jit XLA's CPU backend may
    # keep an intermediate in fp32 where the op-by-op model rounds it to bf16
    (_, (logits, new)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    return variables, x, y, logits, new.get("batch_stats", {}), new["intermediates"], grads


def _port_model(name, variables):
    model = MODELS[name][1]()
    model.load_state_dict(resnet_state_dict_from_flax(to_numpy(variables)))
    return model.train()


def _out(tree, *path):
    for k in path:
        tree = tree[k]
    return tree["__call__"][0]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_cast_points_match_flax(name):
    variables, x, _, logits, new_stats, inter, _ = _jax_forward(name)
    model = _port_model(name, variables)
    got, convs, norms = {}, {}, {}

    def run_conv(key, layer, inp):
        convs[key] = (conv(layer, inp, BF16), layer, inp)

    def run_norm(key, layer, inp):
        norms[key] = (norm(layer, inp, BF16), layer, inp)

    stem = model.stem
    with torch.no_grad():
        run_conv("conv_init", model.conv_init, torch.from_numpy(x).to(BF16).permute(0, 3, 1, 2))
        run_norm("norm_init", model.norm_init, _nchw(_out(inter, "conv_init")))
        h = F.relu(_nchw(_out(inter, "norm_init")))
        if stem == "imagenet":
            h = F.max_pool2d(h, 3, 2, padding=1)
        block_names = sorted((k for k in inter if k.endswith(tuple("0123456789"))), key=lambda k: int(k.rsplit("_", 1)[1]))
        for i, (bname, block) in enumerate(zip(block_names, model.blocks)):
            jb = inter[bname]
            n_convs = 3 if isinstance(block, BottleneckBlock) else 2
            norm_name = "GroupNorm" if any(k.startswith("GroupNorm") for k in jb) else "BatchNorm"
            inp = h
            for c in range(n_convs):
                run_conv(f"{bname}/Conv_{c}", getattr(block, f"conv{c}"), inp)
                run_norm(f"{bname}/{norm_name}_{c}", getattr(block, f"norm{c}"), _nchw(_out(jb, f"Conv_{c}")))
                inp = F.relu(_nchw(_out(jb, f"{norm_name}_{c}")))
            residual = h
            if block.conv_proj is not None:
                run_conv(f"{bname}/conv_proj", block.conv_proj, h)
                run_norm(f"{bname}/norm_proj", block.norm_proj, _nchw(_out(jb, "conv_proj")))
                residual = _nchw(_out(jb, "norm_proj"))
            got[bname] = F.relu(residual + _nchw(_out(jb, f"{norm_name}_{n_convs - 1}")))
            h = _nchw(_out(inter, bname))
        head = dense(model.head, h.mean(dim=(2, 3)), BF16)
    for key, (value, layer, inp) in convs.items():
        assert value.dtype == BF16, key
        assert_conv_match(value, _out(inter, *key.split("/")), layer, inp, key)
    for key, (value, layer, inp) in norms.items():
        assert value.dtype == BF16, key
        assert_norm_match(value, _out(inter, *key.split("/")), layer, inp, key)
    for key, value in got.items():
        assert value.dtype == BF16, key
        assert_bf16_match(_nhwc(value), _out(inter, *key.split("/")), key)
    assert_bf16_match(head, _out(inter, "head"), "head")
    assert logits.dtype == jnp.float32
    # the running statistics, from the JAX layers' own inputs
    buffers = dict(model.named_buffers())
    old = resnet_state_dict_from_flax({"batch_stats": to_numpy(variables.get("batch_stats", {}))})
    new = resnet_state_dict_from_flax({"batch_stats": to_numpy(new_stats)})
    assert (len(new) > 0) == (model.norm_init.__class__ is torch.nn.BatchNorm2d)
    for k, want in new.items():
        if k.endswith("running_mean"):
            assert buffers[k].dtype == torch.float32, k
            np.testing.assert_allclose(buffers[k].numpy(), want.numpy(), rtol=RTOL, atol=ATOL, err_msg=k)
        elif k.endswith("running_var"):
            n = B * _conv_input_positions(inter, k)
            var0 = old[k].numpy()
            unbiased = 0.9 * var0 + (want.numpy() - 0.9 * var0) * n / (n - 1)
            np.testing.assert_allclose(buffers[k].numpy(), unbiased, rtol=RTOL, atol=ATOL, err_msg=k)


def assert_conv_match(got, want, layer, inp, what):
    """:func:`assert_bf16_match` for a convolution's output, its difference
    first reduced by the fp32 accumulation bound of its sums (see above)."""
    with torch.no_grad():
        weight = layer.weight.to(BF16).double().abs()
        magnitude = F.conv2d(inp.double().abs(), weight, None, layer.stride, layer.padding)
    slack = 2 * weight[0].numel() * 2.0**-24 * _np(_nhwc(magnitude))
    got, want = _np(_nhwc(got)), _np(want)
    assert got.shape == want.shape, what
    ulps = np.maximum(np.abs(got - want) - slack, 0) / bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert ulps.max() <= 1.0, f"{what}: {ulps.max()} bf16 ulps apart beyond the fp32 sums' bound"
    assert float((got != want).mean()) <= MISMATCH, f"{what}: {(got != want).mean():.4f} of the elements differ"


def assert_norm_match(got, want, layer, inp, what):
    """:func:`assert_bf16_match` for a BatchNorm's or GroupNorm's output,
    its difference first reduced by the statistics' slack (see above)."""
    x = inp.double()
    if isinstance(layer, torch.nn.GroupNorm):
        n, c = x.shape[:2]
        xg = x.reshape(n, layer.num_groups, c // layer.num_groups, *x.shape[2:])
        axes = tuple(range(2, xg.dim()))
        mean = xg.mean(axes, keepdim=True).expand_as(xg).reshape(x.shape)
        var = xg.var(axes, unbiased=False, keepdim=True).expand_as(xg).reshape(x.shape)
    else:
        mean = x.mean((0, 2, 3), keepdim=True)
        var = x.var((0, 2, 3), unbiased=False, keepdim=True)
    mul = layer.weight.detach().double().abs()[None, :, None, None] / torch.sqrt(var + layer.eps)
    slack = STATS_TOL * mul * (torch.sqrt(var + mean**2) + (x - mean).abs())
    got, want, slack = _np(_nhwc(got)), _np(want), _nhwc(slack).numpy()
    assert got.shape == want.shape, what
    ulps = np.maximum(np.abs(got - want) - slack, 0) / bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert ulps.max() <= 1.0, f"{what}: {ulps.max()} bf16 ulps apart beyond the statistics' slack"
    assert float((got != want).mean()) <= MISMATCH, f"{what}: {(got != want).mean():.4f} of the elements differ"


def _conv_input_positions(inter, running_var_name):
    """The spatial positions a BatchNorm normalised over, from the shape of
    the JAX conv output it was fed."""
    parts = running_var_name.split(".")[:-1]  # e.g. blocks.0.norm1 or norm_init
    if parts[0] == "blocks":
        bname = next(k for k in inter if k.endswith(f"_{parts[1]}") and not k.startswith(("conv", "norm")))
        sub = parts[2]
        conv_name = "conv_proj" if sub == "norm_proj" else f"Conv_{sub[len('norm'):]}"
        shape = _out(inter[bname], conv_name).shape
    else:
        shape = _out(inter, "conv_init").shape
    return shape[1] * shape[2]


@functools.lru_cache(maxsize=None)
def _jax_fp32_grads(name):
    """The JAX model's fp32 gradient at the same weights and batch."""
    variables, x, y, *_ = _jax_forward(name)
    jax_model = MODELS[name][0]().clone(dtype=jnp.float32)

    def loss(params):
        logits, _ = jax_model.apply(
            {"params": params, "batch_stats": variables.get("batch_stats", {})}, x, train=True,
            mutable=["batch_stats"],
        )
        return jax_ce(logits, y)

    return resnet_state_dict_from_flax({"params": to_numpy(jax.jit(jax.grad(loss))(variables["params"]))})


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_and_gradients_match_flax(name):
    variables, x, y, logits, _, _, grads = _jax_forward(name)
    model = _port_model(name, variables)
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and np.isfinite(_np(got)).all()
    bound = LOGIT_ULPS * bf16_ulp(np.abs(_np(logits)).max())
    assert np.abs(_np(got) - _np(logits)).max() <= bound
    cross_entropy_loss(got, torch.from_numpy(y)).backward()
    want = resnet_state_dict_from_flax({"params": to_numpy(grads)})
    fp32 = _jax_fp32_grads(name)
    named = dict(model.named_parameters())
    assert set(named) == set(want) == set(fp32)
    for k, p in named.items():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, k
        assert np.isfinite(p.grad.numpy()).all(), k
    port = np.concatenate([named[k].grad.numpy().ravel() for k in sorted(named)])
    jax_bf16 = np.concatenate([want[k].numpy().ravel() for k in sorted(named)])
    exact = np.concatenate([fp32[k].numpy().ravel() for k in sorted(named)])
    jax_error = np.linalg.norm(jax_bf16 - exact)
    assert np.linalg.norm(port - exact) <= GRAD_RATIO * jax_error
    assert np.linalg.norm(port - jax_bf16) <= jax_error
