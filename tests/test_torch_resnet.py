"""The PyTorch port's ResNet against the JAX package's, under carried
weights: train-mode logits, parameter gradients of the cross-entropy loss,
and the BatchNorm running statistics after one train-mode forward.

Models: the ``small`` preset (ResNet-18, CIFAR stem, width 16) and a
depth-cut ResNet-50 (two bottleneck stages of one block each, ImageNet
stem, width 8), which covers the 7x7/2 stem, the max-pool, the bottleneck
and the ``conv_proj`` shortcut.

Tolerance: fp32, rtol = atol = 1e-5 for logits and statistics; 1e-4 for
gradients, which sum per-example products over the batch and the spatial
axes in a different order (the convolution backward of XLA and of
PyTorch's CPU kernels), so their absolute error grows with the number of
terms.

BatchNorm: flax keeps 0.9 of the old running statistic, torch's
``momentum=0.1`` is the same rule. Flax updates the running variance with
the biased batch variance, torch with the unbiased one; the port keeps
torch's BatchNorm, and the test checks the running variance with the
n / (n - 1) factor.
"""

import jax
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.models.resnet import BottleneckBlock as JaxBottleneck
from network_distributed_pytorch_tpu.models.resnet import ResNet as JaxResNet
from network_distributed_pytorch_tpu.models.resnet import resnet18 as jax_resnet18
from network_distributed_pytorch_tpu.utils.losses import cross_entropy_loss as jax_ce
from network_distributed_pytorch_tpu_torch.models.import_weights import resnet_state_dict_from_flax
from network_distributed_pytorch_tpu_torch.models.resnet import BottleneckBlock, ResNet, resnet18
from network_distributed_pytorch_tpu_torch.utils.losses import cross_entropy_loss
from torch_parity import random_flax_variables, to_numpy
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

ATOL = RTOL = 1e-5
GRAD_TOL = 1e-4

MODELS = {
    "resnet18_small": (
        lambda: jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16),
        lambda: resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device="cpu"),
    ),
    "resnet50_cut": (
        lambda: JaxResNet(stage_sizes=[1, 1], block_cls=JaxBottleneck, width=8, stem="imagenet"),
        lambda: ResNet([1, 1], BottleneckBlock, width=8, stem="imagenet", device="cpu"),
    ),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_forward_gradients_and_bn_stats_match_jax(name):
    make_jax, make_port = MODELS[name]
    jax_model = make_jax()
    variables = random_flax_variables(jax_model, (1, 32, 32, 3), seed=1)
    rng = np.random.RandomState(2)
    x = rng.randn(8, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=8).astype(np.int32)

    @jax.jit
    def jax_loss(params, stats, x, y):
        logits, new = jax_model.apply(
            {"params": params, "batch_stats": stats}, x, train=True, mutable=["batch_stats"]
        )
        return jax_ce(logits, y), (logits, new["batch_stats"])

    (loss, (logits, new_stats)), grads = jax.value_and_grad(jax_loss, has_aux=True)(
        variables["params"], variables["batch_stats"], x, y
    )

    model = make_port()
    model.load_state_dict(resnet_state_dict_from_flax(to_numpy(variables)))
    counts = {}
    for mod_name, mod in model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_hook(
                lambda m, inp, out, k=mod_name: counts.__setitem__(k, inp[0].numel() // inp[0].shape[1])
            )
    model.train()
    port_logits = model(torch.from_numpy(x))
    port_loss = cross_entropy_loss(port_logits, torch.from_numpy(y))
    port_loss.backward()

    np.testing.assert_allclose(port_logits.detach().numpy(), np.asarray(logits), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(port_loss.detach()), float(loss), rtol=RTOL, atol=ATOL)
    want_grads = resnet_state_dict_from_flax({"params": to_numpy(grads)})
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads)
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)

    old = resnet_state_dict_from_flax({"batch_stats": to_numpy(variables["batch_stats"])})
    new = resnet_state_dict_from_flax({"batch_stats": to_numpy(new_stats)})
    buffers = dict(model.named_buffers())
    for k, want in new.items():
        if k.endswith("running_mean"):
            np.testing.assert_allclose(buffers[k].numpy(), want.numpy(), rtol=RTOL, atol=ATOL, err_msg=k)
        elif k.endswith("running_var"):
            n = counts[k[: -len(".running_var")]]
            var0 = old[k].numpy()
            unbiased = 0.9 * var0 + (want.numpy() - 0.9 * var0) * n / (n - 1)
            np.testing.assert_allclose(buffers[k].numpy(), unbiased, rtol=RTOL, atol=ATOL, err_msg=k)


def test_state_dict_conversion_is_complete_and_strict():
    jax_model = MODELS["resnet50_cut"][0]()
    variables = to_numpy(random_flax_variables(jax_model, (1, 32, 32, 3), seed=3))
    model = MODELS["resnet50_cut"][1]()
    sd = resnet_state_dict_from_flax(variables)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    w = variables["params"]["BottleneckBlock_0"]["Conv_1"]["kernel"]  # HWIO
    assert torch.equal(model.blocks[0].conv1.weight, torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    assert torch.equal(model.head.weight, torch.from_numpy(variables["params"]["head"]["kernel"].T.copy()))


def test_init_is_seeded_and_zeroes_last_bn_scale():
    a = resnet18(num_classes=10, stem="cifar", width=16, device="cpu", seed=4)
    b = resnet18(num_classes=10, stem="cifar", width=16, device="cpu", seed=4)
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), k
    for block in a.blocks:
        assert torch.count_nonzero(block.norm1.weight) == 0
        assert torch.count_nonzero(block.norm0.weight) == block.norm0.weight.numel()


def test_model_without_device_cpu_raises_on_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet18(num_classes=10, stem="cifar", width=16)
