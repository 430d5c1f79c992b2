"""The port's importers of published checkpoints against the JAX
package's (``models/import_weights.py`` in both): a torchvision ResNet, a
HuggingFace DistilBERT classifier and a HuggingFace GPT-2 LM, each state
dict through the JAX importer into the JAX model and through the port's
into the port model, the two models' logits held at fp32's TOL = 1e-5.

The HuggingFace models are drawn at random from small configs, as
``tests/test_model_parity.py`` draws them (``transformers`` builds them
here; no port module imports it). torchvision is not installed: its
ResNet state dict is built by hand under its names (``conv1``, ``bn1``,
``layer{s}.{b}.conv{c}``, ``downsample.{0,1}``, ``fc``), from numpy.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.models.distilbert import DistilBertConfig as JaxDistilBertConfig
from network_distributed_pytorch_tpu.models.distilbert import (
    DistilBertForSequenceClassification as JaxDistilBert,
)
from network_distributed_pytorch_tpu.models.gpt import GPTLM as JaxGPTLM
from network_distributed_pytorch_tpu.models.gpt import GPTConfig as JaxGPTConfig
from network_distributed_pytorch_tpu.models.import_weights import (
    distilbert_variables_from_torch,
    gpt2_variables_from_torch,
    resnet_variables_from_torch,
)
from network_distributed_pytorch_tpu.models.resnet import BasicBlock as JaxBasic
from network_distributed_pytorch_tpu.models.resnet import BottleneckBlock as JaxBottleneck
from network_distributed_pytorch_tpu.models.resnet import ResNet as JaxResNet
from network_distributed_pytorch_tpu_torch.models import distilbert, gpt
from network_distributed_pytorch_tpu_torch.models.import_weights import (
    distilbert_state_dict_from_hf,
    gpt2_state_dict_from_hf,
    resnet_state_dict_from_torchvision,
)
from network_distributed_pytorch_tpu_torch.models.resnet import BasicBlock, BottleneckBlock, ResNet
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

transformers = pytest.importorskip("transformers")

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RESNETS = {
    # stage sizes, bottleneck, width, stem: a basic and a bottleneck ResNet, both with downsample shortcuts
    "basic": ([2, 1], False, 16, "cifar"),
    "bottleneck": ([1, 2], True, 8, "imagenet"),
}


def _torchvision_state_dict(stage_sizes, bottleneck, width, stem, seed):
    """A torchvision-named ResNet state dict of numpy arrays: conv weights
    OIHW at LeCun scale, BatchNorm entries near (1, 0, 0, 1), a fc head."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[name] = (rng.randn(cout, cin, k, k) / np.sqrt(cin * k * k)).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[f"{name}.running_mean"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[f"{name}.running_var"] = (1 + 0.1 * np.abs(rng.randn(c))).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.array(7, np.int64)

    conv("conv1.weight", width, 3, 7 if stem == "imagenet" else 3)
    bn("bn1", width)
    cin, expansion = width, 4 if bottleneck else 1
    for s, n in enumerate(stage_sizes):
        filters = width * 2**s
        for b in range(n):
            p = f"layer{s + 1}.{b}"
            stride = 2 if s > 0 and b == 0 else 1
            shapes = (
                [(filters, cin, 1), (filters, filters, 3), (filters * 4, filters, 1)]
                if bottleneck else [(filters, cin, 3), (filters, filters, 3)]
            )
            for c, (o, i, k) in enumerate(shapes):
                conv(f"{p}.conv{c + 1}.weight", o, i, k)
                bn(f"{p}.bn{c + 1}", o)
            cout = filters * expansion
            if stride != 1 or cin != cout:
                conv(f"{p}.downsample.0.weight", cout, cin, 1)
                bn(f"{p}.downsample.1", cout)
            cin = cout
    sd["fc.weight"] = (rng.randn(10, cin) / np.sqrt(cin)).astype(np.float32)
    sd["fc.bias"] = (0.1 * rng.randn(10)).astype(np.float32)
    return sd


@pytest.mark.parametrize("kind", sorted(RESNETS))
def test_resnet_from_torchvision_matches_the_jax_importer(kind):
    stage_sizes, bottleneck, width, stem = RESNETS[kind]
    sd = _torchvision_state_dict(stage_sizes, bottleneck, width, stem, seed=4)
    block, jax_block = (BottleneckBlock, JaxBottleneck) if bottleneck else (BasicBlock, JaxBasic)
    jax_model = JaxResNet(stage_sizes=stage_sizes, block_cls=jax_block, width=width, stem=stem)
    variables = resnet_variables_from_torch(sd, stage_sizes, bottleneck)
    model = ResNet(stage_sizes, block, width=width, stem=stem, device="cpu")
    converted = resnet_state_dict_from_torchvision({k: torch.from_numpy(v) for k, v in sd.items()}, stage_sizes, bottleneck)
    model.load_state_dict(converted)  # strict: every name and shape
    assert int(model.norm_init.num_batches_tracked) == 7
    x = np.random.RandomState(5).randn(4, 32, 32, 3).astype(np.float32)
    want = jax_model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # the same from numpy arrays; a block of the wrong kind is refused
    assert all(torch.equal(converted[k], v) for k, v in resnet_state_dict_from_torchvision(sd, stage_sizes, bottleneck).items())
    with pytest.raises(ValueError, match="bottleneck|basic"):
        resnet_state_dict_from_torchvision(sd, stage_sizes, not bottleneck)


def _hf_distilbert():
    cfg = transformers.DistilBertConfig(
        vocab_size=200, max_position_embeddings=32, dim=48, n_layers=2, n_heads=4, hidden_dim=96,
        num_labels=2, dropout=0.0, attention_dropout=0.0,
    )
    torch.manual_seed(0)
    return transformers.DistilBertForSequenceClassification(cfg).eval()


def test_distilbert_from_hf_matches_the_jax_importer():
    sd = _hf_distilbert().state_dict()
    kw = dict(vocab_size=200, max_position_embeddings=32, dim=48, n_layers=2, n_heads=4, hidden_dim=96, num_labels=2)
    jax_model = JaxDistilBert(JaxDistilBertConfig(**kw, attn_impl="einsum"))
    variables = distilbert_variables_from_torch(sd, n_layers=2)
    model = distilbert.DistilBertForSequenceClassification(
        distilbert.DistilBertConfig(**kw, attn_impl="einsum"), device="cpu"
    )
    model.load_state_dict(distilbert_state_dict_from_hf(sd, n_layers=2))  # strict
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 200, (3, 16)).astype(np.int32)
    mask = np.ones((3, 16), np.int32)
    mask[1, 10:] = 0
    want = jax_model.apply(variables, jnp.asarray(ids), jnp.asarray(mask), deterministic=True)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="n_layers"):
        distilbert_state_dict_from_hf(sd, n_layers=1)


def _hf_gpt2():
    cfg = transformers.GPT2Config(
        vocab_size=160, n_positions=64, n_embd=32, n_layer=2, n_head=4, n_inner=64,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, activation_function="gelu_new",
    )
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(cfg).eval()


def test_gpt2_from_hf_matches_the_jax_importer():
    """Both layouts: the unrolled model and ``scan_layers``' stacked one,
    which gives the unrolled logits bit for bit."""
    sd = _hf_gpt2().state_dict()
    kw = dict(vocab_size=160, max_position_embeddings=64, dim=32, n_layers=2, n_heads=4, hidden_dim=64, dropout=0.0)
    jax_model = JaxGPTLM(JaxGPTConfig(**kw, attn_impl="einsum"))
    variables = gpt2_variables_from_torch(sd, n_layers=2)
    ids = np.random.RandomState(1).randint(0, 160, (3, 20)).astype(np.int32)
    want = jax_model.apply(variables, jnp.asarray(ids))
    got = {}
    for scan in (False, True):
        model = gpt.GPTLM(gpt.GPTConfig(**kw, attn_impl="einsum", scan_layers=scan), device="cpu")
        model.load_state_dict(gpt2_state_dict_from_hf(sd, scan_layers=scan))  # strict
        with torch.no_grad():
            got[scan] = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got[False].numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert torch.equal(got[True], got[False])
    with pytest.raises(ValueError, match="n_layers"):
        gpt2_state_dict_from_hf(sd, n_layers=1)


def test_no_port_module_imports_transformers_or_torchvision():
    """The card's machine has neither: the importers take state dicts."""
    found = []
    for dirpath, _, files in os.walk(os.path.join(REPO, "network_distributed_pytorch_tpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                tree = ast.parse(fh.read(), filename=path)
            for node in ast.walk(tree):
                names = (
                    [a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module] if isinstance(node, ast.ImportFrom) and node.module and node.level == 0
                    else []
                )
                found += [(path, n) for n in names if n.split(".")[0] in ("transformers", "torchvision")]
    assert not found, found
