"""``compute_dtype="bfloat16"`` against the JAX package, on the CPU: the bf16
tolerance class.

The algorithm tests stay in fp32 (``test_torch_gpt.py``,
``test_torch_distilbert.py``); the point here is the cast points. flax's
are: a ``Dense`` casts its input, kernel and bias to bf16, rounds the
product to bf16 and then adds the bias in bf16; a ``LayerNorm`` reduces in
fp32 and returns bf16; an ``Embed`` casts its table to bf16 before the
gather; the einsum attention scales its bf16 scores and takes the softmax in
fp32; prefill and decode take their scores in fp32; logits leave in fp32.

Each module is fed the JAX module's own bf16 input (``capture_intermediates``)
and its output held to the JAX module's with :func:`assert_bf16_match`: at
most 1 bf16 ulp apart anywhere (sums over a product's terms in another
order can round the other way) and bitwise equal in all but 1 % of the
elements. A wrong cast point fails the second: a Dense that adds its bias
before the one rounding differs in about 28 % of its outputs.

End to end, the logits are held to LOGIT_ULPS bf16 ulps of the largest
logit. Both frameworks round each operation's result to bf16, but XLA's CPU
backend also rounds inside tanh-GELU (op by op), where PyTorch computes it
in fp32 and rounds once: 45 % of GELU outputs differ by 1 ulp, and those
differences run through the rest of the network. Gradients come back fp32;
each leaf's is held to GRAD_REL of its largest JAX entry (bf16's 8 bits
rounded at every operation of the forward and the backward; JAX's own fp32
and bf16 gradients differ by up to 2 % here), except the key-projection
biases, whose gradient is 0 in exact arithmetic (a softmax does not move
when all of a query's scores do), so both sides give rounding noise: they
are held to GRAD_REL of the largest entry of the whole gradient.

The ResNet entries (``powersgd_cifar10``, ``exact_cifar10`` under DDP and
FSDP, ``diloco_cifar10``) run in bf16 from the JAX runs' initial weights
and are held to the JAX runs' losses at RESNET_LOSS_REL, with the fp32
run's bits; ``bandwidth_study`` refuses bf16, as the JAX study builds fp32.
The ResNet's own cast points are ``tests/test_torch_resnet_bf16.py``.

Flash attention's plain version on bf16 q, k, v against the JAX kernel in
interpret mode: both widen each tile to fp32 and round ``out`` (and each
gradient) once, so they are held to :func:`assert_bf16_match`, ``lse`` to
fp32's 1e-5.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from network_distributed_pytorch_tpu_torch.experiments import (
    bandwidth_study,
    diloco_cifar10,
    exact_cifar10,
    gpt_lm,
    imdb_baseline,
    powersgd_cifar10,
    powersgd_imdb,
)
from network_distributed_pytorch_tpu_torch.models import distilbert, gpt
from network_distributed_pytorch_tpu_torch.models.import_weights import (
    distilbert_state_dict_from_flax,
    gpt_state_dict_from_flax,
)
from network_distributed_pytorch_tpu_torch.models.layers import attend, dense, embed, layer_norm
from network_distributed_pytorch_tpu_torch.ops import flash_attention as fa
from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig
from torch_parity import random_distilbert_params, random_gpt_params, to_numpy
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

jax_gpt = importlib.import_module("network_distributed_pytorch_tpu.models.gpt")
jax_distilbert = importlib.import_module("network_distributed_pytorch_tpu.models.distilbert")
jax_fa = importlib.import_module("network_distributed_pytorch_tpu.ops.flash_attention")

BF16 = torch.bfloat16
LOGIT_ULPS = 2  # see above
GRAD_REL = 0.05
MISMATCH = 0.01
T = 32


def _np(x):
    """A torch or JAX array as fp32 numpy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16_ulp(x):
    """The spacing of bf16 at ``|x|`` (8 significant bits)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, np.maximum(e, -125) - 8)


def assert_bf16_match(got, want, what, max_mismatch=MISMATCH):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    ulps = np.abs(got - want) / bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    mismatch = float((got != want).mean())
    assert ulps.max() <= 1.0, f"{what}: {ulps.max()} bf16 ulps apart"
    assert mismatch <= max_mismatch, f"{what}: {mismatch:.4f} of the elements differ"


def assert_logits_close(got, want, what):
    got, want = _np(got), _np(want)
    bound = LOGIT_ULPS * bf16_ulp(np.abs(want).max())
    assert np.abs(got - want).max() <= bound, f"{what}: {np.abs(got - want).max()} > {bound}"


def _to_torch(x):
    return torch.from_numpy(np.array(_np(x))).to(BF16)


@functools.lru_cache(maxsize=None)
def _gpt_params():
    return random_gpt_params(jax_gpt.gpt_tiny(), T, seed=1)


@functools.lru_cache(maxsize=None)
def _distilbert_params():
    return random_distilbert_params(jax_distilbert.distilbert_tiny(), T, seed=1)


def _gpt_ids(seed=2, b=2):
    return np.random.RandomState(seed).randint(0, 128, (b, T)).astype(np.int32)


def _distilbert_batch(seed=2):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 1024, (4, T)).astype(np.int32)
    mask = np.ones((4, T), np.int32)
    mask[1, 20:] = 0
    mask[2, 5:] = 0
    return ids, mask


def _port_gpt(attn_impl="einsum", dtype=BF16):
    model = gpt.gpt_tiny(device="cpu", dtype=dtype, attn_impl=attn_impl)
    model.load_state_dict(gpt_state_dict_from_flax({"params": to_numpy(_gpt_params())}))
    return model


def _port_distilbert(attn_impl="einsum", dtype=BF16):
    model = distilbert.distilbert_tiny(device="cpu", attn_impl=attn_impl, dtype=dtype)
    model.load_state_dict(distilbert_state_dict_from_flax({"params": to_numpy(_distilbert_params())}))
    return model


def _jax_gpt(attn_impl):
    return jax_gpt.GPTLM(dataclasses.replace(jax_gpt.gpt_tiny(dtype=jnp.bfloat16).config, attn_impl=attn_impl))


def _jax_distilbert(attn_impl):
    cfg = dataclasses.replace(jax_distilbert.distilbert_tiny(dtype=jnp.bfloat16).config, attn_impl=attn_impl)
    return jax_distilbert.DistilBertForSequenceClassification(cfg)


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_gpt_cast_points_match_jax(attn_impl):
    ids = _gpt_ids()
    logits, inter = _jax_gpt(attn_impl).apply(
        {"params": _gpt_params()}, jnp.asarray(ids), capture_intermediates=True
    )
    out = inter["intermediates"]
    got = {}
    model = _port_gpt(attn_impl)
    tids = torch.from_numpy(ids).long()
    with torch.no_grad():
        got["wte"] = embed(model.wte, tids, BF16)
        got["wpe"] = embed(model.wpe, torch.arange(T)[None], BF16)
        x = _to_torch(out["wte"]["__call__"][0]) + _to_torch(out["wpe"]["__call__"][0])
        for i, block in enumerate(model.h):
            jb = out[f"h_{i}"]
            got[f"h_{i}/ln_1"] = layer_norm(block.ln_1, x, BF16)
            ln1 = _to_torch(jb["ln_1"]["__call__"][0])
            got[f"h_{i}/attn/q_proj"] = dense(block.attn.q_proj, ln1, BF16)
            got[f"h_{i}/attn"] = block.attn(ln1, True)
            x = x + _to_torch(jb["attn"]["__call__"][0])
            got[f"h_{i}/ln_2"] = layer_norm(block.ln_2, x, BF16)
            got[f"h_{i}/mlp_fc"] = dense(block.mlp_fc, _to_torch(jb["ln_2"]["__call__"][0]), BF16)
            fc = jnp.asarray(_np(jb["mlp_fc"]["__call__"][0])).astype(jnp.bfloat16)
            got[f"h_{i}/mlp_proj"] = dense(block.mlp_proj, _to_torch(jax.nn.gelu(fc, approximate=True)), BF16)
            x = _to_torch(jb["__call__"][0])
        got["ln_f"] = layer_norm(model.ln_f, x, BF16)
        head = attend(model.wte, _to_torch(out["ln_f"]["__call__"][0]), BF16).float()
    for name, value in got.items():
        want = functools.reduce(lambda d, k: d[k], name.split("/"), out)["__call__"][0]
        assert value.dtype == BF16, name
        assert_bf16_match(value, want, name)
    assert head.dtype == torch.float32 and logits.dtype == jnp.float32
    assert_bf16_match(head, logits, "logits")


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_distilbert_cast_points_match_jax(attn_impl):
    ids, amask = _distilbert_batch()
    logits, inter = _jax_distilbert(attn_impl).apply(
        {"params": _distilbert_params()}, jnp.asarray(ids), jnp.asarray(amask), capture_intermediates=True
    )
    out = inter["intermediates"]["distilbert"]
    model = _port_distilbert(attn_impl)
    enc = model.distilbert
    emb = enc.embeddings
    tids = torch.from_numpy(ids).long()
    got = {}
    with torch.no_grad():
        got["word_embeddings"] = embed(emb["word_embeddings"], tids, BF16)
        x = _to_torch(out["word_embeddings"]["__call__"][0]) + _to_torch(out["position_embeddings"]["__call__"][0])
        got["embed_layer_norm"] = layer_norm(emb["LayerNorm"], x, BF16)
        # the padding value: finfo(f32).min rounds to -inf in bf16, in both packages
        mask = torch.where(torch.from_numpy(amask) > 0, 0.0, torch.finfo(torch.float32).min).to(BF16)
        assert torch.isneginf(mask).sum() == int((amask == 0).sum())
        assert bool(jnp.isneginf(jnp.asarray(jnp.finfo(jnp.float32).min, jnp.bfloat16)))
        x = _to_torch(out["embed_layer_norm"]["__call__"][0])
        for i, block in enumerate(enc.transformer["layer"]):
            jb = out[f"layer_{i}"]
            got[f"layer_{i}/attention"] = block.attention(x, mask, True)
            attn = _to_torch(jb["attention"]["__call__"][0])
            got[f"layer_{i}/sa_layer_norm"] = layer_norm(block.sa_layer_norm, x + attn, BF16)
            sa = _to_torch(jb["sa_layer_norm"]["__call__"][0])
            got[f"layer_{i}/ffn_lin1"] = dense(block.ffn["lin1"], sa, BF16)
            lin1 = jnp.asarray(_np(jb["ffn_lin1"]["__call__"][0])).astype(jnp.bfloat16)
            got[f"layer_{i}/ffn_lin2"] = dense(block.ffn["lin2"], _to_torch(jax.nn.gelu(lin1, approximate=False)), BF16)
            lin2 = _to_torch(jb["ffn_lin2"]["__call__"][0])
            got[f"layer_{i}/output_layer_norm"] = layer_norm(block.output_layer_norm, sa + lin2, BF16)
            x = _to_torch(jb["output_layer_norm"]["__call__"][0])
        head = inter["intermediates"]
        pre = dense(model.pre_classifier, x[:, 0], BF16)
        cls = dense(model.classifier, F.relu(_to_torch(head["pre_classifier"]["__call__"][0])), BF16).float()
    for name, value in got.items():
        want = functools.reduce(lambda d, k: d[k], name.split("/"), out)["__call__"][0]
        assert value.dtype == BF16, name
        assert_bf16_match(value, want, name)
    assert_bf16_match(pre, head["pre_classifier"]["__call__"][0], "pre_classifier")
    assert cls.dtype == torch.float32
    assert_bf16_match(cls, logits, "logits")


@pytest.mark.parametrize("model_name", ["gpt", "distilbert"])
@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_bf16_logits_match_jax(model_name, attn_impl):
    """End to end, both attention engines: fp32 logits within LOGIT_ULPS
    bf16 ulps of the largest logit."""
    if model_name == "gpt":
        ids = _gpt_ids(3)
        want = _jax_gpt(attn_impl).apply({"params": _gpt_params()}, jnp.asarray(ids))
        with torch.no_grad():
            got = _port_gpt(attn_impl)(torch.from_numpy(ids))
    else:
        ids, amask = _distilbert_batch(3)
        want = _jax_distilbert(attn_impl).apply({"params": _distilbert_params()}, jnp.asarray(ids), jnp.asarray(amask))
        with torch.no_grad():
            got = _port_distilbert(attn_impl)(torch.from_numpy(ids), torch.from_numpy(amask))
    assert got.dtype == torch.float32 and np.isfinite(_np(got)).all()
    assert_logits_close(got, want, f"{model_name} {attn_impl}")


def _gpt_grads_jax(ids):
    model = _jax_gpt("flash")

    def loss(p):
        return jax_gpt.next_token_loss(model.apply({"params": p}, jnp.asarray(ids[:, :-1])), jnp.asarray(ids[:, 1:]))

    return gpt_state_dict_from_flax({"params": to_numpy(jax.grad(loss)(_gpt_params()))})


def _distilbert_grads_jax(ids, amask, labels):
    model = _jax_distilbert("flash")

    def loss(p):
        logits = model.apply({"params": p}, jnp.asarray(ids), jnp.asarray(amask))
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), jnp.asarray(labels)[:, None], axis=-1))

    return distilbert_state_dict_from_flax({"params": to_numpy(jax.grad(loss)(_distilbert_params()))})


@pytest.mark.parametrize("model_name", ["gpt", "distilbert"])
def test_bf16_gradients_come_back_fp32(model_name):
    if model_name == "gpt":
        ids = np.random.RandomState(4).randint(0, 128, (2, T + 1)).astype(np.int32)
        want = _gpt_grads_jax(ids)
        model = _port_gpt("flash")
        tids = torch.from_numpy(ids).long()
        gpt.next_token_loss(model(tids[:, :-1]), tids[:, 1:]).backward()
    else:
        ids, amask = _distilbert_batch(4)
        labels = np.array([0, 1, 1, 0], np.int32)
        want = _distilbert_grads_jax(ids, amask, labels)
        model = _port_distilbert("flash")
        logits = model(torch.from_numpy(ids), torch.from_numpy(amask))
        F.cross_entropy(logits, torch.from_numpy(labels).long()).backward()
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        g, w = p.grad.numpy(), want[name].numpy()
        assert np.isfinite(g).all(), name
        zero_in_exact_arithmetic = name.endswith(("k_proj.bias", "k_lin.bias"))
        bound = GRAD_REL * (scale if zero_in_exact_arithmetic else np.abs(w).max())
        assert np.abs(g - w).max() <= bound, f"{name}: {np.abs(g - w).max()} > {bound}"


@pytest.mark.parametrize("case", ["masked", "causal"])
def test_flash_plain_version_on_bf16_matches_jax_kernel(case):
    """K5's plain version on bf16 q, k, v against the JAX Pallas kernel in
    interpret mode: out and the gradients in bf16, lse in fp32."""
    b, t, h, d = 2, 32, 2, 16
    rng = np.random.RandomState(5)
    q, k, v, do = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(4))
    mask = np.zeros((b, t), np.float32)
    if case == "masked":
        mask[1, 20:] = np.finfo(np.float32).min
    causal = case == "causal"
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, do))
    jmask = jnp.asarray(mask)

    def jax_attn(q, k, v):
        return jax_fa.flash_attention(q, k, v, jmask, causal=causal, block_q=16, block_k=16, interpret=True)

    want, vjp = jax.vjp(jax_attn, jq, jk, jv)
    want_grads = vjp(jdo)
    tq, tk, tv = (torch.from_numpy(x).to(BF16).requires_grad_() for x in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, torch.from_numpy(mask), causal=causal, block_q=16, block_k=16)
    got.backward(torch.from_numpy(do).to(BF16))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert_bf16_match(got, want, "out")
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want_grads):
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16, name
        assert_bf16_match(g, w, f"d{name}", max_mismatch=0.02)
    fold = lambda x: torch.from_numpy(x).to(BF16).permute(0, 2, 1, 3).reshape(b * h, t, d)  # noqa: E731
    _, lse = fa.flash_attention_reference(fold(q), fold(k), fold(v), torch.from_numpy(mask), causal, 16, 16, d**-0.5)
    assert lse.dtype == torch.float32


def test_gpt_prefill_and_decode_in_bf16_match_jax():
    """Prefill and decode take their scores in fp32; the cache holds bf16."""
    ids = _gpt_ids(6)
    jcfg = jax_gpt.gpt_tiny(dtype=jnp.bfloat16).config
    jparams = jax.tree_util.tree_map(jnp.asarray, _gpt_params())
    want, jcache = jax_gpt.gpt_prefill(jcfg, jparams, jnp.asarray(ids[:, :8]), T)
    want_step, _ = jax_gpt.gpt_decode_step(jcfg, jparams, jcache, jnp.asarray(ids[:, 8]), 8)
    model = _port_gpt()
    got, cache = gpt.gpt_prefill(model, torch.from_numpy(ids[:, :8]).long(), T)
    step, cache = gpt.gpt_decode_step(model, cache, torch.from_numpy(ids[:, 8]).long(), 8)
    assert cache[0]["k"].dtype == BF16 and got.dtype == torch.float32
    assert_logits_close(got, want, "prefill")
    assert_logits_close(step, want_step, "decode step")


def test_generate_casts_the_weights_once_with_the_same_tokens():
    """``generate`` casts the dense and embedding weights to bf16 once for
    its decode loop; the tokens are bitwise those of prefill and decode
    steps that cast at every call, and the model keeps its fp32 weights."""
    model = _port_gpt()
    prompt = torch.from_numpy(_gpt_ids(7)[:, :8]).long()
    got = gpt.generate(model, prompt, 12)
    logits, cache = gpt.gpt_prefill(model, prompt, 20)
    want = [logits.argmax(-1)]
    for i in range(11):
        logits, cache = gpt.gpt_decode_step(model, cache, want[-1], 8 + i)
        want.append(logits.argmax(-1))
    assert torch.equal(got, torch.stack(want, 1))
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("experiment", ["gpt_lm", "powersgd_imdb", "imdb_baseline"])
def test_experiments_run_in_bf16(experiment):
    """compute_dtype="bfloat16" on the CPU: finite losses, and the bits
    of the fp32 run (the gradients stay fp32)."""
    mod = {"gpt_lm": gpt_lm, "powersgd_imdb": powersgd_imdb, "imdb_baseline": imdb_baseline}[experiment]
    outs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = mod.default_config()
        cfg.training_epochs, cfg.compute_dtype = 1, dtype
        outs[dtype] = mod.run(cfg, preset="small", device="cpu", max_steps_per_epoch=2)
    out = outs["bfloat16"]
    assert out["steps"] == 2 and np.isfinite(out["losses"]).all() and out["compute_dtype"] == "bfloat16"
    assert out["bits_per_step"] == outs["float32"]["bits_per_step"]
    assert out["losses"] != outs["float32"]["losses"]


# ---- the ResNet experiments in bf16 against the JAX runs ----------------------

RESNET_RUNS = ("powersgd_cifar10", "exact_cifar10", "exact_cifar10_fsdp", "diloco_cifar10")
RESNET_CFG = {"training_epochs": 1, "global_batch_size": 16, "learning_rate": 0.01, "seed": 3}
# each run's losses against the JAX run's: an fp32 mean of per-example
# losses of bf16 logits that agree to a few bf16 ulps of the largest
# (test_torch_resnet_bf16.py), through weights updated from bf16 gradients
# that agree as a whole (ibid.): held to half of bf16's relative spacing,
# 2 ** -9; they read up to 2.5e-4 on the CPU
RESNET_LOSS_REL = 2e-3


def _resnet_run_kwargs(name):
    kw = {"preset": "small", "max_steps_per_epoch": 4 if name == "diloco_cifar10" else 2}
    if name == "exact_cifar10_fsdp":
        kw["strategy"] = "fsdp"
    if name == "diloco_cifar10":
        kw["sync_every"] = 2
    return kw


@functools.lru_cache(maxsize=None)
def _jax_resnet_run(name):
    """The JAX entry's bf16 run on one CPU device: its initial variables
    (the seed's flax init, as the run draws them), its losses, bits and
    initial PowerSGD Q."""
    from network_distributed_pytorch_tpu.parallel.mesh import make_mesh
    from network_distributed_pytorch_tpu.utils.config import ExperimentConfig as JaxExperimentConfig

    module = importlib.import_module(f"network_distributed_pytorch_tpu.experiments.{name.replace('_fsdp', '')}")
    cfg = JaxExperimentConfig(**RESNET_CFG, compute_dtype="bfloat16")
    model = module.build_model("small", dtype=jnp.bfloat16)
    variables = jax.device_get(
        model.init(jax.random.PRNGKey(cfg.seed), jnp.zeros((1, 32, 32, 3)), train=True)
    )
    kept = {}
    if name != "diloco_cifar10":
        train_loop = module.train_loop

        def keep(step, state, *args, **kwargs):
            if name == "powersgd_cifar10":
                kept["q0"] = np.asarray(state.reducer_state.q_memory)
            state, logger = train_loop(step, state, *args, **kwargs)
            kept["bits"] = step.bits_per_step
            return state, logger

        module.train_loop = keep
    try:
        out = module.run(cfg, mesh=make_mesh(devices=jax.devices()[:1]), **_resnet_run_kwargs(name))
    finally:
        if name != "diloco_cifar10":
            module.train_loop = train_loop
    return to_numpy(variables), out, kept


@pytest.mark.parametrize("name", RESNET_RUNS)
def test_resnet_experiments_run_in_bf16(name, monkeypatch):
    """The ResNet entries at compute_dtype="bfloat16" from the JAX run's
    initial weights (and Q): finite losses held to the JAX run's at
    RESNET_LOSS_REL, the bits of the fp32 run and of the JAX run, and
    fp32 parameters throughout."""
    from network_distributed_pytorch_tpu_torch.models.import_weights import (
        powersgd_state_from_jax,
        resnet_state_dict_from_flax,
    )

    variables, jax_out, jax_kept = _jax_resnet_run(name)
    module = {"powersgd_cifar10": powersgd_cifar10, "diloco_cifar10": diloco_cifar10}.get(name, exact_cifar10)
    pretrained = resnet_state_dict_from_flax(variables)
    models = []
    build_model = module.build_model

    def from_jax(*args, **kwargs):
        model = build_model(*args, **kwargs)
        model.load_state_dict(pretrained)
        models.append(model)
        return model

    monkeypatch.setattr(module, "build_model", from_jax)
    if name == "powersgd_cifar10":
        build = module.build

        def keep_q(*args, **kwargs):
            model, step, state = build(*args, **kwargs)
            state.reducer_state = powersgd_state_from_jax(jax_kept["q0"], variables["params"], step.reducer, model)
            return model, step, state

        monkeypatch.setattr(module, "build", keep_q)
    outs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = ExperimentConfig(**RESNET_CFG, compute_dtype=dtype)
        outs[dtype] = module.run(cfg, device="cpu", **_resnet_run_kwargs(name))
    out = outs["bfloat16"]
    assert all(m.dtype == (torch.bfloat16 if i else torch.float32) for i, m in enumerate(models[-2:]))
    assert all(p.dtype == torch.float32 for p in models[-1].parameters())
    assert np.isfinite(out["losses"]).all() and out["losses"] != outs["float32"]["losses"]
    assert out["bits_per_step"] == outs["float32"]["bits_per_step"]
    if "bits" in jax_kept:
        assert out["bits_per_step"] == jax_kept["bits"]
    else:
        assert out["bits_per_round"] == jax_out["bits_per_round"]
    assert out["steps"] == jax_out["steps"] == 2
    np.testing.assert_allclose(out["losses"], [jax_out["first_loss"], jax_out["final_loss"]], rtol=RESNET_LOSS_REL)


def test_bandwidth_study_refuses_bf16_and_the_config_fp16():
    """``bandwidth_study`` builds fp32 whatever the config says, as the
    JAX study does; a dtype outside the two is refused by the config."""
    cfg = bandwidth_study.default_config()
    cfg.compute_dtype = "bfloat16"
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        bandwidth_study.run(cfg, device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        ExperimentConfig(compute_dtype="float16")
