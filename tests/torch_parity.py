"""Helpers shared by the PyTorch port's parity tests (JAX side)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def random_flax_variables(model, input_shape, seed: int, init_kwargs=None):
    """``{"params", "batch_stats"}`` for ``model`` with every leaf drawn from
    numpy (no flax init, which is slow to trace): LeCun-scaled kernels, BN
    and GroupNorm scales near 1 (never 0, so every gradient is exercised),
    small biases, running means near 0 and running variances near 1.
    ``init_kwargs`` go to ``model.init`` (default ``train=True``, the
    ResNet's; ``{}`` for ``SmallCNN`` and ``MLP``).

    The last BN scale of each residual block is drawn near 0.1: the main
    path starts it at zero, so its residual branches start small. With unit
    scales, eight random blocks make the fp32 gradient ill-conditioned (on
    the small ResNet-18, a 1e-6 relative change of the weights moves the
    gradient by up to 1e-2 in either framework), and no cross-framework
    tolerance tighter than that could hold."""
    init_kwargs = {"train": True} if init_kwargs is None else init_kwargs
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros(input_shape), **init_kwargs)
    )
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            scale = (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
            return scale * 0.1 if _last_block_norm(path) else scale
        if name == "var":
            return (1.0 + 0.1 * np.abs(rng.randn(*shape))).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(draw, shapes)


def random_distilbert_params(model, seq_len: int, seed: int):
    """flax params of a DistilBERT ``model`` drawn with numpy: LeCun-scaled
    kernels, embeddings of std 0.5, LayerNorm scales near 1, small biases."""
    shapes = jax.eval_shape(
        lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, seq_len), jnp.int32), jnp.ones((1, seq_len), jnp.int32)
        )
    )["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return (rng.randn(*leaf.shape) / np.sqrt(leaf.shape[0])).astype(np.float32)
        if name == "embedding":
            return (0.5 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _last_block_norm(path) -> bool:
    keys = [str(getattr(k, "key", k)) for k in path]  # collection, block, layer, leaf
    return len(keys) == 4 and (
        (keys[1].startswith("BasicBlock") and keys[2] == "BatchNorm_1")
        or (keys[1].startswith("BottleneckBlock") and keys[2] == "BatchNorm_2")
    )


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)
