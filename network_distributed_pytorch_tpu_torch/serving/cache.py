"""The serving engines' KV caches, the JAX package's ``serving/cache.py``
(``:31-117``) on torch tensors.

The slot cache is ``models.gpt``'s layout, per layer ``{"k": (S, max_len,
H, D), "v": ...}``, with the batch axis read as SLOTS: row ``s`` belongs to
the request in slot ``s``. Admission writes a freshly prefilled batch-1
cache into its row (:func:`write_slot`); freeing a slot needs no work,
since every decode step masks each row past its own position and the next
prefill overwrites the row. The block pool is the paged engine's: per
layer ``(n_blocks, block_len, H, D)``, with block 0 the garbage block.

Both start as zeros, never ``torch.empty``: a masked position adds
``0.0 * value`` to the attention, which is 0 only for a finite value.
Writes are in place (where the JAX engine donates its cache) and return
the cache they wrote; :func:`read_slot` returns views, which a later write
changes, and :func:`read_chain` copies.

:func:`restore_serving_params` hot-loads a training checkpoint's
parameters into a serving model (the reference's ``:119-170``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models.gpt import Cache, GPTConfig, init_gpt_cache
from ..ops.paged import pool_chain_view, scatter_chain


def init_slot_cache(config: GPTConfig, n_slots: int, max_len: int, *, device) -> Cache:
    """Per-layer K/V zeros with a leading slot axis: ``(S, max_len, H, D)``."""
    return init_gpt_cache(config, n_slots, max_len, device=device)


def write_slot(cache: Cache, row_cache: Cache, slot: int) -> Cache:
    """Copy a batch-1 cache (a ``gpt_prefill`` of one request's prompt at
    the cache's ``max_len``) into row ``slot`` of the slot cache, in place."""
    for layer, row in zip(cache, row_cache):
        for name in ("k", "v"):
            layer[name][slot] = row[name][0].to(layer[name].dtype)
    return cache


def init_block_pool(config: GPTConfig, n_blocks: int, block_len: int, *, device) -> Cache:
    """Per-layer paged K/V: zeros of ``(n_blocks, block_len, H, D)``. Block 0
    is the garbage block (``serving.blocks.GARBAGE_BLOCK``): vacant and
    padding table entries point there, so it is written freely and never
    read as valid."""
    shape = (n_blocks, block_len, config.n_heads, config.head_dim)
    return [
        {"k": torch.zeros(shape, dtype=config.dtype, device=device),
         "v": torch.zeros(shape, dtype=config.dtype, device=device)}
        for _ in range(config.n_layers)
    ]


def write_chain(pool: Cache, row_cache: Cache, chain: torch.Tensor) -> Cache:
    """Scatter a batch-1 cache (per layer ``(1, T * L, H, D)``) into the
    block chain ``chain`` (``(T,)`` long, padded with the garbage block past
    the request's reservation), in place."""
    for layer, row in zip(pool, row_cache):
        for name in ("k", "v"):
            scatter_chain(layer[name], chain, row[name][0])
    return pool


def read_chain(pool: Cache, chain, n_tokens: Optional[int] = None) -> Cache:
    """A chain's logical rows as a batch-1 cache (per layer ``(1, len(chain)
    * L, H, D)``, cut to ``n_tokens`` when given), copied out of the pool.
    The shared-prefix admission reads the prefix's K/V with it."""
    chain = torch.as_tensor(chain, dtype=torch.long, device=pool[0]["k"].device)
    out: List = []
    for layer in pool:
        k = pool_chain_view(layer["k"], chain)[None]
        v = pool_chain_view(layer["v"], chain)[None]
        if n_tokens is not None:
            k, v = k[:, :n_tokens], v[:, :n_tokens]
        out.append({"k": k, "v": v})
    return out


def read_slot(cache: Cache, slot: int) -> Cache:
    """Row ``slot`` of the slot cache as a batch-1 cache of views: a later
    write into the slot cache shows through them."""
    return [{"k": layer["k"][slot : slot + 1], "v": layer["v"][slot : slot + 1]} for layer in cache]


def serving_state_template(params: Dict[str, torch.Tensor]):
    """A one-process ``TrainState`` around a serving model's parameters
    (``dict(model.named_parameters())``), the restore target of
    :func:`restore_serving_params`. Only ``params`` is read from a
    checkpoint, so the other fields stay empty: whatever the training
    run's reducer and world, its parameters fit."""
    from ..parallel.trainer import TrainState

    return TrainState(params=params, momenta={}, memories={}, reducer_state={}, model_state={})


def restore_serving_params(
    root: str, params: Dict[str, torch.Tensor], telemetry: Any = None, label: str = "serving"
) -> Optional[Tuple[Dict[str, torch.Tensor], int]]:
    """Boot a serving process from the newest committed TRAINING checkpoint
    under ``root``: its parameters are copied into ``params`` (the serving
    model's own, which give the shapes and the device) and ``(params,
    step)`` returned; None when nothing restorable exists. A torn or
    corrupt step falls back to an older one (``checkpoint_fallback``).

    Any training world: the parameters are the same on every rank, and
    rank 0 wrote them once, so a checkpoint of a W-rank fleet restores
    into one process as it is; the per-rank training state (memories, BN
    rows, momenta, the reducer's Q) is not read."""
    from ..utils.checkpoint import restore_latest

    restored = restore_latest(root, serving_state_template(params), telemetry=telemetry, label=label, fields=("params",))
    if restored is None:
        return None
    state, step = restored
    return state.params, step
