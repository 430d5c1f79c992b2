"""Multi-host batch assembly, the port's form of the JAX package's
``data/multihost.py``.

There, each host process loads only its own shard of the batch (the
reference's per-rank ``DataPartitioner.use(rank)`` and DataLoader,
``ddp_guide_cifar10/ddp_init.py:49-54``), and a global ``jax.Array`` is
assembled from the hosts' shards with no data crossing between hosts
(``jax.make_array_from_process_local_data`` over the ``data``-sharded
mesh). In the port every rank is a process of its own that steps on its
own slice of the batch (DDP over ``torch.distributed``): a rank's shard
*is* its input, so no global array is built, and these functions place a
rank's host values on its device.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def to_rank_device(tree: Any, device) -> Any:
    """A rank's host value (a dict, tuple or list of numpy arrays or
    tensors; other leaves kept as they are) as tensors on ``device``: the
    port's one placement, under the JAX package's two names below."""
    device = torch.device(device)
    if isinstance(tree, dict):
        return {k: to_rank_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_rank_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (np.ndarray, np.generic)):
        a = np.asarray(tree)
        return torch.from_numpy(a if a.flags.c_contiguous else a.copy()).to(device)
    return tree


# This rank's own shard of the global batch (leading axis the rank's rows)
# on its device. It stands in for the JAX package's global data-sharded
# ``jax.Array`` of ``per_rank * world`` rows: the port's step reads each
# rank's rows on that rank, and its reducer's collectives join them, so the
# shard alone is the rank's input.
global_batch_from_local = to_rank_device

# A host value identical on every rank (e.g. a freshly initialised state)
# on this rank's device. It stands in for the JAX package's global
# ``jax.Array``s sharded by a spec over the global mesh: in the port's DDP
# each rank holds its whole replica, so every rank places the whole value.
global_state_from_host = to_rank_device


def merge_tokenized_shards(shards, device: Optional[Any] = None):
    """Per-rank ``WordPieceTokenizer.encode_shard`` outputs (contiguous row
    blocks, in rank order) as one full-corpus dict of arrays: the shards
    are contiguous by construction (``wordpiece.shard_rows``), so their
    concatenation in rank order is the full corpus's row order, as a
    monolithic encode gives it. With ``device``, the merged arrays are
    placed there as tensors (:func:`global_batch_from_local`): the
    single-process path; a rank of a larger world instead feeds its own
    shard to :func:`global_batch_from_local` and never holds the corpus."""
    if not shards:
        raise ValueError("no shards to merge")
    merged = {k: np.concatenate([np.asarray(s[k]) for s in shards], axis=0) for k in shards[0]}
    if device is not None:
        return global_batch_from_local(merged, device)
    return merged
