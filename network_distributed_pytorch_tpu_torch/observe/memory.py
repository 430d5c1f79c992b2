"""Device bytes of a nest of tensors, the JAX package's
``observe/memory.tree_bytes`` over torch tensors: what a KV cache or a
block pool holds. The memory sampler and the OOM report are not ported
yet (ROADMAP.md §A item 8)."""

from __future__ import annotations

import torch


def tree_bytes(tree) -> int:
    """Bytes held by the tensors in ``tree`` (nested lists, tuples and dict
    values); 0 for None or an empty nest, nothing for other leaves."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0
