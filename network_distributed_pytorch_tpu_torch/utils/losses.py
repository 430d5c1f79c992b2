"""Loss functions: the reference's ``nn.CrossEntropyLoss()`` (mean over the
batch, integer targets)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy with integer labels, mean over the batch,
    computed in float32."""
    return F.cross_entropy(logits.float(), labels.long())
