"""DistilBERT in PyTorch, the counterpart of the JAX package's
``models/distilbert.py`` (Sanh et al. 2019): learned word + position
embeddings -> LayerNorm -> post-LN transformer blocks (GELU FFN) ->
sequence classification over the first token (pre_classifier -> ReLU ->
classifier), fp32 logits.

Parameter names are HuggingFace's (``distilbert.embeddings.word_embeddings
.weight``, ``distilbert.transformer.layer.{i}.attention.q_lin.weight``, ...),
the names the JAX package's ``distilbert_variables_from_torch`` reads, so
weights carry across both ways (``models/import_weights.py``).

Details kept from the JAX model: LayerNorm eps 1e-12, exact (erf) GELU, the
padding mask ``finfo(f32).min`` added to the scores, and dropout only when
``deterministic`` is False, as flax applies it. ``dtype`` (``compute_dtype``)
is flax's: fp32 parameters, each layer casting at the JAX model's points
(``models/layers.py``), logits in fp32. In bf16 the padding value
``finfo(f32).min`` rounds to ``-inf``, in the JAX model too: the einsum path
adds ``-inf`` and flash attention sees an fp32 ``-inf``, padding by its
validity flag. ``attn_impl``:

- ``"einsum"``: scores ``q k^T / sqrt(head_dim)`` (scale after the
  product), softmax in fp32, attention dropout, ``weights v``;
- ``"flash"``: :func:`..ops.flash_attention.flash_attention` (the CUDA
  kernel on the card, its plain version on the CPU), which has no
  attention-weight dropout;
- ``"auto"``: ``"flash"`` on both devices, what the JAX package picks on its
  own chip, except in training with attention dropout, where it stays on
  ``"einsum"`` so that "auto" never changes the math.

With ``seq_axis`` (a process group: the mesh axis the sequence is sharded
over) attention is ``seq_impl``'s exact schedule, ring or Ulysses
(``parallel/sequence.py``), positions are offset by this rank's block, and
attention dropout in training is refused, as in the JAX model.

Weights are drawn on the CPU from an explicit ``torch.Generator``
(HuggingFace's init: normal with std 0.02 for the dense and embedding
weights, zero biases, unit LayerNorm scales) and then moved to ``device``,
so a seed gives the same weights on every device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from ..parallel.mesh import resolve_device
from ..parallel.sequence import ring_attention, ulysses_attention
from ..utils.config import ATTN_IMPLS
from .layers import check_compute_dtype, dense, embed, layer_norm, remat_call, score_scale

_LN_EPS = 1e-12
_INIT_STD = 0.02


@dataclass(frozen=True)
class DistilBertConfig:
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    dim: int = 768
    n_layers: int = 6
    n_heads: int = 12
    hidden_dim: int = 3072
    dropout: float = 0.1
    attention_dropout: float = 0.1
    num_labels: int = 2
    dtype: Any = torch.float32
    # sequence parallelism: the process group the sequence is sharded over
    # (a mesh axis) and the exact schedule that attends across it
    # (``parallel/sequence.py``)
    seq_axis: Any = None
    seq_impl: str = "ring"
    attn_impl: str = "auto"
    # rematerialization: each block under ``models.layers.remat_call``
    # (``torch.utils.checkpoint``, the RNG state preserved for dropout),
    # recomputed in the backward; the gradients are the plain model's
    remat: bool = False

    def __post_init__(self) -> None:
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")
        if self.dim % self.n_heads:
            raise ValueError(f"dim {self.dim} does not split into {self.n_heads} heads")
        check_compute_dtype(self.dtype)
        if self.seq_impl not in ("ring", "ulysses"):
            raise ValueError(f"DistilBertConfig.seq_impl must be 'ring' or 'ulysses', got {self.seq_impl!r}")


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, config: DistilBertConfig):
        super().__init__()
        self.config = config
        dim = config.dim
        self.q_lin = nn.Linear(dim, dim)
        self.k_lin = nn.Linear(dim, dim)
        self.v_lin = nn.Linear(dim, dim)
        self.out_lin = nn.Linear(dim, dim)

    def _attn_impl(self, deterministic: bool) -> str:
        cfg = self.config
        dropping = not deterministic and cfg.attention_dropout > 0.0
        if cfg.seq_axis is not None:
            if dropping:
                raise ValueError(
                    "attention_dropout > 0 cannot be applied on the sequence-parallel attention path"
                    " (the weight matrix is never materialized). Set attention_dropout=0.0."
                )
            return cfg.seq_impl
        if cfg.attn_impl == "auto":
            # flash cannot dropout-mask the attention weights
            return "einsum" if dropping else "flash"
        if cfg.attn_impl == "flash" and dropping:
            raise ValueError(
                "attention_dropout > 0 cannot be applied on the flash attention"
                " path (the weight matrix is never materialized). Set"
                " attention_dropout=0.0 or use attn_impl='einsum'."
            )
        return cfg.attn_impl

    def forward(self, x: torch.Tensor, mask: torch.Tensor, deterministic: bool) -> torch.Tensor:
        cfg = self.config
        b, t, _ = x.shape
        head_dim = cfg.dim // cfg.n_heads

        def split(y):
            return y.reshape(b, t, cfg.n_heads, head_dim)

        dt = cfg.dtype
        q, k, v = (split(dense(lin, x, dt)) for lin in (self.q_lin, self.k_lin, self.v_lin))
        impl = self._attn_impl(deterministic)
        if impl in ("ring", "ulysses"):
            schedule = ring_attention if impl == "ring" else ulysses_attention
            ctx = schedule(q, k, v, cfg.seq_axis, mask=mask)
        elif impl == "flash":
            ctx = flash_attention(q, k, v, mask=mask.float())
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / score_scale(head_dim, dt)
            # additive mask: 0 for real tokens, finfo.min (fp32) or -inf (bf16) for padding
            scores = scores + mask[:, None, None, :]
            weights = torch.softmax(scores.float(), dim=-1).to(dt)
            weights = F.dropout(weights, cfg.attention_dropout, training=not deterministic)
            ctx = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return dense(self.out_lin, ctx.reshape(b, t, cfg.dim), dt)


class TransformerBlock(nn.Module):
    """Post-LN block, DistilBERT layout: LayerNorm after the attention
    residual and after the FFN residual."""

    def __init__(self, config: DistilBertConfig):
        super().__init__()
        self.config = config
        self.attention = MultiHeadSelfAttention(config)
        self.sa_layer_norm = nn.LayerNorm(config.dim, eps=_LN_EPS)
        self.ffn = nn.ModuleDict({
            "lin1": nn.Linear(config.dim, config.hidden_dim),
            "lin2": nn.Linear(config.hidden_dim, config.dim),
        })
        self.output_layer_norm = nn.LayerNorm(config.dim, eps=_LN_EPS)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, deterministic: bool) -> torch.Tensor:
        dt = self.config.dtype
        x = layer_norm(self.sa_layer_norm, x + self.attention(x, mask, deterministic), dt)
        h = F.gelu(dense(self.ffn["lin1"], x, dt), approximate="none")
        h = F.dropout(dense(self.ffn["lin2"], h, dt), self.config.dropout, training=not deterministic)
        return layer_norm(self.output_layer_norm, x + h, dt)


class DistilBertEncoder(nn.Module):
    def __init__(self, config: DistilBertConfig):
        super().__init__()
        self.config = config
        self.embeddings = nn.ModuleDict({
            "word_embeddings": nn.Embedding(config.vocab_size, config.dim),
            "position_embeddings": nn.Embedding(config.max_position_embeddings, config.dim),
            "LayerNorm": nn.LayerNorm(config.dim, eps=_LN_EPS),
        })
        self.transformer = nn.ModuleDict({
            "layer": nn.ModuleList(TransformerBlock(config) for _ in range(config.n_layers))
        })

    def forward(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, deterministic: bool = True
    ) -> torch.Tensor:
        cfg = self.config
        dt = cfg.dtype
        emb = self.embeddings
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        if cfg.seq_axis is not None:  # global positions: offset by this rank's block
            positions = positions + dist.get_rank(cfg.seq_axis) * input_ids.shape[1]
        x = embed(emb["word_embeddings"], input_ids, dt) + embed(emb["position_embeddings"], positions, dt)
        x = layer_norm(emb["LayerNorm"], x, dt)
        x = F.dropout(x, cfg.dropout, training=not deterministic)
        # jnp.asarray(finfo(f32).min, dtype): -inf in bf16
        neg_inf = torch.tensor(torch.finfo(torch.float32).min, device=x.device).to(dt)
        mask = torch.where(attention_mask > 0, torch.zeros((), dtype=dt, device=x.device), neg_inf)
        for block in self.transformer["layer"]:
            x = remat_call(cfg.remat, block, x, mask, deterministic)
        return x


class DistilBertForSequenceClassification(nn.Module):
    """HF-equivalent classifier head: first-token pooling -> pre_classifier
    -> ReLU -> dropout -> classifier; returns fp32 logits (pair with
    ``utils.losses.cross_entropy_loss`` for HF's loss-from-labels)."""

    def __init__(self, config: DistilBertConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.distilbert = DistilBertEncoder(config)
        self.pre_classifier = nn.Linear(config.dim, config.dim)
        self.classifier = nn.Linear(config.dim, config.num_labels)
        self._init_weights(torch.Generator().manual_seed(seed))
        self.to(device)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, _INIT_STD, generator=gen)
                if isinstance(mod, nn.Linear):
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def forward(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, deterministic: bool = True
    ) -> torch.Tensor:
        dt = self.config.dtype
        hidden = self.distilbert(input_ids, attention_mask, deterministic)
        pooled = F.relu(dense(self.pre_classifier, hidden[:, 0], dt))
        pooled = F.dropout(pooled, self.config.dropout, training=not deterministic)
        return dense(self.classifier, pooled, dt).float()


def distilbert_base(
    num_labels: int = 2, device="cuda", seed: int = 0, attn_impl: str = "auto", dtype=torch.float32,
    remat: bool = False,
) -> DistilBertForSequenceClassification:
    """distilbert-base-uncased's shape (66,955,010 parameters at 2 labels)."""
    config = DistilBertConfig(num_labels=num_labels, attn_impl=attn_impl, dtype=dtype, remat=remat)
    return DistilBertForSequenceClassification(config, device, seed)


def distilbert_wide(
    num_labels: int = 2, device="cuda", seed: int = 0, attn_impl: str = "auto", dtype=torch.float32,
    remat: bool = False,
) -> DistilBertForSequenceClassification:
    """The accuracy-study tier: dim 256 at depth 1, wide enough that
    PowerSGD rank 16 is a real compression."""
    config = DistilBertConfig(
        vocab_size=1024, max_position_embeddings=64, dim=256, n_layers=1, n_heads=4,
        hidden_dim=512, num_labels=num_labels, attn_impl=attn_impl, dtype=dtype, remat=remat,
    )
    return DistilBertForSequenceClassification(config, device, seed)


def distilbert_tiny(
    num_labels: int = 2, device="cuda", seed: int = 0, attn_impl: str = "auto", dtype=torch.float32,
    remat: bool = False,
) -> DistilBertForSequenceClassification:
    """The test tier: a DistilBERT-shaped toy transformer."""
    config = DistilBertConfig(
        vocab_size=1024, max_position_embeddings=64, dim=32, n_layers=2, n_heads=4,
        hidden_dim=64, num_labels=num_labels, attn_impl=attn_impl, dtype=dtype, remat=remat,
    )
    return DistilBertForSequenceClassification(config, device, seed)

