"""GPT-2 decoder LM in PyTorch, the counterpart of the JAX package's
``models/gpt.py`` (Radford et al. 2019): learned token and position
embeddings -> pre-LN blocks (causal self-attention, tanh-GELU MLP) -> final
LayerNorm -> an LM head tied to the token table, fp32 logits. Then the
KV-cache decoding of the same model: :func:`init_gpt_cache`,
:func:`gpt_prefill`, :func:`gpt_decode_step`, :func:`decode_tokens` and
:func:`generate`; and the serving engine's steps (``serving/engine.py``):
:func:`gpt_decode_step_slots` (a position per row),
:func:`gpt_decode_step_paged` (the KV cache in a block pool) and
:func:`gpt_prefill_shared` (a prompt's suffix over its shared prefix).

Parameter names follow the JAX model's modules (``wte.weight``,
``h.{i}.attn.q_proj.weight``, ``h.{i}.mlp_fc.bias``, ``ln_f.weight``), so
``models.import_weights.gpt_state_dict_from_flax`` carries its weights
across. ``wte`` is one ``nn.Embedding`` whose weight is also the head, so
its gradient is the sum of both uses, as with flax's ``wte.attend``, and
``parallel.reducers.embedding_leaves`` finds ``wte`` and ``wpe``.

``dtype`` (``compute_dtype``) is flax's: fp32 parameters, and each layer
casts at the JAX model's own points (``models/layers.py``): dense layers,
the tables before their gathers and the head in ``dtype``, LayerNorm in
fp32 returning ``dtype``; the einsum attention scales its bf16 scores and
takes the softmax in fp32; prefill and decode take their scores in fp32;
logits leave in fp32. ``attn_impl``:

- ``"flash"``: :func:`..ops.flash_attention.flash_attention` with
  ``causal=True`` (the CUDA kernel on the card, its plain version on the
  CPU), which has no attention-weight dropout;
- ``"einsum"``: scores, a causal ``-inf`` mask, softmax, dropout;
- ``"auto"``: ``"flash"`` on both devices, except in training with dropout,
  where it stays on ``"einsum"`` so that "auto" never changes the math.

``deterministic`` defaults to True, as the JAX model's ``__call__`` does:
``experiments/gpt_lm.py`` trains without dropout, so its steps run flash.

Sequence parallelism: ``seq_axis`` is the process group the sequence is
sharded over (a mesh axis, ``ProcessMesh.group("seq")``), and attention
runs ``seq_impl``'s exact schedule from ``parallel/sequence.py``
(``"ring"`` or ``"ulysses"``, plain PyTorch, no attention-weight dropout)
with positions offset by ``axis_index * T_local``.

``remat``: each block runs under ``models.layers.remat_call``
(``torch.utils.checkpoint``, non-reentrant, the RNG state preserved): its
activations are dropped after the forward and recomputed in the backward,
dropout masks and the flash kernel's saved ``out`` and ``lse`` included,
so the gradients are the plain model's. The flash forward then runs twice
a step. ``scan_layers``: the reference's stacked layout, every block
parameter one leaf of shape ``(n_layers, ...)`` under ``h_scan.block.*``
(torch layout behind the layer axis), the blocks applied in turn through
``torch.func.functional_call`` on the leaves' rows (:class:`StackedBlocks`;
one checkpoint a layer under ``remat``). The unrolled ``h.{i}.*`` layout
converts both ways with :func:`stack_gpt_layer_params` and
:func:`unstack_gpt_layer_params`; a seed gives a ``scan_layers`` model the
stacked weights of the unrolled model's, so the two compute the same bits.
The KV-cache decoding and the model-parallel halves take the unrolled
layout.

Below the model, the JAX package's model-parallel halves of the GPT on
parameter dicts keyed by the port's names (``model.state_dict()``'s):
the pipeline decomposition (:func:`split_gpt_params`,
:func:`make_gpt_stage_fn`, :func:`gpt_embed_apply`, :func:`gpt_head_apply`,
:func:`make_gpt_pipeline_train_fn`) and Megatron tensor parallelism
(:func:`gpt_tp_param_specs`, :func:`tp_gpt_block_apply`,
:func:`vocab_parallel_embed`, :func:`vocab_parallel_next_token_loss`,
:func:`tp_gpt_forward`, :func:`make_gpt_tp_stage_fn`). A pipeline stage
runs the model's own :class:`GPTBlock` (``torch.func.functional_call``),
so a stage computes what ``GPTLM`` does, flash attention included. The TP
block computes as the JAX function does: its products promote
(``parallel/tensor.py``) and its attention is the einsum form.

Weights are drawn on the CPU from an explicit ``torch.Generator`` (GPT-2's
init: normal with std 0.02, the residual projections ``out_proj`` and
``mlp_proj`` at 0.02 / sqrt(2 n_layers), zero biases, unit LayerNorm
scales) and then moved to ``device``, so a seed gives the same weights on
every device.
"""

from __future__ import annotations

import contextlib
import copy
import math
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..ops.flash_attention import flash_attention
from ..ops.paged import gather_block_view, scatter_token_rows
from ..parallel.comm import all_gather, copy_to_axis, reduce_from_axis, world_size
from ..parallel.mesh import resolve_device
from ..parallel.pipeline import local_stage, make_pipeline_train_fn, stacked_stage_params
from ..parallel.sequence import ring_attention, ulysses_attention
from ..parallel.tensor import column_parallel_dense, row_parallel_dense, tp_mlp
from ..utils.config import ATTN_IMPLS
from .layers import attend, check_compute_dtype, dense, embed, layer_norm, remat_call, score_scale

_LN_EPS = 1e-5
_INIT_STD = 0.02
SEQ_IMPLS = ("ring", "ulysses")

Cache = List[Dict[str, torch.Tensor]]


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    max_position_embeddings: int = 1024
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    hidden_dim: int = 3072
    dropout: float = 0.1
    dtype: Any = torch.float32
    seq_axis: Any = None
    seq_impl: str = "ring"
    attn_impl: str = "auto"
    remat: bool = False
    scan_layers: bool = False

    def __post_init__(self) -> None:
        check_compute_dtype(self.dtype)
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")
        if self.dim % self.n_heads:
            raise ValueError(f"dim {self.dim} does not split into {self.n_heads} heads")
        if self.seq_impl not in SEQ_IMPLS:
            raise ValueError(f"GPTConfig.seq_impl must be one of {SEQ_IMPLS}, got {self.seq_impl!r}")

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


class CausalSelfAttention(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        dim = config.dim
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def _attn_impl(self, deterministic: bool) -> str:
        cfg = self.config
        if cfg.attn_impl == "auto":
            # flash cannot dropout-mask the attention weights
            return "einsum" if not deterministic and cfg.dropout > 0.0 else "flash"
        return cfg.attn_impl  # an explicit "flash" trains without weight dropout

    def forward(self, x: torch.Tensor, deterministic: bool) -> torch.Tensor:
        cfg = self.config
        dt = cfg.dtype
        b, t, _ = x.shape

        def split(y):
            return y.reshape(b, t, cfg.n_heads, cfg.head_dim)

        q, k, v = (split(dense(lin, x, dt)) for lin in (self.q_proj, self.k_proj, self.v_proj))
        if cfg.seq_axis is not None:
            schedule = ring_attention if cfg.seq_impl == "ring" else ulysses_attention
            ctx = schedule(q, k, v, cfg.seq_axis, causal=True)
        elif self._attn_impl(deterministic) == "flash":
            ctx = flash_attention(q, k, v, causal=True)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / score_scale(cfg.head_dim, dt)
            causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
            scores = scores.masked_fill(~causal, float("-inf"))
            weights = torch.softmax(scores.float(), dim=-1).to(dt)
            weights = F.dropout(weights, cfg.dropout, training=not deterministic)
            ctx = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return dense(self.out_proj, ctx.reshape(b, t, cfg.dim), dt)


class GPTBlock(nn.Module):
    """Pre-LN block (GPT-2): ``x + attn(LN(x))``, then ``x + mlp(LN(x))``."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        self.ln_1 = nn.LayerNorm(config.dim, eps=_LN_EPS)
        self.attn = CausalSelfAttention(config)
        self.ln_2 = nn.LayerNorm(config.dim, eps=_LN_EPS)
        self.mlp_fc = nn.Linear(config.dim, config.hidden_dim)
        self.mlp_proj = nn.Linear(config.hidden_dim, config.dim)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        h = dense(self.mlp_fc, layer_norm(self.ln_2, x, dt), dt)
        return dense(self.mlp_proj, F.gelu(h, approximate="tanh"), dt)

    def forward(self, x: torch.Tensor, deterministic: bool) -> torch.Tensor:
        x = x + self.attn(layer_norm(self.ln_1, x, self.config.dtype), deterministic)
        h = F.dropout(self.mlp(x), self.config.dropout, training=not deterministic)
        return x + h


class StackedBlocks(nn.Module):
    """``h_scan`` of a ``scan_layers`` GPT: every :class:`GPTBlock`
    parameter as one leaf ``(n_layers, ...)`` under ``block.*``, each layer
    applied as the model's own block through ``functional_call`` on the
    leaves' rows (``unbind``: one stack of the rows' gradients a leaf).
    ``stacks_layers`` marks its leaves for the reducer
    (``parallel.reducers.layer_stacked_leaves``)."""

    stacks_layers = True

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        self.block = GPTBlock(config)
        for name, p in list(self.block.named_parameters()):
            owner, _, attr = name.rpartition(".")
            setattr(self.block.get_submodule(owner), attr, nn.Parameter(p.new_empty((config.n_layers,) + p.shape)))
        self._template = [_block_template(config)]  # a list: not a submodule

    def forward(self, x: torch.Tensor, deterministic: bool) -> torch.Tensor:
        names, leaves = zip(*self.block.named_parameters())
        template = self._template[0]
        for rows in zip(*(leaf.unbind(0) for leaf in leaves)):
            layer = dict(zip(names, rows))
            x = remat_call(self.config.remat, lambda x, layer=layer: functional_call(template, layer, (x, deterministic)), x)
        return x


class GPTLM(nn.Module):
    """Decoder LM: token ids ``(B, T)`` -> next-token logits ``(B, T, V)``
    in fp32, the head tied to the token table."""

    def __init__(self, config: GPTConfig, device="cuda", seed: int = 0):
        super().__init__()
        # "meta": the shapes alone, with no storage and no init (e.g. the
        # reducer's shape groups and bits of a full-size model)
        meta = torch.device(device).type == "meta"
        device = torch.device("meta") if meta else resolve_device(device)
        self.config = config
        with device if meta else contextlib.nullcontext():
            self.wte = nn.Embedding(config.vocab_size, config.dim)
            self.wpe = nn.Embedding(config.max_position_embeddings, config.dim)
            blocks = nn.ModuleList(GPTBlock(config) for _ in range(config.n_layers))
            if config.scan_layers:
                self.h_scan = StackedBlocks(config)
            else:
                self.h = blocks
            self.ln_f = nn.LayerNorm(config.dim, eps=_LN_EPS)
        if not meta:
            self._init_weights(torch.Generator().manual_seed(seed), blocks)
            if config.scan_layers:  # the unrolled model's weights, stacked
                self.load_state_dict(stack_gpt_layer_params(_unrolled_state(self, blocks), config.n_layers))
            self.to(device)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator, blocks: nn.ModuleList) -> None:
        residual_std = _INIT_STD / math.sqrt(2 * self.config.n_layers)
        # the unrolled model's order: the tables, the blocks, the final LayerNorm
        modules = [
            ("wte", self.wte), ("wpe", self.wpe), *((f"h.{k}", m) for k, m in blocks.named_modules()),
            ("ln_f", self.ln_f),
        ]
        for name, mod in modules:
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                std = residual_std if name.endswith(("out_proj", "mlp_proj")) else _INIT_STD
                mod.weight.normal_(0.0, std, generator=gen)
                if isinstance(mod, nn.Linear):
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def forward(self, input_ids: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        cfg = self.config
        dt = cfg.dtype
        positions = gpt_position_ids(cfg, input_ids)
        x = embed(self.wte, input_ids, dt) + embed(self.wpe, positions, dt)
        x = F.dropout(x, cfg.dropout, training=not deterministic)
        if cfg.scan_layers:
            x = self.h_scan(x, deterministic)
        else:
            for block in self.h:
                x = remat_call(cfg.remat, block, x, deterministic)
        x = layer_norm(self.ln_f, x, dt)
        return attend(self.wte, x, dt).float()


def _unrolled_state(model: GPTLM, blocks: nn.ModuleList) -> Params:
    """The unrolled ``state_dict`` of a ``scan_layers`` model whose blocks
    are ``blocks``."""
    state = {k: v for k, v in model.state_dict().items() if not k.startswith("h_scan.")}
    state.update({f"h.{k}": v for k, v in blocks.state_dict().items()})
    return state


_UNROLLED_BLOCK = re.compile(r"^h\.(\d+)\.(.+)$")
_STACKED_PREFIX = "h_scan.block."


def stack_gpt_layer_params(params: Params, n_layers: int) -> Params:
    """Unrolled block parameters (``h.{i}.*``) -> the ``scan_layers``
    layout (``h_scan.block.*``, each leaf stacked on a leading layer axis),
    the reference's ``stack_gpt_layer_params`` on the port's names. Refuses
    a ``params`` whose blocks are not exactly ``0 .. n_layers - 1``: a
    wrong ``n_layers`` would otherwise drop or miss blocks silently."""
    blocks: Dict[int, Params] = {}
    out: Params = {}
    for name, value in params.items():
        m = _UNROLLED_BLOCK.match(name)
        if m:
            blocks.setdefault(int(m.group(1)), {})[m.group(2)] = value
        else:
            out[name] = value
    if sorted(blocks) != list(range(n_layers)):
        raise ValueError(
            f"stack_gpt_layer_params(n_layers={n_layers}): params carry blocks {sorted(blocks)},"
            f" expected exactly {list(range(n_layers))}"
        )
    for leaf in blocks[0]:
        out[_STACKED_PREFIX + leaf] = torch.stack([blocks[i][leaf] for i in range(n_layers)])
    return out


def unstack_gpt_layer_params(params: Params) -> Params:
    """The ``scan_layers`` layout -> unrolled ``h.{i}.*`` names (rows of
    the stacked leaves), e.g. to decode with the KV cache or to split into
    pipeline stages."""
    out = {k: v for k, v in params.items() if not k.startswith(_STACKED_PREFIX)}
    for name, value in params.items():
        if name.startswith(_STACKED_PREFIX):
            for i, row in enumerate(value.unbind(0)):
                out[f"h.{i}.{name[len(_STACKED_PREFIX):]}"] = row
    return out


def _unrolled_blocks(model: GPTLM) -> nn.ModuleList:
    """The blocks of an unrolled model; a ``scan_layers`` model is refused
    (the KV-cache paths address blocks one by one)."""
    if model.config.scan_layers:
        raise ValueError(
            "the KV-cache decoding takes the unrolled layout: load unstack_gpt_layer_params(model.state_dict())"
            " into a GPTLM without scan_layers"
        )
    return model.h


def gpt_small(dtype=torch.float32, device="cuda", seed: int = 0, **overrides) -> GPTLM:
    """GPT-2 small's shape (124M at vocab 50257): dim 768, 12 layers, 12
    heads, FFN 3072, 1024 positions."""
    return GPTLM(GPTConfig(dtype=dtype, **overrides), device, seed)


def gpt_tiny(dtype=torch.float32, device="cuda", seed: int = 0, **overrides) -> GPTLM:
    """The test tier: 2 layers, 4 heads, dim 32."""
    cfg = dict(
        vocab_size=128, max_position_embeddings=128, dim=32, n_layers=2,
        n_heads=4, hidden_dim=64, dropout=0.0,
    )
    cfg.update(overrides)
    return GPTLM(GPTConfig(dtype=dtype, **cfg), device, seed)


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy; ``labels`` already shifted host-side."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


def gpt_position_ids(config: GPTConfig, input_ids: torch.Tensor) -> torch.Tensor:
    """Position ids ``(1, T)`` of a token block: offset by this rank's index
    on ``seq_axis`` times the block's length when the sequence is sharded."""
    t = input_ids.shape[1]
    positions = torch.arange(t, device=input_ids.device)[None, :]
    if config.seq_axis is not None:
        positions = positions + dist.get_rank(config.seq_axis) * t
    return positions


# ---- pipeline-parallel decomposition ----------------------------------------
#
# A GPT splits into the embedding front (cheap, on every pipe rank), N stages
# of n_layers / N blocks (pipelined over the 'pipe' axis), and the final
# LayerNorm with the tied head. Parameters are dicts of the port's names;
# a stage's dict holds block-relative names ("attn.q_proj.weight") stacked
# over the stage's layers.

Params = Dict[str, torch.Tensor]
_BLOCK_PREFIX = "h."


def _block_template(config: GPTConfig) -> GPTBlock:
    """A :class:`GPTBlock` with no storage, to apply with another block's
    parameters (``functional_call``)."""
    with torch.device("meta"):
        return GPTBlock(config)


def split_gpt_params(params: Params, n_stages: int) -> Tuple[Params, List[Params], Params]:
    """Split a ``GPTLM`` parameter dict into ``(embed, stages, final)``:
    ``embed`` holds ``wte.weight`` (the tied head too) and ``wpe.weight``,
    ``stages[s]`` stage ``s``'s blocks stacked on a leading layer axis,
    ``final`` ``ln_f``'s weight and bias."""
    n_layers = 1 + max(int(k.split(".")[1]) for k in params if k.startswith(_BLOCK_PREFIX))
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} equal stages")
    per = n_layers // n_stages
    embed = {k: params[k] for k in ("wte.weight", "wpe.weight")}
    final = {k: params[k] for k in ("ln_f.weight", "ln_f.bias")}
    names = [k[len("h.0."):] for k in params if k.startswith("h.0.")]
    stages = []
    for s in range(n_stages):
        blocks = [{n: params[f"h.{s * per + j}.{n}"] for n in names} for j in range(per)]
        stages.append(stacked_stage_params(blocks))
    return embed, stages, final


def make_gpt_stage_fn(config: GPTConfig, layers_per_stage: int) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """``stage_fn(stage_params, x)`` applying the stage's blocks in turn,
    each the model's own :class:`GPTBlock` without dropout. Refuses a
    config with dropout: the schedules have no per-microbatch random
    state."""
    if config.dropout > 0:
        raise ValueError("pipeline stages run deterministically (no dropout rng plumbing); use dropout=0.0")
    block = _block_template(config)

    def stage_fn(p: Params, x: torch.Tensor) -> torch.Tensor:
        for j in range(layers_per_stage):
            x = functional_call(block, local_stage(p, j), (x, True))
        return x

    return stage_fn


def _table_rows(config: GPTConfig, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, table.to(config.dtype))


def gpt_position_embed(config: GPTConfig, wpe: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
    """The position table's rows for ``input_ids`` (``seq_axis``-aware)."""
    return _table_rows(config, wpe, gpt_position_ids(config, input_ids))


def gpt_embed_apply(config: GPTConfig, embed: Params, input_ids: torch.Tensor) -> torch.Tensor:
    """The embedding front: token ids -> the first block's input, as
    ``GPTLM.forward`` computes it without dropout."""
    return _table_rows(config, embed["wte.weight"], input_ids) + gpt_position_embed(
        config, embed["wpe.weight"], input_ids
    )


def gpt_head_matmul(config: GPTConfig, ln_f: Params, wte_matrix: torch.Tensor, x: torch.Tensor, group=None):
    """Final LayerNorm, then the tied head's product with ``wte_matrix``
    (the whole table, or this rank's vocabulary rows: then ``group`` is the
    model axis, and the replicated input's gradient is summed over it)."""
    x = F.layer_norm(x.float(), (config.dim,), ln_f["weight"], ln_f["bias"], _LN_EPS).to(config.dtype)
    x = copy_to_axis(x, group)
    return F.linear(x, wte_matrix.to(config.dtype)).float()


def gpt_head_apply(config: GPTConfig, final: Params, embed: Params, x: torch.Tensor) -> torch.Tensor:
    """The head: final LayerNorm and the logits of the tied table, fp32."""
    ln_f = {"weight": final["ln_f.weight"], "bias": final["ln_f.bias"]}
    return gpt_head_matmul(config, ln_f, embed["wte.weight"], x)


def _sum_over(trees: List[Params], group) -> List[Params]:
    """Sum every leaf of ``trees`` over ``group`` in one all-reduce."""
    if group is None:
        return trees
    flat = torch.cat([v.reshape(-1).float() for t in trees for v in t.values()])
    flat = reduce_from_axis(flat, group)
    out, at = [], 0
    for t in trees:
        d = {}
        for k, v in t.items():
            d[k] = flat[at : at + v.numel()].view(v.shape).to(v.dtype)
            at += v.numel()
        out.append(d)
    return out


def make_gpt_pipeline_train_fn(
    config: GPTConfig,
    layers_per_stage: int,
    num_microbatches: int,
    group,
    stage_fn: Optional[Callable[[Params, torch.Tensor], torch.Tensor]] = None,
):
    """Full-model 1F1B training: every parameter gets its gradient.

    The head and final LayerNorm are the schedule's loss parameters (their
    gradients arrive on the last stage, the tied ``wte``'s head part
    among them); the embedding's gradients come from the pipeline input's
    gradient on stage 0, through the embedding front's backward. One
    all-reduce over ``group`` (the ``pipe`` axis) sums both ends, so
    ``embed`` and ``final`` gradients and the loss are the same on every
    pipe rank, as the JAX function's psums make them.

    Returns ``fn(embed, stage_params, final, ids, labels) -> (loss,
    (embed_grads, stage_grads, final_grads))``, with this rank's stage.
    ``stage_fn=make_gpt_tp_stage_fn(...)`` tensor-shards each stage over a
    ``model`` axis as well: the 3-D ``data x pipe x model`` composition."""
    if stage_fn is None:
        stage_fn = make_gpt_stage_fn(config, layers_per_stage)

    def mb_loss(lp, y, labels):  # lp: the tied table and ln_f
        return next_token_loss(gpt_head_apply(config, lp, lp, y), labels)

    pipe = make_pipeline_train_fn(
        stage_fn, mb_loss, group, num_microbatches, loss_has_params=True, return_input_grads=True
    )

    def fn(embed: Params, stage_params: Params, final: Params, ids: torch.Tensor, labels: torch.Tensor):
        e = {k: v.detach().requires_grad_(True) for k, v in embed.items()}
        x = gpt_embed_apply(config, e, ids)
        loss, stage_grads, dlp, dx = pipe(
            stage_params, {"wte.weight": embed["wte.weight"], **final}, x.detach(), labels
        )
        first = group is None or dist.get_rank(group) == 0
        if first:  # the embedding's own backward, on the stage that holds dx
            torch.autograd.backward(x, grad_tensors=dx)
        d_embed = {k: v.grad if v.grad is not None else torch.zeros_like(v) for k, v in e.items()}
        d_embed["wte.weight"] = d_embed["wte.weight"] + dlp.pop("wte.weight")
        d_embed, d_final = _sum_over([d_embed, dlp], group)
        return loss, (d_embed, stage_grads, d_final)

    return fn


# ---- tensor parallelism ---------------------------------------------------------
#
# Megatron TP over a 'model' axis on a parameter dict of shards: q/k/v and
# mlp_fc weights column-sharded (rows of the (out, in) weight: head groups,
# since heads are contiguous head_dim blocks of the output features) with
# their biases, out_proj and mlp_proj weights row-sharded (columns: input
# features) with their biases replicated, LayerNorms and positions
# replicated; the tied token table replicated, or vocabulary-sharded
# (rows) with vocab_parallel. Two all-reduces a block forward, two
# backward.

_COLUMN = ("attn.q_proj", "attn.k_proj", "attn.v_proj", "mlp_fc")
_ROW = ("attn.out_proj", "mlp_proj")


def gpt_tp_param_specs(config: GPTConfig, vocab_parallel: bool = False) -> Dict[str, Optional[int]]:
    """The dimension each ``GPTLM`` parameter is sharded on over the model
    axis (None: replicated), by name."""
    specs: Dict[str, Optional[int]] = {
        "wte.weight": 0 if vocab_parallel else None, "wpe.weight": None, "ln_f.weight": None, "ln_f.bias": None,
    }
    for i in range(config.n_layers):
        for ln in ("ln_1", "ln_2"):
            specs[f"h.{i}.{ln}.weight"] = specs[f"h.{i}.{ln}.bias"] = None
        for name in _COLUMN:
            specs[f"h.{i}.{name}.weight"] = specs[f"h.{i}.{name}.bias"] = 0
        for name in _ROW:
            specs[f"h.{i}.{name}.weight"], specs[f"h.{i}.{name}.bias"] = 1, None
    return specs


def tp_shard(params: Params, specs: Dict[str, Optional[int]], index: int, n: int) -> Params:
    """Rank ``index`` of ``n``'s shard of every parameter: the ``index``-th
    of ``n`` equal slices along its spec's dimension, or the whole tensor."""
    out = {}
    for name, t in params.items():
        dim = specs[name]
        out[name] = t if dim is None else t.chunk(n, dim=dim)[index]
    return out


def _ln(config: GPTConfig, p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), (config.dim,), p[f"{name}.weight"], p[f"{name}.bias"], _LN_EPS).to(config.dtype)


def tp_gpt_block_apply(config: GPTConfig, p: Params, x: torch.Tensor, group) -> torch.Tensor:
    """One GPT block, tensor-parallel over ``group`` (the model axis), on
    this rank's shards ``p`` (block-relative names): head-sharded attention
    (column-parallel q/k/v, the local heads, row-parallel out projection:
    one all-reduce) and the column -> row MLP (one more). LayerNorms and
    residuals run on the replicated stream on every rank. Deterministic,
    the einsum attention with a causal mask."""
    n = world_size(group)
    if config.n_heads % n:
        raise ValueError(f"{n} model shards do not divide n_heads={config.n_heads}")
    local_heads = config.n_heads // n
    hd = config.head_dim
    h = copy_to_axis(_ln(config, p, "ln_1", x), group)
    q, k, v = (
        column_parallel_dense(h, p[f"attn.{name}.weight"], p[f"attn.{name}.bias"]).reshape(
            x.shape[0], x.shape[1], local_heads, hd
        )
        for name in ("q_proj", "k_proj", "v_proj")
    )
    t = x.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / score_scale(hd, config.dtype)
    causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    weights = torch.softmax(scores.float(), dim=-1).to(config.dtype)
    dt = torch.promote_types(weights.dtype, v.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", weights.to(dt), v.to(dt)).reshape(x.shape[0], t, local_heads * hd)
    x = x + row_parallel_dense(ctx, p["attn.out_proj.weight"], p["attn.out_proj.bias"], group)
    h = _ln(config, p, "ln_2", x)
    return x + tp_mlp(
        h, p["mlp_fc.weight"], p["mlp_fc.bias"], p["mlp_proj.weight"], p["mlp_proj.bias"], group,
        activation=lambda a: F.gelu(a, approximate="tanh"),
    )


def vocab_parallel_embed(config: GPTConfig, wte_shard: torch.Tensor, input_ids: torch.Tensor, group) -> torch.Tensor:
    """Megatron's vocabulary-parallel embedding: each rank looks up the ids
    in its row range (zeros elsewhere), and one all-reduce assembles the
    replicated embedding."""
    local_v = wte_shard.shape[0]
    local_ids = input_ids.long() - _rank(group) * local_v
    in_range = (local_ids >= 0) & (local_ids < local_v)
    rows = F.embedding(local_ids.clamp(0, local_v - 1), wte_shard.to(config.dtype))
    rows = torch.where(in_range[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return reduce_from_axis(rows, group)


def vocab_parallel_next_token_loss(logits_shard: torch.Tensor, labels: torch.Tensor, group) -> torch.Tensor:
    """Mean next-token cross-entropy over vocabulary-sharded logits
    ``(..., V / N)`` without the full-vocabulary row: the global max (a
    stabiliser whose terms cancel, so it carries no gradient) from an
    all-gather of the local maxima, then the sum of exponentials and the
    target logit each summed over the axis. Equals :func:`next_token_loss`
    on the assembled logits."""
    logits_shard = logits_shard.float()
    local_v = logits_shard.shape[-1]
    with torch.no_grad():
        m = all_gather(logits_shard.amax(dim=-1), group).amax(dim=0)
    sumexp = reduce_from_axis(torch.exp(logits_shard - m[..., None]).sum(dim=-1), group)
    local_labels = labels.long() - _rank(group) * local_v
    in_range = (local_labels >= 0) & (local_labels < local_v)
    tgt_local = logits_shard.gather(-1, local_labels.clamp(0, local_v - 1)[..., None])[..., 0]
    tgt = reduce_from_axis(torch.where(in_range, tgt_local, torch.zeros_like(tgt_local)), group)
    return torch.mean(m + torch.log(sumexp) - tgt)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _block_params(params: Params, i: int) -> Params:
    prefix = f"h.{i}."
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def tp_gpt_forward(
    config: GPTConfig, params: Params, input_ids: torch.Tensor, group, vocab_parallel: bool = False
) -> torch.Tensor:
    """The whole decoder, tensor-parallel over ``group``, on this rank's
    shards (:func:`gpt_tp_param_specs`, :func:`tp_shard`): embedding, TP
    blocks, final LayerNorm and tied head. With ``vocab_parallel`` the
    token table is sharded by rows, the lookup is
    :func:`vocab_parallel_embed` and the head returns this rank's
    vocabulary slice of the logits, for
    :func:`vocab_parallel_next_token_loss`. Deterministic."""
    if config.dropout > 0:
        raise ValueError("tensor-parallel apply runs deterministically; use dropout=0.0")
    if vocab_parallel:
        x = vocab_parallel_embed(config, params["wte.weight"], input_ids, group)
        x = x + gpt_position_embed(config, params["wpe.weight"], input_ids)
    else:
        x = gpt_embed_apply(config, params, input_ids)
    for i in range(config.n_layers):
        x = tp_gpt_block_apply(config, _block_params(params, i), x, group)
    ln_f = {"weight": params["ln_f.weight"], "bias": params["ln_f.bias"]}
    return gpt_head_matmul(config, ln_f, params["wte.weight"], x, group if vocab_parallel else None)


def make_gpt_tp_stage_fn(config: GPTConfig, layers_per_stage: int, group):
    """A tensor-parallel pipeline stage: each of its blocks through
    :func:`tp_gpt_block_apply` on this rank's shards over ``group`` (the
    model axis), stage parameters stacked on a leading layer axis as
    :func:`make_gpt_stage_fn` takes them. Deterministic."""
    if config.dropout > 0:
        raise ValueError("pipeline stages run deterministically (no dropout rng plumbing); use dropout=0.0")

    def stage_fn(p: Params, x: torch.Tensor) -> torch.Tensor:
        for j in range(layers_per_stage):
            x = tp_gpt_block_apply(config, local_stage(p, j), x, group)
        return x

    return stage_fn


# ---- KV-cache decoding ---------------------------------------------------
#
# The JAX package's functions take (config, params); here the GPTLM module
# carries both. The attention of prefill and decode is plain PyTorch with
# fp32 scores over the whole cache (positions past ``pos`` masked), as the
# JAX functions compute it, not the flash kernel.


def init_gpt_cache(config: GPTConfig, batch: int, max_len: int, *, device) -> Cache:
    """Per-layer K/V cache: zeros of ``(B, max_len, H, D)`` in
    ``config.dtype`` on ``device``, which has no default: a cache belongs
    beside its model."""
    shape = (batch, max_len, config.n_heads, config.head_dim)
    return [
        {"k": torch.zeros(shape, dtype=config.dtype, device=device),
         "v": torch.zeros(shape, dtype=config.dtype, device=device)}
        for _ in range(config.n_layers)
    ]


def _cached_attention(q, k, v, valid, head_dim):
    """Softmax attention in fp32 of ``q`` over cached ``k``, ``v``
    (``(B, S, H, D)``) where ``valid`` (broadcast to the scores) allows."""
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) / math.sqrt(head_dim)
    scores = scores.masked_fill(~valid, float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", weights, v.float())


def _block_tail(block: GPTBlock, x, ctx, dt):
    """The rest of a block after the attention context ``ctx``: out_proj,
    the residual, then the MLP and its residual."""
    x = x + dense(block.attn.out_proj, ctx.reshape(*x.shape).to(dt), dt)
    return x + block.mlp(x)


def _head(model: GPTLM, x, dt):
    return attend(model.wte, layer_norm(model.ln_f, x, dt), dt).float()


@torch.no_grad()
def gpt_prefill(model: GPTLM, prompt_ids: torch.Tensor, max_len: int):
    """Fill the K/V cache for the whole prompt in ONE batched forward.
    Returns ``(last_logits (B, V) fp32, cache)`` with cache positions
    ``< T_prompt`` filled."""
    cfg = model.config
    dt = cfg.dtype
    b, t = prompt_ids.shape
    device = prompt_ids.device
    x = model.wte.weight[prompt_ids].to(dt) + model.wpe.weight[:t][None].to(dt)
    cache = init_gpt_cache(cfg, b, max_len, device=device)
    causal = torch.ones((t, t), dtype=torch.bool, device=device).tril()
    for layer, block in zip(cache, _unrolled_blocks(model)):
        h = layer_norm(block.ln_1, x, dt)
        q, k, v = (
            dense(lin, h, dt).reshape(b, t, cfg.n_heads, cfg.head_dim)
            for lin in (block.attn.q_proj, block.attn.k_proj, block.attn.v_proj)
        )
        layer["k"][:, :t] = k
        layer["v"][:, :t] = v
        x = _block_tail(block, x, _cached_attention(q, k, v, causal, cfg.head_dim), dt)
    return _head(model, x[:, -1], dt), cache


def _decode_layers(model: GPTLM, cache: Cache, x, valid, write) -> torch.Tensor:
    """The blocks and the head of a one-token decode step from the embedded
    tokens ``x`` ``(B, dim)``: in each layer ``write(layer, k, v)`` stores
    the new token's K/V (``(B, H, D)`` each) in the cache and returns the
    ``(B, S, H, D)`` keys and values to attend over where ``valid`` allows.
    Returns the logits ``(B, V)`` in fp32."""
    cfg = model.config
    dt = cfg.dtype
    for layer, block in zip(cache, _unrolled_blocks(model)):
        h = layer_norm(block.ln_1, x, dt)
        q, k, v = (
            dense(lin, h, dt).reshape(-1, 1, cfg.n_heads, cfg.head_dim)
            for lin in (block.attn.q_proj, block.attn.k_proj, block.attn.v_proj)
        )
        keys, values = write(layer, k[:, 0], v[:, 0])
        ctx = _cached_attention(q, keys, values, valid, cfg.head_dim)
        x = _block_tail(block, x, ctx, dt)
    return _head(model, x, dt)


def _decode_step_(model: GPTLM, cache: Cache, tokens: torch.Tensor, pos: int) -> torch.Tensor:
    """One decode step that writes ``tokens``' K/V into ``cache`` in place;
    returns the logits ``(B, V)`` in fp32."""
    dt = model.config.dtype
    max_len = cache[0]["k"].shape[1]
    x = model.wte.weight[tokens].to(dt) + model.wpe.weight[pos].to(dt)  # (B, dim)
    valid = torch.arange(max_len, device=tokens.device) <= pos

    def write(layer, k, v):
        layer["k"][:, pos] = k
        layer["v"][:, pos] = v
        return layer["k"], layer["v"]

    return _decode_layers(model, cache, x, valid, write)


def _embed_rows(model: GPTLM, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``wte[tokens] + wpe[pos]`` for a position per row; a position past the
    table reads its last row, as JAX clamps a gather (a speculative round
    feeds up to K - 1 positions past a finished row; those logits are
    dropped)."""
    dt = model.config.dtype
    last = model.config.max_position_embeddings - 1
    return model.wte.weight[tokens].to(dt) + model.wpe.weight[pos.clamp(max=last)].to(dt)


def _row_valid(pos: torch.Tensor, max_len: int) -> torch.Tensor:
    """Row ``b`` attends to positions ``<= pos[b]``: ``(B, 1, 1, max_len)``,
    broadcast over the heads and the one query."""
    return (torch.arange(max_len, device=pos.device)[None, :] <= pos[:, None])[:, None, None, :]


@torch.no_grad()
def gpt_decode_step_slots(model: GPTLM, cache: Cache, tokens: torch.Tensor, pos: torch.Tensor):
    """One decode step with a position per row: row ``b`` feeds
    ``tokens[b]`` at ``pos[b]`` (both ``(B,)``, long) and attends to its own
    cache prefix ``<= pos[b]``, so slots at different depths share one step
    (the continuous-batching step of ``serving.engine``). Each row's math is
    :func:`gpt_decode_step`'s at that position. The K/V are written into
    ``cache`` in place (where the JAX engine donates it); a position past the
    cache writes its last row, as JAX's ``dynamic_update_slice`` clamps.
    Returns ``(logits (B, V) fp32, cache)``."""
    max_len = cache[0]["k"].shape[1]
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    at = pos.clamp(max=max_len - 1)

    def write(layer, k, v):
        layer["k"][rows, at] = k
        layer["v"][rows, at] = v
        return layer["k"], layer["v"]

    logits = _decode_layers(model, cache, _embed_rows(model, tokens, pos), _row_valid(pos, max_len), write)
    return logits, cache


@torch.no_grad()
def gpt_decode_step_paged(
    model: GPTLM, pool: Cache, tables: torch.Tensor, tokens: torch.Tensor, pos: torch.Tensor
):
    """:func:`gpt_decode_step_slots` over a paged KV cache: each layer's K/V
    live in a block pool ``(n_blocks, block_len, H, D)`` and row ``b``'s
    logical ``(max_len, H, D)`` cache is stitched through its block table
    (``tables`` ``(B, max_len // block_len)``, long). Row ``b`` writes its
    K/V at ``(tables[b, pos[b] // L], pos[b] % L)`` in place
    (``ops.paged.scatter_token_rows``: a position past the table goes to
    the garbage block 0), then attends over the gathered ``(B, max_len, H,
    D)`` view with the slot step's math, so valid positions carry the same
    bits and the ``<= pos`` mask gives every other position a weight of
    exactly 0. Returns ``(logits (B, V) fp32, pool)``."""
    max_len = tables.shape[1] * pool[0]["k"].shape[1]

    def write(layer, k, v):
        scatter_token_rows(layer["k"], tables, pos, k)
        scatter_token_rows(layer["v"], tables, pos, v)
        return gather_block_view(layer["k"], tables), gather_block_view(layer["v"], tables)

    logits = _decode_layers(model, pool, _embed_rows(model, tokens, pos), _row_valid(pos, max_len), write)
    return logits, pool


@torch.no_grad()
def gpt_prefill_shared(model: GPTLM, suffix_ids: torch.Tensor, prefix_cache: Cache):
    """Prefill only the suffix of a prompt whose first ``P`` tokens already
    have K/V (prefix sharing: ``prefix_cache`` holds per layer ``(1, P, H,
    D)``, gathered from the block pool). ``suffix_ids`` ``(1, t_s)`` sit at
    positions ``P .. P + t_s - 1``; their queries attend over the prefix's
    K/V and their own under the global causal mask, so each query's softmax
    spans the keys a full prefill would give it. Returns ``(last_logits (1,
    V) fp32, suffix_cache)``, the suffix's K/V per layer ``(1, t_s, H,
    D)``."""
    cfg = model.config
    dt = cfg.dtype
    b, t = suffix_ids.shape
    p_len = prefix_cache[0]["k"].shape[1]
    device = suffix_ids.device
    x = model.wte.weight[suffix_ids].to(dt) + model.wpe.weight[p_len : p_len + t][None].to(dt)
    # query j sits at position p_len + j: it attends to keys 0 .. p_len + j
    causal = torch.arange(p_len + t, device=device)[None, :] <= (p_len + torch.arange(t, device=device))[:, None]
    suffix_cache = []
    for prefix, block in zip(prefix_cache, _unrolled_blocks(model)):
        h = layer_norm(block.ln_1, x, dt)
        q, k, v = (
            dense(lin, h, dt).reshape(b, t, cfg.n_heads, cfg.head_dim)
            for lin in (block.attn.q_proj, block.attn.k_proj, block.attn.v_proj)
        )
        suffix_cache.append({"k": k, "v": v})
        keys = torch.cat([prefix["k"].to(dt), k], dim=1)
        values = torch.cat([prefix["v"].to(dt), v], dim=1)
        x = _block_tail(block, x, _cached_attention(q, keys, values, causal, cfg.head_dim), dt)
    return _head(model, x[:, -1], dt), suffix_cache


def weights_cast_once(model: GPTLM) -> GPTLM:
    """``model`` with its Linear and Embedding weights cast to its compute
    dtype once, for a decode loop, whose weights do not change: every cast
    a step would make gives these same values, so the logits are bitwise
    those of ``model``. LayerNorm stays fp32, as flax keeps it. An fp32
    model is returned as it is."""
    dt = model.config.dtype
    if dt == torch.float32:
        return model
    twin = copy.deepcopy(model)
    for mod in twin.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            mod.to(dt)
    return twin


def _copy_cache(cache: Cache) -> Cache:
    return [{name: t.clone() for name, t in layer.items()} for layer in cache]


@torch.no_grad()
def gpt_decode_step(model: GPTLM, cache: Cache, tokens: torch.Tensor, pos: int):
    """One decode step: ``tokens`` (B,) at position ``pos`` -> ``(logits
    (B, V) fp32, new cache)``. Attends to cache positions ``<= pos``. The
    input cache is not changed: a new one is returned."""
    cache = _copy_cache(cache)
    return _decode_step_(model, cache, tokens, pos), cache


def _sample_token(logits: torch.Tensor, temperature: float, generator: Optional[torch.Generator]):
    """Greedy (``temperature=0``, the first of equal maxima, as
    ``jnp.argmax``) or a draw from ``softmax(logits / temperature)`` with
    ``generator``; the draws cannot be ``jax.random``'s."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _decode(model, cache, first, t_prompt, n_steps, temperature, generator, eos_token_id):
    """``n_steps`` decode steps from ``first`` at ``t_prompt``, writing into
    ``cache``; ``(B, n_steps)`` ids. A row that has emitted
    ``eos_token_id`` pads the rest of its row with it; the tokens before its
    stop are those of the run without EOS."""
    tok = first
    done = None if eos_token_id is None else first == eos_token_id
    out = []
    for i in range(n_steps):
        nxt = _sample_token(_decode_step_(model, cache, tok, t_prompt + i), temperature, generator)
        if done is not None:
            nxt = torch.where(done, eos_token_id, nxt)
            done = done | (nxt == eos_token_id)
        out.append(nxt)
        tok = nxt
    if not out:
        return torch.zeros((first.shape[0], 0), dtype=torch.long, device=first.device)
    return torch.stack(out, dim=1)


@torch.no_grad()
def decode_tokens(
    model: GPTLM,
    cache: Cache,
    first: torch.Tensor,
    t_prompt: int,
    n_steps: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    eos_token_id: Optional[int] = None,
) -> torch.Tensor:
    """The decode half of :func:`generate` on its own: feed ``first`` (B,)
    at position ``t_prompt`` and run ``n_steps`` one-token decode steps,
    returning the ``(B, n_steps)`` sampled ids. The caller's cache is not
    changed."""
    return _decode(
        weights_cast_once(model), _copy_cache(cache), first, t_prompt, n_steps, temperature, generator, eos_token_id
    )


@torch.no_grad()
def generate(
    model: GPTLM,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    eos_token_id: Optional[int] = None,
    cache_len: Optional[int] = None,
) -> torch.Tensor:
    """Autoregressive sampling: a batched prefill of the prompt, then
    ``max_new_tokens - 1`` one-token decode steps; greedy
    (``temperature=0``) or temperature sampling with ``generator``. Returns
    ``(B, max_new_tokens)`` ids. ``eos_token_id`` stops a row (see
    :func:`decode_tokens`); ``cache_len`` sets the KV cache's capacity
    (default: exactly ``T_prompt + max_new_tokens``)."""
    b, t_prompt = prompt_ids.shape
    total = t_prompt + max_new_tokens
    if total > model.config.max_position_embeddings:
        raise ValueError(f"{total} positions > max_position_embeddings {model.config.max_position_embeddings}")
    if max_new_tokens <= 0:
        return torch.zeros((b, 0), dtype=torch.long, device=prompt_ids.device)
    cache_len = total if cache_len is None else cache_len
    if cache_len < total:
        raise ValueError(f"cache_len {cache_len} < {total} positions")
    model = weights_cast_once(model)
    last_logits, cache = gpt_prefill(model, prompt_ids, cache_len)
    first = _sample_token(last_logits, temperature, generator)
    rest = _decode(model, cache, first, t_prompt, max_new_tokens - 1, temperature, generator, eos_token_id)
    return torch.cat([first[:, None], rest], dim=1)
