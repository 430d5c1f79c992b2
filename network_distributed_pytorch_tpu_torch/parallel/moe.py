"""Expert parallelism: a Switch-style routed mixture of experts with
all-to-all token dispatch, the JAX package's ``parallel/moe.py``.

- experts live on an ``expert`` mesh axis: rank ``i`` holds only its
  ``E / N`` experts' parameters, stacked on a leading expert axis
  (:func:`stacked_expert_params`);
- routing is the Mesh-TF / Switch dispatch-mask formulation: one-hot
  ``(T, E, C)`` dispatch and combine tensors and einsums, capacity-bounded
  (an assignment over capacity drops, and its token keeps only the
  residual path);
- tokens move with TWO :func:`..comm.all_to_all` hops, to the experts and
  back; autograd's backward runs the inverse hops;
- the Switch load-balancing loss ``E * sum_e fraction_e * prob_e``
  (Switch Transformer eq. 4) comes back with the output.

The same ranks shard the token batch and the experts. ``group=None`` is the
single-process path: every expert local, no all-to-all.

At ``T`` tokens, ``E`` experts and capacity ``C`` each of the dispatch and
combine tensors holds ``T * E * C`` fp32 values; with the usual ``C =
factor * k * T / E`` that is ``factor * k * T^2`` values, whatever ``E``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from .comm import all_to_all, world_size

Params = Dict[str, torch.Tensor]


class MoEOutput(NamedTuple):
    out: torch.Tensor  # (T, D) combined expert outputs (0 for dropped)
    aux_loss: torch.Tensor  # scalar load-balance loss (Switch eq. 4)
    # scalar: the fraction of the T * top_k (token, choice) ASSIGNMENTS over
    # capacity (a kept primary and a dropped secondary count 1/2)
    dropped_fraction: torch.Tensor


def routing(x: torch.Tensor, router_kernel: torch.Tensor, top_k: int):
    """The router in fp32: ``(probs (T, E), topk_probs (T, K), topk_idx (T,
    K))``, ``topk_probs`` in descending order (ties to the lower index)."""
    probs = torch.softmax(x.float() @ router_kernel.float(), dim=-1)
    topk_probs, topk_idx = torch.topk(probs, top_k, dim=-1)
    return probs, topk_probs, topk_idx


def switch_moe(
    x: torch.Tensor,
    router_kernel: torch.Tensor,
    expert_params: Params,
    expert_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    group,
    capacity: int,
    top_k: int = 1,
) -> MoEOutput:
    """Routed mixture-of-experts layer.

    ``x`` is this rank's ``(T, D)`` tokens, ``router_kernel`` ``(D, E)``
    replicated, ``expert_params`` this rank's ``(E_local, ...)`` stacked
    experts (``E = N * E_local``), and ``expert_fn(params, tokens)`` runs
    ALL local experts at once on ``(E_local, slots, D)`` with the stacked
    parameters (a batched matmul; the JAX package vmaps one expert's
    function). ``capacity`` is per (expert, source rank).

    ``top_k > 1`` is GShard routing: each token goes to its ``top_k``
    experts, gates renormalised over the chosen ones, with PRIORITY
    dispatch: choice 0 claims capacity first, then choice 1 takes what
    remains. ``top_k = 1`` is Switch: the same gates, aux loss and drops."""
    t, d = x.shape
    n = world_size(group)
    e_local = next(iter(expert_params.values())).shape[0]
    e = n * e_local
    if router_kernel.shape[1] != e:
        raise ValueError(
            f"router routes over {router_kernel.shape[1]} experts but the mesh holds {e}"
            f" ({n} ranks x {e_local} local)"
        )
    if not 1 <= top_k <= e:
        raise ValueError(f"top_k={top_k} outside [1, {e}]")
    probs, topk_probs, topk_idx = routing(x, router_kernel, top_k)
    # GShard renormalisation over the chosen experts
    gates = topk_probs / topk_probs.sum(dim=-1, keepdim=True) if top_k > 1 else topk_probs

    # priority dispatch: choice 0 claims capacity slots first through the
    # running per-expert counts (fp32 counts, exact below 2**24)
    counts = torch.zeros((e,), device=x.device)
    dispatch = torch.zeros((t, e, capacity), device=x.device)
    combine = torch.zeros((t, e, capacity), device=x.device)
    kept = torch.zeros((), device=x.device)
    primary = None
    for k in range(top_k):
        oh = F.one_hot(topk_idx[:, k], e).float()  # (T, E)
        if k == 0:
            primary = oh
        # each token's slot in its expert's buffer, after the earlier choices'
        pos = counts[None, :] + torch.cumsum(oh, dim=0) - oh
        pos_tok = (pos * oh).sum(dim=-1)  # (T,)
        keep = pos_tok < capacity
        slot = F.one_hot(pos_tok.long().clamp(max=capacity - 1), capacity).float()
        d_k = oh[:, :, None] * slot[:, None, :] * keep[:, None, None].float()
        dispatch = dispatch + d_k
        combine = combine + d_k * gates[:, k][:, None, None]
        counts = counts + (oh * keep[:, None].float()).sum(dim=0)
        kept = kept + keep.float().sum()
    dropped_fraction = 1.0 - kept / (t * top_k)

    # the load-balance loss BEFORE capacity drops, on the primary choice
    aux_loss = e * torch.sum(primary.mean(dim=0) * probs.mean(dim=0))
    # (E, C, D) expert-major send buffer
    sent = torch.einsum("tec,td->ecd", dispatch, x.float())
    # to the experts: (E, C, D) -> this rank's experts with slots from every
    # source rank, source-major: (E_local, N * C, D)
    received = all_to_all(sent, 0, 1, group)
    processed = expert_fn(expert_params, received)
    # back to the sources: (E_local, N * C, D) -> (E, C, D), as ``sent``
    returned = all_to_all(processed, 1, 0, group)
    out = torch.einsum("tec,ecd->td", combine, returned).to(x.dtype)
    return MoEOutput(out, aux_loss, dropped_fraction)


def stacked_expert_params(params_per_expert: List[Params]) -> Params:
    """Stack E per-expert parameter dicts on a leading expert axis; rank
    ``i`` keeps rows ``i * E_local .. (i + 1) * E_local - 1``."""
    return {name: torch.stack([p[name] for p in params_per_expert]) for name in params_per_expert[0]}
