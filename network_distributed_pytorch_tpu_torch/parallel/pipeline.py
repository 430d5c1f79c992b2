"""Pipeline parallelism over a ``pipe`` mesh axis, the JAX package's
``parallel/pipeline.py``: rank ``i`` of the axis holds only stage ``i``'s
parameters, and microbatches flow through the stages.

- :func:`pipeline_apply` is GPipe's forward, tick for tick the JAX scan:
  ``M + N - 1`` ticks, each applying every stage to the activation in hand
  and passing it right with :func:`..comm.ppermute`, then one sum over the
  axis replicates the last stage's output. Autograd differentiates it into
  the reversed pipeline. Every rank builds the same graph (the JAX
  ``where`` selections are ``torch.where`` on a condition tensor, so a
  branch that is not taken stays in the graph with a zero cotangent): the
  permutes' backward passes are collectives, and each rank must reach
  every one of them in the same order.
- :func:`make_pipeline_train_fn` is the 1F1B training schedule. JAX's is
  a lockstep scan (one forward and one backward unit an iteration) with
  hand-built VJPs; in PyTorch 1F1B is a per-stage schedule: stage ``s``
  runs ``S - s - 1`` warm-up forwards, then alternates one forward and one
  backward, then the cool-down backwards. Each microbatch keeps its own
  autograd graph, from the received activation (a fresh leaf) to the
  stage output (or the loss, on the last stage); activations go right and
  their gradients left by :func:`..comm.exchange`, each neighbour pair's
  send and receive posted in one ``batch_isend_irecv`` (Megatron's
  ``send_forward_recv_backward`` / ``send_backward_recv_forward``), and
  ``torch.autograd.backward(out, grad_tensors=received)`` closes each
  step. A stage holds at most ``S - s`` microbatch graphs, so activation
  memory is bounded by the depth, not the microbatch count.

Losses and gradients are the JAX schedule's: per-microbatch gradients
summed in microbatch order, then divided by ``M``; the loss the mean of the
last stage's microbatch losses, shared with every pipe rank by one
all-reduce. JAX's masked psums of the head gradients and the input
cotangent are not issued: those values are returned on the stage that owns
them (zeros elsewhere), and the caller sums what it needs replicated
(``models.gpt.make_gpt_pipeline_train_fn`` does, in one all-reduce).

``remat=True`` (the JAX package's ``jax.checkpoint`` of the stage
function) runs each stage call under a non-reentrant
``torch.utils.checkpoint`` (``models.layers.remat_call``): a GPipe tick or
a 1F1B microbatch then keeps only the stage's input and recomputes its
activations in the backward, with the same values and gradients.

Parameters are dicts of tensors. A train function never writes them: it
differentiates detached copies and returns the gradients, as ``jax.grad``
does. Gradients are this rank's own; the JAX function's
``params_varying_over``, which stops ``shard_map`` from summing them over
a data axis, has nothing to stop here.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..models.layers import remat_call
from .comm import all_reduce_sum, exchange, ppermute, reduce_from_axis, world_size

Params = Dict[str, torch.Tensor]


def _index(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _stage(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor], remat: bool):
    """``stage_fn``, each call checkpointed under ``remat``."""
    if not remat:
        return stage_fn
    return lambda p, a: remat_call(True, stage_fn, p, a)


def pipeline_apply(
    stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    stage_params: Params,
    x: torch.Tensor,
    group,
    num_microbatches: int,
    remat: bool = False,
) -> torch.Tensor:
    """Run ``x`` through the ``N`` stages of the ``pipe`` axis ``group``.

    ``stage_params`` is THIS rank's stage, ``x`` the full ``(B, ...)``
    batch (the same on every pipe rank), and the result the full
    ``(B, ...)`` output, the same on every rank. ``stage_fn(params, a)``
    keeps the activation's shape (homogeneous stages, e.g. transformer
    blocks); ``B % num_microbatches == 0``."""
    n = world_size(group)
    idx = _index(group)
    m = num_microbatches
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} must divide into {m} microbatches")
    micro = x.reshape((m, b // m) + tuple(x.shape[1:]))
    stage_fn = _stage(stage_fn, remat)
    # right shift without wraparound: stage 0 receives zeros
    perm = [(i, i + 1) for i in range(n - 1)]
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == n - 1, device=x.device)
    recv = torch.zeros_like(micro[0])
    acc: List[torch.Tensor] = [torch.zeros_like(micro[0]) for _ in range(m)]
    for t in range(m + n - 1):
        # stage 0 ingests microbatch t (clamped, and masked once t >= m)
        feed = torch.where(first & (t < m), micro[min(t, m - 1)], recv)
        y = stage_fn(stage_params, feed)
        # the last stage banks microbatch t - (n - 1)
        out_t = t - (n - 1)
        slot = min(max(out_t, 0), m - 1)
        acc[slot] = torch.where(last & (out_t >= 0), y, acc[slot])
        recv = ppermute(y, perm, group)
    out = torch.stack(acc)
    # replicate the last stage's output: the other ranks add zeros
    out = reduce_from_axis(torch.where(last, out, torch.zeros_like(out)), group)
    return out.reshape((b,) + tuple(x.shape[1:]))


def stacked_stage_params(params_per_stage: List[Params]) -> Params:
    """Stack N per-stage parameter dicts on a leading stage axis; stage
    ``i`` is row ``i``."""
    return {name: torch.stack([p[name] for p in params_per_stage]) for name in params_per_stage[0]}


def local_stage(stacked: Params, index: int) -> Params:
    """Row ``index`` of every leaf of a stacked dict: one stage's (or one
    layer's) parameters."""
    return {name: t[index] for name, t in stacked.items()}


def _leaves(params: Optional[Params]) -> Optional[Params]:
    """Detached copies that record their gradient (``jax.grad``'s inputs)."""
    if params is None:
        return None
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _grads(leaves: Params, m: int) -> Params:
    """The accumulated microbatch gradients over ``m`` (zeros where a leaf
    got none)."""
    return {k: (v.grad / m if v.grad is not None else torch.zeros_like(v)) for k, v in leaves.items()}


def make_pipeline_train_fn(
    stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    loss_fn: Callable[..., torch.Tensor],
    group,
    num_microbatches: int,
    loss_has_params: bool = False,
    return_input_grads: bool = False,
    remat: bool = False,
):
    """The 1F1B training schedule over the ``pipe`` axis ``group``.

    Returns ``fn(stage_params, x, labels) -> (loss, stage_grads)``: this
    rank's stage parameters, the full batch ``x`` and its ``labels`` (the
    same on every pipe rank), the mean microbatch loss (the same on every
    pipe rank) and this stage's gradients. ``loss_fn(y_mb, labels_mb)`` is
    a microbatch's mean loss.

    - ``loss_has_params=True``: ``loss_fn(loss_params, y_mb, labels_mb)``
      and ``fn(stage_params, loss_params, x, labels)`` also returns the
      loss parameters' gradients (a head, a final LayerNorm): real on the
      last stage, zeros on the others.
    - ``return_input_grads=True``: ``fn`` also returns ``dx``, the
      gradient of the loss with respect to the pipeline input ``x``
      (``(B, ...)``, each microbatch's part over ``M``): real on stage 0,
      zeros on the others; chain it through the embedding front.

    Output: ``(loss, stage_grads[, loss_param_grads][, dx])``."""
    m = num_microbatches
    stage_fn = _stage(stage_fn, remat)

    def fn(stage_params: Params, *rest):
        if loss_has_params:
            loss_params, x, labels = rest
        else:
            loss_params = None
            x, labels = rest
        n = world_size(group)
        s = _index(group)
        is_first, is_last = s == 0, s == n - 1
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} must divide into {m} microbatches")
        micro = x.reshape((m, b // m) + tuple(x.shape[1:]))
        micro_labels = labels.reshape((m, b // m) + tuple(labels.shape[1:]))
        params = _leaves(stage_params)
        lparams = _leaves(loss_params)
        act_shape, act_dtype = micro[0].shape, micro.dtype
        inputs: Dict[int, torch.Tensor] = {}
        outputs: Dict[int, torch.Tensor] = {}
        losses: List[torch.Tensor] = []
        dx = torch.zeros_like(micro) if return_input_grads else None
        counter = {"f": 0, "b": 0}

        def recv_forward():
            k = counter["f"]
            if is_first:
                return micro[k]
            buf = torch.empty(act_shape, dtype=act_dtype, device=x.device)
            exchange([], [(buf, s - 1)], group)
            return buf

        def forward_step(inp):
            k = counter["f"]
            counter["f"] += 1
            inp = inp.detach().requires_grad_(not is_first or return_input_grads)
            y = stage_fn(params, inp)
            inputs[k] = inp
            if is_last:
                args = (lparams, y, micro_labels[k]) if loss_has_params else (y, micro_labels[k])
                out = loss_fn(*args)
                losses.append(out.detach())
            else:
                out = y
            outputs[k] = out
            return y

        def backward_step(grad):
            k = counter["b"]
            counter["b"] += 1
            out, inp = outputs.pop(k), inputs.pop(k)
            torch.autograd.backward(out, grad_tensors=None if is_last else grad)
            if is_first:
                if return_input_grads:
                    dx[k] = inp.grad
                return None
            return inp.grad

        def act_buf():
            return torch.empty(act_shape, dtype=act_dtype, device=x.device)

        n_warm = min(n - s - 1, m)
        n_steady = m - n_warm
        for _ in range(n_warm):
            y = forward_step(recv_forward())
            exchange([(y, s + 1)], [], group)
        inp = recv_forward() if n_steady > 0 else None
        for i in range(n_steady):
            y = forward_step(inp)
            grad = None
            if not is_last:  # send this output, receive the gradient of the oldest
                grad = act_buf()
                exchange([(y, s + 1)], [(grad, s + 1)], group)
            d_in = backward_step(grad)
            sends = [] if is_first else [(d_in, s - 1)]
            recvs = []
            if i < n_steady - 1 and not is_first:  # and the next microbatch
                inp = act_buf()
                recvs = [(inp, s - 1)]
            exchange(sends, recvs, group)
            if i < n_steady - 1 and is_first:
                inp = recv_forward()
        for _ in range(n_warm):
            grad = act_buf()
            exchange([], [(grad, s + 1)], group)
            d_in = backward_step(grad)
            if not is_first:
                exchange([(d_in, s - 1)], [], group)

        # the mean microbatch loss, from the last stage to every pipe rank
        total = torch.stack(losses).sum() if is_last else torch.zeros((), device=x.device)
        loss = all_reduce_sum(total.reshape(1).float(), group)[0] / m
        outs = [loss, _grads(params, m)]
        if loss_has_params:
            outs.append(_grads(lparams, m))
        if return_input_grads:
            outs.append((dx / m).reshape((b,) + tuple(x.shape[1:])))
        return tuple(outs)

    return fn


def make_pipeline_fn(
    stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    group,
    num_microbatches: int,
    remat: bool = False,
) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """``fn(stage_params, x)``: :func:`pipeline_apply` with this rank's
    stage given as the JAX package's ``shard_map`` slice of stacked
    parameters, a leading axis of 1 on every leaf."""

    def fn(stage_params: Params, x: torch.Tensor) -> torch.Tensor:
        n = world_size(group)
        for name, leaf in stage_params.items():
            if leaf.shape[0] != 1:
                raise ValueError(
                    f"stage leaf {name} has {n * leaf.shape[0]} stages for {n} pipe ranks: one stage a rank"
                )
        return pipeline_apply(stage_fn, local_stage(stage_params, 0), x, group, num_microbatches, remat)

    return fn
