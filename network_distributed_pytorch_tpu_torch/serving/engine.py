"""Continuous-batching decode engines, the JAX package's
``serving/engine.py`` on torch tensors.

Iteration-level batching (Orca, OSDI '22): an engine owns ``n_slots``
batch slots over one KV cache and schedules at decode-step granularity.
After every one-token step, finished requests free their slots and the
queue refills them, so short requests never wait for long ones to pad out
(``padded_static_decode_steps`` is the foil the tests count against).

- :class:`SlotEngine`: a dense ``(S, max_len, ...)`` cache, one decode
  step a tick (``models.gpt.gpt_decode_step_slots``, a position per row,
  so requests at different depths share it; a vacant slot ticks a dummy
  row whose output is dropped) and one prefill an admission at the
  engine's ``max_len``, the shapes of a sequential
  ``generate(cache_len=max_len)``.
- :class:`PagedEngine`: the same scheduler over a block pool with host
  block tables (``serving.blocks``), copy-on-write prefix sharing and
  draft-verify speculative decoding; same-shape tokens are the slot
  engine's bit for bit.

Greedy decoding only (temperature 0), as in the reference: the engines'
tokens are held to a sequential reference. Each tick reads its tokens on
the host (one sync a tick), as the JAX engine does. The engines take the
model on ``device`` (the card unless the caller asks for the CPU) and any
``telemetry`` with ``emit(event)``. In a bf16 model the weights are cast
once (``models.gpt.weights_cast_once``), as ``generate`` does: the
logits are the same bits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..models.gpt import (
    GPTLM,
    gpt_decode_step_paged,
    gpt_decode_step_slots,
    gpt_prefill,
    gpt_prefill_shared,
    weights_cast_once,
)
from ..observe.events import KVPoolEvent
from ..observe.memory import tree_bytes
from ..ops.paged import copy_block
from ..parallel.mesh import resolve_device
from .blocks import BlockPool, OutOfBlocks, PrefixIndex, blocks_needed
from .cache import init_block_pool, init_slot_cache, read_chain, write_chain, write_slot
from .request import Request


def padded_static_decode_steps(decode_lengths: Sequence[int], batch: int) -> int:
    """Decode ticks a PADDED STATIC batching scheduler spends on the same
    workload: requests grouped in arrival order into batches of ``batch``,
    each group decoding in lockstep to its LONGEST member (prefill yields
    each request's first token, so a group of max length L pays L-1 ticks).
    The continuous engine's ``decode_steps`` is <= this for any workload,
    strictly < whenever lengths are unequal across a group boundary."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    total = 0
    lengths = list(decode_lengths)
    for i in range(0, len(lengths), batch):
        group = lengths[i : i + batch]
        total += max(0, max(group) - 1)
    return total


def spec_accept(
    fed: Sequence[int],
    outs: Sequence[int],
    budget_left: int,
    eos_token_id: Optional[int] = None,
) -> List[int]:
    """Bitwise-accept rule for one speculative verify round of one row.

    ``fed[i]`` is the token the target was FED at step ``i`` of the round
    (``fed[0]`` is the row's already-emitted pending token, ``fed[1:]`` the
    draft's proposals); ``outs[i]`` is the target's greedy token after
    feeding ``fed[i]``. The emitted tokens are exactly the prefix a
    target-only decode would have produced: ``outs[i]`` is trustworthy iff
    every earlier fed token matched the target's own output — the first
    draft token that diverges (``fed[i+1] != outs[i]``) still yields the
    CORRECTED token ``outs[i]``, then the round stops. A fully-matching
    round emits all K tokens (K-1 drafts plus the bonus token from the last
    verify step). Capped at ``budget_left`` and truncated after EOS.
    """
    emitted: List[int] = []
    for i in range(len(fed)):
        tok = int(outs[i])
        emitted.append(tok)
        if len(emitted) >= budget_left:
            break
        if eos_token_id is not None and tok == eos_token_id:
            break
        if i + 1 < len(fed) and int(fed[i + 1]) != tok:
            break
    return emitted


def _serving_model(model: GPTLM, max_len: int, device) -> tuple:
    """``(model with its weights cast once, device)``; raises where the
    model does not fit ``max_len`` or its weights are not on ``device``."""
    device = resolve_device(device)
    if max_len > model.config.max_position_embeddings:
        raise ValueError(
            f"max_len {max_len} exceeds max_position_embeddings {model.config.max_position_embeddings}"
        )
    if model.wte.weight.device != device:
        raise ValueError(f"the model's weights are on {model.wte.weight.device}, the engine runs on {device}")
    return weights_cast_once(model), device


class _Engine:
    """The queue surface both engines share: submit, the occupancy
    properties, ``take_finished``, ``run`` and the terminal events."""

    def __init__(self, n_slots: int, telemetry: Any, rank: Optional[int], label: str, clock: Callable[[], float]):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.telemetry = telemetry
        self.rank = rank
        self.label = label
        self.clock = clock
        self.slots: List[Any] = [None] * n_slots
        self.queue: List[Request] = []
        self._finished: List[Request] = []
        self.decode_steps = 0
        self.prefills = 0
        # the most requests in flight at once (the paged engine's capacity claim)
        self.peak_active = 0

    def submit(self, request: Request) -> None:
        request.mark_enqueued(self.clock())
        self.queue.append(request)

    @property
    def n_free(self) -> int:
        return sum(1 for s in self.slots if s is None)

    @property
    def n_active(self) -> int:
        return self.n_slots - self.n_free

    @property
    def queue_len(self) -> int:
        return len(self.queue)

    @property
    def idle(self) -> bool:
        return not self.queue and self.n_active == 0

    def take_finished(self) -> List[Request]:
        out, self._finished = self._finished, []
        return out

    def _emit(self, request: Request) -> None:
        if self.telemetry is not None:
            self.telemetry.emit(request.event(label=self.label, rank=self.rank))

    def _terminal(self, request: Request) -> None:
        self._emit(request)
        self._finished.append(request)

    def _evict_queue(self, now: float, reason: str) -> List[Request]:
        evicted = []
        for request in self.queue:
            request.evict(now, reason=reason)
            self._emit(request)
            evicted.append(request)
        self.queue = []
        return evicted

    def _long(self, values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=torch.long, device=self.device)

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drain everything submitted so far; returns the finished
        requests. ``max_steps`` bounds the iteration count."""
        steps = 0
        while not self.idle:
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"engine did not drain within {max_steps} steps"
                    f" ({self.n_active} active, {self.queue_len} queued)"
                )
            self.step()
            steps += 1
        return self.take_finished()


@dataclass
class _Slot:
    """Host-side per-slot decode state: the occupying request, the token
    to feed next, and the cache position it lands at."""

    request: Request
    pending_token: int
    pos: int


class SlotEngine(_Engine):
    """Decode-step-granular scheduler over ``n_slots`` static batch slots.

    Drive it with :meth:`submit` + :meth:`step` (one iteration: backfill
    free slots from the queue, then one slot-batched decode tick), or
    :meth:`run` to drain everything submitted. Terminal requests emit one
    ``RequestEvent`` each through ``telemetry`` and are collected for
    :meth:`take_finished`.
    """

    def __init__(
        self,
        model: GPTLM,
        n_slots: int,
        max_len: int,
        device="cuda",
        telemetry: Any = None,
        rank: Optional[int] = None,
        label: str = "serving",
        clock: Callable[[], float] = time.monotonic,
    ):
        super().__init__(n_slots, telemetry, rank, label, clock)
        self.model, self.device = _serving_model(model, max_len, device)
        self.config = model.config
        self.max_len = max_len
        self.cache = init_slot_cache(self.config, n_slots, max_len, device=self.device)

    def _admit_one(self, slot_index: int, request: Request) -> None:
        request.mark_prefilling(self.clock())
        # a fresh batch-1 prefill at the ENGINE's cache capacity: the shapes
        # of a sequential generate(cache_len=max_len)
        last_logits, row_cache = gpt_prefill(self.model, self._long([request.prompt]), self.max_len)
        write_slot(self.cache, row_cache, slot_index)
        first = int(last_logits[0].argmax())
        self.prefills += 1
        request.mark_decoding(self.clock())  # the first token exists as of prefill end
        request.add_token(first)
        if request.done:
            request.finish(self.clock())
            self._terminal(request)
            return
        self.slots[slot_index] = _Slot(request=request, pending_token=first, pos=len(request.prompt))

    def _backfill(self) -> None:
        """Every free slot takes the oldest queued request (FIFO, the order
        the padded-static comparison assumes)."""
        for s in range(self.n_slots):
            if not self.queue:
                return
            if self.slots[s] is None:
                self._admit_one(s, self.queue.pop(0))

    def step(self) -> bool:
        """Backfill freed slots, then one slot-batched decode tick over the
        occupied slots. Returns True when any work happened."""
        before = self.prefills
        self._backfill()
        self.peak_active = max(self.peak_active, self.n_active)
        occupied = [s for s in range(self.n_slots) if self.slots[s] is not None]
        if not occupied:
            return self.prefills != before
        tokens = [slot.pending_token if slot is not None else 0 for slot in self.slots]
        pos = [slot.pos if slot is not None else 0 for slot in self.slots]
        logits, _ = gpt_decode_step_slots(self.model, self.cache, self._long(tokens), self._long(pos))
        self.decode_steps += 1
        nxt = logits.argmax(-1).tolist()
        now = self.clock()
        for s in occupied:
            slot = self.slots[s]
            slot.request.add_token(nxt[s])
            if slot.request.done:
                slot.request.finish(now)
                self._terminal(slot.request)
                self.slots[s] = None  # freed; the next step() backfills it
            else:
                slot.pending_token = nxt[s]
                slot.pos += 1
        return True

    def evict_all(self, reason: str = "shutdown") -> List[Request]:
        """Evict every queued and in-flight request: each emits a terminal
        ``evicted`` event, and the list returned is what a fail-over path
        re-queues elsewhere (``Request.reset_for_requeue``)."""
        now = self.clock()
        evicted = self._evict_queue(now, reason)
        for s, slot in enumerate(self.slots):
            if slot is None:
                continue
            slot.request.evict(now, reason=reason)
            self._emit(slot.request)
            evicted.append(slot.request)
            self.slots[s] = None
        return evicted

    @property
    def cache_bytes(self) -> int:
        """Device bytes of the whole slot cache, allocated for the engine's
        lifetime whatever the occupancy."""
        return tree_bytes(self.cache)

    @property
    def occupied_cache_bytes(self) -> int:
        """The active slots' share of the cache."""
        return (self.cache_bytes * self.n_active) // self.n_slots

    def stats(self) -> Dict:
        return {
            "n_slots": self.n_slots,
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "active": self.n_active,
            "queued": self.queue_len,
            "peak_active": self.peak_active,
            "kv_cache_bytes": self.cache_bytes,
            "kv_occupied_bytes": self.occupied_cache_bytes,
        }


@dataclass
class _PagedSlot:
    """Per-slot decode state for the paged engine: the dense fields plus
    this request's block chain (the slot's one reference on each entry)
    and the copy-on-write spare reserved at admission."""

    request: Request
    pending_token: int
    pos: int
    chain: List[int]
    spare: List[int] = field(default_factory=list)


class PagedEngine(_Engine):
    """:class:`SlotEngine`'s scheduler over a PAGED block-pool KV cache.

    Same queue/step/run/evict surface and the same tokens: decode goes
    through ``gpt_decode_step_paged``, whose valid positions carry the
    dense step's values. KV memory is a fixed pool of ``n_blocks`` blocks
    of ``block_len`` tokens, reserved per request at
    ``ceil((len(prompt) + max_new) / block_len)`` blocks instead of a dense
    ``max_len`` row a slot; the block tables live on the host (one
    ``(n_slots, max_len // block_len)`` array sent a tick).

    - **Prefix sharing** (``prefix_sharing=True``): a prompt-hash index
      (``serving.blocks.PrefixIndex``) maps prefilled prompts and their
      block-aligned prefixes to live chains. An exact full-prompt hit
      admits with no device work (blocks linked, the greedy first token
      replayed from the index); a block-aligned prefix hit links the
      prefix chain and prefills only the suffix (``gpt_prefill_shared``).
      A slot's first decode write into a still-shared block copies it into
      the spare reserved at admission (copy-on-write, before the write and
      with the table pointed at the copy before the step runs).
    - **Speculative decoding** (``spec_k >= 2`` with a draft model): the
      draft, over a dense slot cache, proposes ``spec_k - 1`` greedy
      tokens a round in ``spec_k`` steps; the target verifies them in
      ``spec_k`` steps of the same paged step function, and
      :func:`spec_accept` keeps exactly the prefix a target-only decode
      would have emitted. No sync between the steps of a round.
    - **Leak accounting**: with ``check_leaks`` (default ``__debug__``) the
      engine re-proves ``free + distinct chain entries == usable blocks``
      and every block's refcount after each tick, admission and eviction.

    Out-of-blocks admission is backpressure, not failure: the request
    stays at the head of the queue (FIFO) until blocks free up, after the
    prefix index's least recently used entries are released.
    """

    def __init__(
        self,
        model: GPTLM,
        n_slots: int,
        max_len: int,
        block_len: int = 16,
        n_blocks: Optional[int] = None,
        prefix_sharing: bool = True,
        draft_model: Optional[GPTLM] = None,
        spec_k: int = 0,
        device="cuda",
        telemetry: Any = None,
        rank: Optional[int] = None,
        label: str = "serving",
        clock: Callable[[], float] = time.monotonic,
        check_leaks: Optional[bool] = None,
        emit_pool_every: int = 16,
    ):
        super().__init__(n_slots, telemetry, rank, label, clock)
        if max_len % block_len != 0:
            raise ValueError(f"max_len {max_len} must be a multiple of block_len {block_len}")
        if spec_k and (spec_k < 2 or draft_model is None):
            raise ValueError("speculative decoding needs spec_k >= 2 and a draft_model")
        self.model, self.device = _serving_model(model, max_len, device)
        self.config = model.config
        self.max_len = max_len
        self.block_len = block_len
        self.max_blocks = max_len // block_len
        # default pool: the dense cache's bytes (+ the garbage block)
        self.n_blocks = n_blocks if n_blocks is not None else n_slots * self.max_blocks + 1
        self.prefix_sharing = prefix_sharing
        self.check_leaks = bool(__debug__) if check_leaks is None else check_leaks
        self.emit_pool_every = emit_pool_every

        self.pool = init_block_pool(self.config, self.n_blocks, block_len, device=self.device)
        self.allocator = BlockPool(self.n_blocks, block_len)
        self.index = PrefixIndex(self.allocator) if prefix_sharing else None
        self._tables = np.zeros((n_slots, self.max_blocks), np.int64)

        self.prefill_tokens = 0
        self.prefix_hits = 0
        self.prefill_tokens_saved = 0
        self.cow_copies = 0
        self.admissions_deferred = 0
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0

        self.spec_k = int(spec_k)
        if self.spec_k:
            self.draft_model = self.model if draft_model is model else _serving_model(draft_model, max_len, device)[0]
            self.draft_cache = init_slot_cache(draft_model.config, n_slots, max_len, device=self.device)

    # --- block accounting -------------------------------------------------

    def _owner_chains(self) -> List[List[int]]:
        chains: List[List[int]] = []
        for slot in self.slots:
            if slot is not None:
                chains.append(slot.chain)
                if slot.spare:
                    chains.append(slot.spare)
        if self.index is not None:
            chains.extend(self.index.chains())
        return chains

    def _assert_no_leaks(self) -> None:
        if self.check_leaks:
            self.allocator.check_owners(self._owner_chains())

    def _release_slot(self, slot_index: int) -> None:
        """Free a slot's blocks exactly once: one release per chain entry
        (shared entries drop to the survivors' refcount, private ones go
        back to the free list) plus the unused copy-on-write spare."""
        slot = self.slots[slot_index]
        self.allocator.release(slot.chain)
        if slot.spare:
            self.allocator.release(slot.spare)
        self._tables[slot_index, :] = 0
        self.slots[slot_index] = None

    def _padded_chain(self, chain: List[int]) -> torch.Tensor:
        return self._long(chain + [0] * (self.max_blocks - len(chain)))

    # --- admission --------------------------------------------------------

    def _reserve(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` blocks, releasing prefix-index entries under
        pressure; None when the pool cannot cover it (backpressure)."""
        if self.allocator.n_free < n and self.index is not None:
            self.index.evict_lru(n)
        try:
            return self.allocator.alloc(n)
        except OutOfBlocks:
            return None

    def _prefill_full(self, prompt: List[int], chain: List[int]) -> int:
        last_logits, row_cache = gpt_prefill(self.model, self._long([prompt]), self.max_len)
        write_chain(self.pool, row_cache, self._padded_chain(chain))
        return int(last_logits[0].argmax())

    def _prefill_shared(self, suffix: List[int], prefix_blocks: List[int], suffix_chain: List[int]) -> int:
        prefix_cache = read_chain(self.pool, prefix_blocks)
        last_logits, suffix_cache = gpt_prefill_shared(self.model, self._long([suffix]), prefix_cache)
        pad = len(suffix_chain) * self.block_len - len(suffix)
        padded = [{name: F.pad(t, (0, 0, 0, 0, 0, pad)) for name, t in layer.items()} for layer in suffix_cache]
        write_chain(self.pool, padded, self._long(suffix_chain))
        return int(last_logits[0].argmax())

    def _admit_one(self, slot_index: int, request: Request) -> bool:
        """Admit ``request`` into ``slot_index``; False = not enough free
        blocks (the request stays at the head of the queue)."""
        prompt = request.prompt
        t = len(prompt)
        horizon = min(t + request.max_new_tokens, self.max_len)
        need_total = blocks_needed(horizon, self.block_len)
        # a shared (or to-be-shared) trailing prompt block means the first
        # decode write will copy-on-write: reserve the spare now, so that
        # copy-on-write never meets an empty pool mid-decode
        spare_needed = 1 if (self.prefix_sharing and t % self.block_len != 0) else 0

        hit = self.index.lookup(prompt) if self.index is not None else None
        exact = hit is not None and hit["n_tokens"] == t and hit["first_token"] is not None
        prefix_blocks: List[int] = []
        p_len = 0
        if hit is not None and not exact:
            # a block-aligned prefix; a whole-prompt match with no first
            # token falls back to its last full block (the suffix prefill
            # needs at least one query token)
            p_len = min(hit["n_tokens"], t - 1) // self.block_len * self.block_len
            prefix_blocks = hit["blocks"][: p_len // self.block_len]

        if exact:
            shared = hit["blocks"]
            grant = self._reserve(need_total - len(shared) + spare_needed)
            if grant is None:
                return False
            self.allocator.link(shared)
            spare = grant[:spare_needed]
            chain = shared + grant[spare_needed:]
            request.mark_prefilling(self.clock())
            first = int(hit["first_token"])
            self.prefix_hits += 1
            self.prefill_tokens_saved += t
        elif prefix_blocks:
            grant = self._reserve(need_total - len(prefix_blocks))
            if grant is None:
                return False
            self.allocator.link(prefix_blocks)
            spare = []  # the boundary block is the suffix's own
            chain = prefix_blocks + grant
            request.mark_prefilling(self.clock())
            first = self._prefill_shared(prompt[p_len:], prefix_blocks, grant)
            self.prefills += 1
            self.prefill_tokens += t - p_len
            self.prefix_hits += 1
            self.prefill_tokens_saved += p_len
        else:
            grant = self._reserve(need_total + spare_needed)
            if grant is None:
                return False
            spare = grant[:spare_needed]
            chain = grant[spare_needed:]
            request.mark_prefilling(self.clock())
            first = self._prefill_full(prompt, chain)
            self.prefills += 1
            self.prefill_tokens += t
            if self.index is not None:
                self.index.register(prompt, chain, first_token=first)

        if self.spec_k:
            # the draft keeps its own dense cache and always prefills, even
            # where the target's prefill was shared away
            _, row_cache = gpt_prefill(self.draft_model, self._long([prompt]), self.max_len)
            write_slot(self.draft_cache, row_cache, slot_index)

        request.mark_decoding(self.clock())  # the first token exists as of admission end
        request.add_token(first)
        if request.done:
            request.finish(self.clock())
            self._terminal(request)
            # the blocks never reached a table; give the reservation back
            self.allocator.release(chain)
            if spare:
                self.allocator.release(spare)
            return True
        self.slots[slot_index] = _PagedSlot(request=request, pending_token=first, pos=t, chain=chain, spare=spare)
        self._tables[slot_index, :] = 0
        self._tables[slot_index, : len(chain)] = chain
        return True

    def _backfill(self) -> None:
        """FIFO backfill with block backpressure: the oldest queued request
        admits first or nobody does, so later (smaller) requests cannot
        starve it."""
        for s in range(self.n_slots):
            if not self.queue:
                break
            if self.slots[s] is None:
                if not self._admit_one(s, self.queue[0]):
                    self.admissions_deferred += 1
                    break
                self.queue.pop(0)
        self._assert_no_leaks()

    # --- copy-on-write ----------------------------------------------------

    def _cow_if_shared(self, slot_index: int, pos_lo: int, pos_hi: int) -> None:
        """Before writing positions ``pos_lo..pos_hi``, copy every touched
        chain block that is still shared (refcount > 1) into this slot's
        spare and point the table at the copy."""
        slot = self.slots[slot_index]
        lo = pos_lo // self.block_len
        hi = min(pos_hi // self.block_len, len(slot.chain) - 1)
        for j in range(lo, hi + 1):
            src = slot.chain[j]
            if self.allocator.refcount(src) <= 1:
                continue
            if slot.spare:
                dst = slot.spare.pop()
            else:
                grant = self._reserve(1)
                if grant is None:
                    raise OutOfBlocks("copy-on-write with no spare and an empty pool: admission under-reserved")
                dst = grant[0]
            for layer in self.pool:
                for buf in layer.values():
                    copy_block(buf, src, dst)
            self.allocator.release([src])
            slot.chain[j] = dst
            self._tables[slot_index, j] = dst
            self.cow_copies += 1

    # --- decode -----------------------------------------------------------

    def _finish_or_advance(self, s: int, emitted: List[int], now: float) -> None:
        slot = self.slots[s]
        for tok in emitted:
            slot.request.add_token(tok)
        if slot.request.done:
            slot.request.finish(now)
            self._terminal(slot.request)
            self._release_slot(s)
        else:
            slot.pending_token = emitted[-1]
            slot.pos += len(emitted)

    def _propose(self, start: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """The draft's ``spec_k`` greedy steps: step ``i`` feeds the previous
        token at ``pos + i`` (the last proposal is fed too, so its K/V is in
        the draft cache for the next round). Returns ``fed`` ``(S, K)``: the
        pending tokens and the first ``K - 1`` proposals."""
        tok, outs = start, []
        for i in range(self.spec_k):
            logits, _ = gpt_decode_step_slots(self.draft_model, self.draft_cache, tok, pos + i)
            tok = logits.argmax(-1)
            outs.append(tok)
        return torch.stack([start, *outs[:-1]], dim=1)

    def _verify(self, tables: torch.Tensor, fed: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """The target's ``spec_k`` steps over the fed tokens, each the
        engine's one-token paged step, so each step's bits are a plain
        tick's. Returns its greedy tokens ``(S, K)``."""
        outs = []
        for i in range(self.spec_k):
            logits, _ = gpt_decode_step_paged(self.model, self.pool, tables, fed[:, i], pos + i)
            outs.append(logits.argmax(-1))
        return torch.stack(outs, dim=1)

    def step(self) -> bool:
        """Backfill freed slots, then one decode tick: a one-token batched
        step, or a draft-and-verify round emitting up to ``spec_k`` tokens
        a row."""
        before_prefills = self.prefills
        self._backfill()
        self.peak_active = max(self.peak_active, self.n_active)
        occupied = [s for s in range(self.n_slots) if self.slots[s] is not None]
        if not occupied:
            return self.prefills != before_prefills
        span = self.spec_k if self.spec_k else 1
        for s in occupied:
            self._cow_if_shared(s, self.slots[s].pos, self.slots[s].pos + span - 1)
        tokens = self._long([slot.pending_token if slot is not None else 0 for slot in self.slots])
        pos = self._long([slot.pos if slot is not None else 0 for slot in self.slots])
        tables = self._long(self._tables)
        if self.spec_k:
            fed = self._propose(tokens, pos)
            outs = self._verify(tables, fed, pos)
            self.decode_steps += 1
            self.spec_rounds += 1
            fed, outs = torch.stack([fed, outs]).tolist()
            now = self.clock()
            for s in occupied:
                slot = self.slots[s]
                budget = slot.request.max_new_tokens - len(slot.request.tokens)
                emitted = spec_accept(fed[s], outs[s], budget, slot.request.eos_token_id)
                self.spec_proposed += self.spec_k - 1
                self.spec_accepted += max(0, len(emitted) - 1)
                self._finish_or_advance(s, emitted, now)
        else:
            logits, _ = gpt_decode_step_paged(self.model, self.pool, tables, tokens, pos)
            self.decode_steps += 1
            nxt = logits.argmax(-1).tolist()
            now = self.clock()
            for s in occupied:
                self._finish_or_advance(s, [nxt[s]], now)
        self._assert_no_leaks()
        if self.idle and self.emit_pool_every:
            # the drain boundary: a workload shorter than emit_pool_every
            # ticks would otherwise leave no pool snapshot
            self._emit_pool()
        else:
            self._maybe_emit_pool()
        return True

    def evict_all(self, reason: str = "shutdown") -> List[Request]:
        """Evict every queued and in-flight request, returning each
        in-flight request's blocks to the free list exactly once (the
        refcount invariant is proven again afterwards) and dropping the
        prefix index's references, so the pool drains to fully free."""
        now = self.clock()
        evicted = self._evict_queue(now, reason)
        for s, slot in enumerate(self.slots):
            if slot is None:
                continue
            slot.request.evict(now, reason=reason)
            self._emit(slot.request)
            evicted.append(slot.request)
            self._release_slot(s)
        if self.index is not None:
            self.index.clear()
        self._assert_no_leaks()
        self._emit_pool()
        return evicted

    # --- memory + telemetry -----------------------------------------------

    @property
    def pool_bytes(self) -> int:
        """Device bytes of the whole block pool, fixed for the engine's
        lifetime (the paged counterpart of ``SlotEngine.cache_bytes``)."""
        return tree_bytes(self.pool)

    @property
    def cache_bytes(self) -> int:
        return self.pool_bytes

    @property
    def occupied_cache_bytes(self) -> int:
        """Bytes of the blocks the admitted requests hold."""
        used = self.allocator.n_usable - self.allocator.n_free
        return (self.pool_bytes * used) // self.n_blocks

    def kv_stats(self) -> Dict:
        shared = sum(1 for b in range(1, self.n_blocks) if self.allocator.refcount(b) > 1)
        return {
            "n_blocks": self.n_blocks,
            "block_len": self.block_len,
            "blocks_free": self.allocator.n_free,
            "blocks_used": self.allocator.n_usable - self.allocator.n_free,
            "blocks_shared": shared,
            "pool_bytes": self.pool_bytes,
            "prefix_hits_total": self.prefix_hits,
            "prefill_tokens_saved_total": self.prefill_tokens_saved,
            "cow_copies_total": self.cow_copies,
            "admissions_deferred_total": self.admissions_deferred,
        }

    def _emit_pool(self) -> None:
        if self.telemetry is not None:
            self.telemetry.emit(KVPoolEvent(label=self.label, rank=self.rank, **self.kv_stats()))

    def _maybe_emit_pool(self) -> None:
        if self.telemetry is not None and self.emit_pool_every and self.decode_steps % self.emit_pool_every == 0:
            self._emit_pool()

    def stats(self) -> Dict:
        out = {
            "n_slots": self.n_slots,
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "prefill_tokens": self.prefill_tokens,
            "active": self.n_active,
            "queued": self.queue_len,
            "peak_active": self.peak_active,
            "kv_cache_bytes": self.pool_bytes,
            "kv_occupied_bytes": self.occupied_cache_bytes,
        }
        out.update(self.kv_stats())
        if self.spec_k:
            out.update(
                {
                    "spec_k": self.spec_k,
                    "spec_rounds": self.spec_rounds,
                    "spec_proposed": self.spec_proposed,
                    "spec_accepted": self.spec_accepted,
                    "spec_accept_rate": self.spec_accepted / self.spec_proposed if self.spec_proposed else 0.0,
                }
            )
        return out
