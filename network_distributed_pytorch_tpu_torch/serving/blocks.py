"""Host-side block-pool accounting for the paged KV cache (vLLM-style),
copied from the JAX package's ``serving/blocks.py``.

The device side of paged serving is a fixed pool of ``(n_blocks,
block_len, H, D)`` KV blocks plus per-slot block TABLES (``ops.paged``,
``models.gpt.gpt_decode_step_paged``); this module is the host side that
decides which physical block holds which logical tokens:

- :class:`BlockPool` — the free-list allocator with per-block REFCOUNTS.
  Physical block 0 is permanently reserved as the GARBAGE block: vacant
  table entries (and table padding past a request's reserved chain) point
  at it, so the one decode step can always gather/scatter through a
  full-shaped table — out-of-range writes land in block 0 and the
  position mask keeps its contents out of every softmax. Allocation and
  free are plain list ops on the host.
- :class:`PrefixIndex` — the prompt-hash prefix cache behind
  copy-on-write prefix sharing. Admission registers every FULL-BLOCK
  prefix of a prompt (plus the exact full prompt, with its greedy first
  token) against the slot's freshly-filled chain; a later request with a
  matching prefix LINKS those blocks (refcount++) instead of
  re-prefilling them. The index holds its own reference on every block it
  advertises, so a chain outlives the request that built it; under
  allocation pressure :meth:`PrefixIndex.evict_lru` releases the
  least-recently-used entries back to the pool (admission backpressure
  only queues a request when even a drained index cannot cover it).

The leak invariant the engine asserts after every tick
(:meth:`BlockPool.check_owners`): every non-garbage block is either on
the free list or referenced, the free count plus the DISTINCT referenced
blocks is exactly ``n_blocks - 1``, and each block's refcount equals its
multiplicity across the owner chains (slot chains + index entries) —
eviction that returned a block twice, or forgot one, fails loudly.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

GARBAGE_BLOCK = 0


class OutOfBlocks(RuntimeError):
    """The pool cannot cover an allocation — admission backpressure, not a
    crash: the caller leaves the request queued and retries after blocks
    free up."""


class BlockLeakError(AssertionError):
    """The refcount invariant broke: a block was freed twice, never freed,
    or its refcount disagrees with the chains that claim it."""


def blocks_needed(n_tokens: int, block_len: int) -> int:
    """Blocks covering ``n_tokens`` logical positions (ceil division)."""
    if n_tokens <= 0:
        return 0
    return -(-n_tokens // block_len)


def prefix_key(tokens: Sequence[int]) -> str:
    """Stable content hash of a token prefix (index key — identical
    prompts hash identically across processes and restarts)."""
    h = hashlib.sha1()
    h.update(" ".join(str(int(t)) for t in tokens).encode())
    return h.hexdigest()


class BlockPool:
    """Free-list allocator over ``n_blocks`` physical KV blocks with
    per-block refcounts. Block 0 (:data:`GARBAGE_BLOCK`) is never
    allocated; usable capacity is ``n_blocks - 1``."""

    def __init__(self, n_blocks: int, block_len: int):
        if n_blocks < 2:
            raise ValueError(
                f"pool needs >= 2 blocks (one is the garbage block),"
                f" got {n_blocks}"
            )
        if block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        self.n_blocks = n_blocks
        self.block_len = block_len
        # ascending pop order keeps allocation deterministic for tests
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._ref: List[int] = [0] * n_blocks

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_usable(self) -> int:
        return self.n_blocks - 1

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` blocks off the free list (refcount 1 each); raises
        :class:`OutOfBlocks` — taking nothing — when the pool can't cover
        the whole request (allocation is all-or-nothing, so a half-granted
        chain can never leak)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise OutOfBlocks(
                f"need {n} blocks, {len(self._free)} free"
                f" of {self.n_usable} usable"
            )
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def link(self, blocks: Iterable[int]) -> None:
        """Take an additional reference on already-allocated blocks (prefix
        sharing: a new request linking an existing chain)."""
        for b in blocks:
            if b == GARBAGE_BLOCK or self._ref[b] < 1:
                raise BlockLeakError(
                    f"link of block {b} with refcount {self._ref[b]}"
                )
            self._ref[b] += 1

    def release(self, blocks: Iterable[int]) -> List[int]:
        """Drop one reference per block; blocks reaching refcount 0 return
        to the free list. Returns the freed blocks. Double-free (releasing
        a block already at 0) raises — the exactly-once eviction
        accounting this PR's tests pin."""
        freed: List[int] = []
        for b in blocks:
            if b == GARBAGE_BLOCK:
                continue  # table padding; never a real reference
            if self._ref[b] < 1:
                raise BlockLeakError(
                    f"release of block {b} with refcount {self._ref[b]}"
                    " (double free)"
                )
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)
                freed.append(b)
        return freed

    def check_owners(self, owners: Iterable[Iterable[int]]) -> None:
        """The leak invariant: given every live chain (slot chains + index
        entries), verify free + Σ distinct referenced == usable blocks and
        that each block's refcount equals its multiplicity across owners.
        Raises :class:`BlockLeakError` with the discrepancy."""
        mult: Dict[int, int] = {}
        for chain in owners:
            for b in chain:
                if b == GARBAGE_BLOCK:
                    continue
                mult[b] = mult.get(b, 0) + 1
        free = set(self._free)
        if len(free) != len(self._free):
            raise BlockLeakError("free list contains duplicates")
        for b in range(1, self.n_blocks):
            expect = mult.get(b, 0)
            if self._ref[b] != expect:
                raise BlockLeakError(
                    f"block {b}: refcount {self._ref[b]} but"
                    f" {expect} owner reference(s)"
                )
            if (self._ref[b] == 0) != (b in free):
                raise BlockLeakError(
                    f"block {b}: refcount {self._ref[b]} but"
                    f" free={b in free}"
                )
        if len(free) + len(mult) != self.n_usable:
            raise BlockLeakError(
                f"free ({len(free)}) + referenced ({len(mult)})"
                f" != usable ({self.n_usable})"
            )


class PrefixIndex:
    """Prompt-hash index over already-filled block chains.

    One entry per registered token prefix: the physical chain holding its
    KV, the prefix length in tokens, and — for exact full-prompt entries —
    the greedy first token (so a fully-matching admission needs ZERO
    forward passes). The index owns one reference per block per entry;
    :meth:`evict_lru` is the pressure valve."""

    def __init__(self, pool: BlockPool):
        self.pool = pool
        # key -> (blocks, n_tokens, first_token or None, last_use tick)
        self._entries: Dict[str, Dict] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def chains(self) -> List[List[int]]:
        """Every entry's chain — the index's side of the leak invariant."""
        return [list(e["blocks"]) for e in self._entries.values()]

    def register(
        self,
        prompt: Sequence[int],
        chain: Sequence[int],
        first_token: Optional[int] = None,
    ) -> int:
        """Advertise a freshly-prefilled prompt: one entry per FULL-BLOCK
        prefix (shareable at block granularity) plus the exact full prompt
        (shareable outright, first token included — the trailing partial
        block rides along and copy-on-write protects it). Existing keys are
        kept (first writer wins; identical content either way). Returns the
        number of new entries."""
        L = self.pool.block_len
        added = 0
        lengths = [k * L for k in range(1, len(prompt) // L + 1)]
        if not lengths or lengths[-1] != len(prompt):
            lengths.append(len(prompt))
        for n_tok in lengths:
            key = prefix_key(prompt[:n_tok])
            if key in self._entries:
                continue
            blocks = list(chain[: blocks_needed(n_tok, L)])
            self.pool.link(blocks)
            self._entries[key] = {
                "blocks": blocks,
                "n_tokens": n_tok,
                "first_token": (
                    int(first_token)
                    if (n_tok == len(prompt) and first_token is not None)
                    else None
                ),
                "last_use": self._tick,
            }
            added += 1
        self._tick += 1
        return added

    def lookup(self, prompt: Sequence[int]) -> Optional[Dict]:
        """Longest usable match for ``prompt``: the exact full prompt
        first, then full-block prefixes longest-first. Returns
        ``{"blocks", "n_tokens", "first_token"}`` (first_token only on an
        exact match) or None. Counts a hit/miss either way."""
        self._tick += 1
        L = self.pool.block_len
        lengths = [len(prompt)] + [
            k * L for k in range(len(prompt) // L, 0, -1)
        ]
        seen = set()
        for n_tok in lengths:
            if n_tok in seen or n_tok == 0:
                continue
            seen.add(n_tok)
            entry = self._entries.get(prefix_key(prompt[:n_tok]))
            if entry is None or entry["n_tokens"] != n_tok:
                continue
            entry["last_use"] = self._tick
            self.hits += 1
            return {
                "blocks": list(entry["blocks"]),
                "n_tokens": n_tok,
                "first_token": (
                    entry["first_token"] if n_tok == len(prompt) else None
                ),
            }
        self.misses += 1
        return None

    def evict_lru(self, n_blocks_wanted: int) -> int:
        """Release least-recently-used entries until the pool has
        ``n_blocks_wanted`` free (or the index is empty). Returns blocks
        actually freed — entries whose blocks are still linked by live
        requests release the index's reference without freeing device
        memory yet."""
        freed = 0
        by_age = sorted(
            self._entries.items(), key=lambda kv: kv[1]["last_use"]
        )
        for key, entry in by_age:
            if self.pool.n_free >= n_blocks_wanted:
                break
            freed += len(self.pool.release(entry["blocks"]))
            del self._entries[key]
        return freed

    def clear(self) -> int:
        """Drop every entry (engine shutdown); returns blocks freed."""
        freed = 0
        for entry in self._entries.values():
            freed += len(self.pool.release(entry["blocks"]))
        self._entries.clear()
        return freed
