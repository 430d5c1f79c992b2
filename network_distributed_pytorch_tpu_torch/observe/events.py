"""Typed telemetry events of the serving engine, copied from the JAX
package's ``observe/events.py``: the :class:`Event` base and the two
records a serving engine emits, with the same ``record()`` dictionaries.

A sink is any object with ``emit(event)``; the engines call it with one
:class:`RequestEvent` per request that leaves them and, for the paged
engine, :class:`KVPoolEvent` snapshots of its block pool.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import ClassVar, Dict, Optional, Tuple

SCHEMA_VERSION = 1


@dataclass
class Event:
    """Base event: ``record()`` is the structured form (``{"event": <kind>,
    ...}``); ``_not_recorded`` lists fields kept out of it."""

    KIND: ClassVar[str] = "event"
    STAMP_TS: ClassVar[bool] = True
    _not_recorded: ClassVar[Tuple[str, ...]] = ()

    def record(self) -> Dict:
        out: Dict = {"event": self.KIND}
        for f in dataclasses.fields(self):
            if f.name in self._not_recorded:
                continue
            out[f.name] = getattr(self, f.name)
        return out

    def banner(self) -> Optional[str]:
        return None


@dataclass
class RequestEvent(Event):
    """Terminal record of one serving request, emitted once when it leaves
    the engine (``state`` is ``finished``, ``evicted`` or ``failed``), with
    its latency split: ``queue_s`` (submit to admission), ``prefill_s``
    (prompt forward and first token), ``decode_s`` (first token to last)
    and ``total_s`` (submit to terminal), the token counts, and
    ``requeues``, the times a dead rank's spool claim was handed to a
    survivor. Durations are on the engine's monotonic clock."""

    KIND: ClassVar[str] = "request"

    request_id: str
    state: str  # finished | evicted | failed
    label: str = "serving"
    rank: Optional[int] = None
    prompt_tokens: int = 0
    tokens_generated: int = 0
    queue_s: Optional[float] = None
    prefill_s: Optional[float] = None
    decode_s: Optional[float] = None
    total_s: Optional[float] = None
    requeues: int = 0
    reason: str = ""


@dataclass
class KVPoolEvent(Event):
    """A snapshot of the paged engine's block pool: free, used and shared
    blocks of the fixed ``n_blocks``, the pool's device bytes, and the
    engine-lifetime totals of prefix hits, prefill tokens saved by sharing,
    copy-on-write copies and admissions deferred for want of blocks."""

    KIND: ClassVar[str] = "kv_pool"

    n_blocks: int
    block_len: int = 0
    blocks_free: int = 0
    blocks_used: int = 0
    blocks_shared: int = 0
    pool_bytes: int = 0
    prefix_hits_total: int = 0
    prefill_tokens_saved_total: int = 0
    cow_copies_total: int = 0
    admissions_deferred_total: int = 0
    rank: Optional[int] = None
    label: str = ""
