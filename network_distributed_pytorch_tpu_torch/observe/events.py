"""Typed telemetry events, copied from the JAX package's
``observe/events.py``: the :class:`Event` base, the two records a serving
engine emits, and the failure-domain and note events of the checkpointed
training loop, with the same ``record()`` dictionaries.

A sink is any object with ``emit(event)``; the engines call it with one
:class:`RequestEvent` per request that leaves them and, for the paged
engine, :class:`KVPoolEvent` snapshots of its block pool. The checkpoint
layer and ``resilient_train_loop`` emit :class:`FailureEvent` (``resumed``,
``resharded``, ``checkpoint_fallback``, ``checkpoint_unwritable``,
``preempt_notice``, ``preempt_checkpoint``) and :class:`NoteEvent`.
"""

from __future__ import annotations

import dataclasses
import json
import sys
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


@dataclass
class FailureEvent(Event):
    """A failure-domain lifecycle event: a detected failure (a watchdog
    timeout, a ``preempt_notice``), or a recovery action (a checkpoint
    fallback, a resume, a ``resharded`` restore at another world, a
    ``preempt_checkpoint`` emergency save). ``rank``, ``step`` and
    ``incarnation`` locate it (None: not applicable). The banner is the
    record itself as JSON."""

    KIND: ClassVar[str] = "failure"

    kind: str
    label: str = ""
    message: str = ""
    rank: Optional[int] = None
    step: Optional[int] = None
    incarnation: Optional[int] = None

    def banner(self) -> str:
        rec = {k: v for k, v in self.record().items() if v is not None}
        return json.dumps(rec, default=str)


@dataclass
class NoteEvent(Event):
    """A free-form human banner that should also land in the structured
    log (a reshard's accounting, a serving process that found no
    checkpoint)."""

    KIND: ClassVar[str] = "note"

    message: str

    def banner(self) -> str:
        return self.message


class BannerSink:
    """A sink that writes each event's banner, where it has one, as a line
    to standard error: the JAX package's default stdout banners, kept off
    the standard output whose last line is a run's summary."""

    def emit(self, event: Event) -> None:
        text = event.banner()
        if text is not None:
            sys.stderr.write(text + "\n")
            sys.stderr.flush()
