"""Typed serving-request lifecycle, copied from the JAX package's
``serving/request.py``: the host half of the engine.

One :class:`Request` walks a fixed state machine::

    queued -> prefilling -> decoding -> finished
                 |              |----> evicted   (slot reclaimed; the
                 |                     request goes back to a queue)
                 `------------------> failed     (unrecoverable)

Every transition is timestamped on the engine's monotonic clock, so the
terminal :class:`observe.RequestEvent` carries the full latency split the
SLO report aggregates: queue (submit -> slot admission), prefill
(admission -> first token), decode (first token -> last token) and total.
``to_wire``/``from_wire`` round-trip a request through JSON for the
file-spool elastic queue (:mod:`serving.frontend`), which is how a dead
rank's in-flight requests travel to a survivor.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..observe import RequestEvent

QUEUED = "queued"
PREFILLING = "prefilling"
DECODING = "decoding"
FINISHED = "finished"
EVICTED = "evicted"
FAILED = "failed"

TERMINAL_STATES = (FINISHED, EVICTED, FAILED)

# legal transitions; everything else is a scheduler bug worth crashing on
_NEXT = {
    QUEUED: (PREFILLING, FAILED, EVICTED),
    PREFILLING: (DECODING, FINISHED, FAILED, EVICTED),
    DECODING: (FINISHED, FAILED, EVICTED),
}


class LifecycleError(RuntimeError):
    """An illegal request-state transition (scheduler bug, not user error)."""


@dataclass
class Request:
    """One generation request: prompt ids in, up to ``max_new_tokens``
    sampled ids out (early stop on ``eos_token_id`` when set)."""

    request_id: str
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    arrival_s: float = 0.0  # workload-relative arrival offset (frontend)
    # wall clock when the PRODUCER spooled the request (None outside the
    # file-spool path): lets a claiming worker charge the spool-sitting
    # time to the queue phase, so end-to-end latency starts at enqueue —
    # the quantity an overloaded pool inflates and an autoscaler needs
    spooled_unix: Optional[float] = None

    state: str = QUEUED
    tokens: List[int] = field(default_factory=list)
    requeues: int = 0
    reason: str = ""
    # engine-clock stamps (monotonic seconds); None until reached
    enqueued_t: Optional[float] = None
    admitted_t: Optional[float] = None
    first_token_t: Optional[float] = None
    terminal_t: Optional[float] = None

    # --- state machine ----------------------------------------------------

    def _to(self, state: str) -> None:
        if state not in _NEXT.get(self.state, ()):
            raise LifecycleError(
                f"request {self.request_id}: illegal transition "
                f"{self.state} -> {state}"
            )
        self.state = state

    def mark_enqueued(self, now: float) -> None:
        if self.state != QUEUED:
            raise LifecycleError(
                f"request {self.request_id}: enqueue in state {self.state}"
            )
        self.enqueued_t = now

    def mark_prefilling(self, now: float) -> None:
        self._to(PREFILLING)
        self.admitted_t = now

    def mark_decoding(self, now: float) -> None:
        self._to(DECODING)
        self.first_token_t = now

    def add_token(self, token: int) -> None:
        if self.state not in (PREFILLING, DECODING):
            raise LifecycleError(
                f"request {self.request_id}: token in state {self.state}"
            )
        self.tokens.append(int(token))

    @property
    def done(self) -> bool:
        """Generation complete: budget exhausted or EOS sampled."""
        if len(self.tokens) >= self.max_new_tokens:
            return True
        return (
            self.eos_token_id is not None
            and bool(self.tokens)
            and self.tokens[-1] == self.eos_token_id
        )

    def finish(self, now: float) -> None:
        # a one-token request finishes straight out of prefill
        self._to(FINISHED)
        if self.first_token_t is None:
            self.first_token_t = now
        self.terminal_t = now

    def evict(self, now: float, reason: str = "") -> None:
        self._to(EVICTED)
        self.terminal_t = now
        self.reason = reason

    def fail(self, now: float, reason: str = "") -> None:
        self._to(FAILED)
        self.terminal_t = now
        self.reason = reason

    def reset_for_requeue(self) -> "Request":
        """A fresh QUEUED copy of this request for fail-over re-queueing
        (orphaned by a dead rank, reclaimed by a survivor): generation
        restarts from the prompt, with the requeue counted."""
        return Request(
            request_id=self.request_id,
            prompt=list(self.prompt),
            max_new_tokens=self.max_new_tokens,
            eos_token_id=self.eos_token_id,
            arrival_s=self.arrival_s,
            spooled_unix=self.spooled_unix,
            requeues=self.requeues + 1,
        )

    # --- latency split ----------------------------------------------------

    @staticmethod
    def _delta(a: Optional[float], b: Optional[float]) -> Optional[float]:
        return None if a is None or b is None else max(0.0, b - a)

    @property
    def queue_s(self) -> Optional[float]:
        return self._delta(self.enqueued_t, self.admitted_t)

    @property
    def prefill_s(self) -> Optional[float]:
        return self._delta(self.admitted_t, self.first_token_t)

    @property
    def decode_s(self) -> Optional[float]:
        return self._delta(self.first_token_t, self.terminal_t)

    @property
    def total_s(self) -> Optional[float]:
        return self._delta(self.enqueued_t, self.terminal_t)

    def event(self, label: str = "serving", rank: Optional[int] = None) -> RequestEvent:
        """The terminal telemetry record (emit exactly once, at a terminal
        state)."""
        if self.state not in TERMINAL_STATES:
            raise LifecycleError(
                f"request {self.request_id}: event() in non-terminal state "
                f"{self.state}"
            )
        return RequestEvent(
            request_id=self.request_id,
            state=self.state,
            label=label,
            rank=rank,
            prompt_tokens=len(self.prompt),
            tokens_generated=len(self.tokens),
            queue_s=self.queue_s,
            prefill_s=self.prefill_s,
            decode_s=self.decode_s,
            total_s=self.total_s,
            requeues=self.requeues,
            reason=self.reason,
        )

    # --- wire form (file spool) -------------------------------------------

    def to_wire(self) -> Dict:
        """The JSON-safe form the file spool persists — the IMMUTABLE
        request description plus the requeue count, not the in-flight
        progress (a reclaimed request restarts from the prompt)."""
        return {
            "request_id": self.request_id,
            "prompt": list(self.prompt),
            "max_new_tokens": self.max_new_tokens,
            "eos_token_id": self.eos_token_id,
            "arrival_s": self.arrival_s,
            "spooled_unix": self.spooled_unix,
            "requeues": self.requeues,
        }

    @classmethod
    def from_wire(cls, doc: Dict) -> "Request":
        return cls(
            request_id=str(doc["request_id"]),
            prompt=[int(t) for t in doc["prompt"]],
            max_new_tokens=int(doc["max_new_tokens"]),
            eos_token_id=(
                None if doc.get("eos_token_id") is None
                else int(doc["eos_token_id"])
            ),
            arrival_s=float(doc.get("arrival_s", 0.0)),
            spooled_unix=(
                None if doc.get("spooled_unix") is None
                else float(doc["spooled_unix"])
            ),
            requeues=int(doc.get("requeues", 0)),
        )

    def dumps(self) -> str:
        return json.dumps(self.to_wire())

    @classmethod
    def loads(cls, text: str) -> "Request":
        return cls.from_wire(json.loads(text))
