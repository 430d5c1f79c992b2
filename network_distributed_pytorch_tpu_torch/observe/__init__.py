"""The narrow part of the JAX package's ``observe/`` that the port needs:
the typed events a serving engine and the checkpointed training loop emit
(:mod:`.events`) and the byte count of a KV cache (:mod:`.memory`). The
rest of ``observe/`` is not ported yet (ROADMAP.md §A item 8)."""

from .events import BannerSink, Event, FailureEvent, KVPoolEvent, NoteEvent, RequestEvent  # noqa: F401
from .memory import tree_bytes  # noqa: F401
