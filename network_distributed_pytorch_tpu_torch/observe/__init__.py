"""The narrow part of the JAX package's ``observe/`` that serving needs: the
typed events a serving engine emits (:mod:`.events`) and the byte count of
a KV cache (:mod:`.memory`). The rest of ``observe/`` is not ported yet
(ROADMAP.md §A item 8)."""

from .events import Event, KVPoolEvent, RequestEvent  # noqa: F401
from .memory import tree_bytes  # noqa: F401
