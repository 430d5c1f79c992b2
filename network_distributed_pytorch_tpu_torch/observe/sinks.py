"""Telemetry sinks, the JAX package's ``observe/sinks.py`` for the port.

A sink receives every event emitted through a
:class:`..observe.telemetry.Telemetry` as ``(event, record)``: the typed
event for presentation (``banner()``) and the record already built, so
that no sink serialises it again. ``record`` may be left out by a caller
that holds a sink directly; the sink then builds it.

:class:`StdoutSink` is the one place that shows a human the banners. In
the port it writes them to standard error by default: the standard output
of a port run carries only its summary line (the launcher's ``--json``),
which the JAX package's launcher prints beside its banners.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, TextIO

from .events import Event


class Sink:
    def emit(self, event: Event, record: Optional[Dict] = None) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class StdoutSink(Sink):
    """Human banners: writes ``event.banner()`` as a line when the event
    has one. ``stream`` None is the process's standard error at call time
    (so a test's captured stream sees it)."""

    def __init__(self, stream: Optional[TextIO] = None):
        self.stream = stream

    def emit(self, event: Event, record: Optional[Dict] = None) -> None:
        text = event.banner()
        if text is not None:
            stream = self.stream if self.stream is not None else sys.stderr
            stream.write(text + "\n")
            stream.flush()


# the name earlier slices of the port exported for the same sink
BannerSink = StdoutSink


class StreamJsonSink(Sink):
    """One JSON object a line onto an open stream, optionally prefixed;
    flushed a line, so a reader's tail is always whole."""

    def __init__(self, stream: TextIO, prefix: str = ""):
        self.stream = stream
        self.prefix = prefix

    def emit(self, event: Event, record: Optional[Dict] = None) -> None:
        record = event.record() if record is None else record
        self.stream.write(self.prefix + json.dumps(record, default=str) + "\n")
        self.stream.flush()


class JsonlSink(StreamJsonSink):
    """An append-mode JSONL run log. Creates the parent directory; appends
    by default, so a resumed run extends its log."""

    def __init__(self, path: str, append: bool = True):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        super().__init__(open(path, "a" if append else "w"))

    def close(self) -> None:
        if not self.stream.closed:
            self.stream.close()


class MemorySink(Sink):
    """In-memory capture, for tests: the typed events and their records,
    with a filter by kind."""

    def __init__(self):
        self.events: List[Event] = []
        self.records: List[Dict] = []

    def emit(self, event: Event, record: Optional[Dict] = None) -> None:
        self.events.append(event)
        self.records.append(event.record() if record is None else record)

    def of_kind(self, kind: str) -> List[Dict]:
        return [r for r in self.records if r.get("event") == kind]
