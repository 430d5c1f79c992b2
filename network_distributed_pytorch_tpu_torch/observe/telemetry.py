"""The telemetry registry, the JAX package's ``observe/telemetry.py`` for
the port.

One :class:`Telemetry` a run: events flow in (``emit``) and every attached
sink sees each one. :func:`default_telemetry` is a banner-only registry for
code given no registry; an experiment builds its own from its config with
:func:`telemetry_from_config` (``ExperimentConfig.event_log`` adds a JSONL
sink beside the banners) and closes it when the run ends.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

from .events import Event
from .sinks import JsonlSink, Sink, StdoutSink


class Telemetry:
    """A registry of sinks. ``emit`` builds the event's record once, stamps
    the emit time (``ts``, and ``ts_mono`` on the monotonic clock) unless
    the event opts out, and hands it to every sink."""

    def __init__(self, sinks: Iterable[Sink] = ()):
        self.sinks = list(sinks)

    def add_sink(self, sink: Sink) -> Sink:
        self.sinks.append(sink)
        return sink

    def emit(self, event: Event) -> Event:
        record = event.record()
        if event.STAMP_TS:
            record.setdefault("ts", time.time())
            record.setdefault("ts_mono", time.monotonic())
        for sink in self.sinks:
            sink.emit(event, record)
        return event

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_DEFAULT: Optional[Telemetry] = None


def default_telemetry() -> Telemetry:
    """The process's banner-only registry, made at first use. It owns no
    file and is never closed."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Telemetry([StdoutSink()])
    return _DEFAULT


def telemetry_for_run(event_log: Optional[str] = None, stdout: bool = True, append: bool = True) -> Telemetry:
    """A fresh registry for one run: the banners (``stdout``) and, when
    ``event_log`` is set, a JSONL sink at that path.

    When the process is a rank of a managed run (the supervisor exported
    ``observe.runlog.ENV_RUN_ID``), the registry's first emission is the
    ``run_start`` marker, so every shard of a supervised run leads with
    the clock anchor :func:`observe.runlog.merge_run` aligns on. A run
    that is not managed writes what it wrote before (no marker)."""
    sinks: list = [StdoutSink()] if stdout else []
    if event_log:
        sinks.append(JsonlSink(event_log, append=append))
    telemetry = Telemetry(sinks)
    if event_log:
        from .runlog import run_marker_from_env

        marker = run_marker_from_env()
        if marker is not None:
            telemetry.emit(marker)
    return telemetry


def telemetry_from_config(config) -> Telemetry:
    """The registry of a run of ``config`` (its ``event_log``; a config
    without the field gets banners only)."""
    return telemetry_for_run(event_log=getattr(config, "event_log", None))


def audit_from_config(config) -> bool:
    """Whether a run of ``config`` audits its wire ledger: ``audit_wire``
    where it is set, else whenever an event log is written."""
    audit_wire = getattr(config, "audit_wire", None)
    if audit_wire is None:
        return bool(getattr(config, "event_log", None))
    return bool(audit_wire)
