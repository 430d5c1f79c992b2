"""The telemetry core of the port, the JAX package's ``observe/`` package:

- :mod:`.events`: the 30 typed events and their records;
- :mod:`.sinks`: the banner sink, the JSONL run log, the stream and the
  in-memory sinks;
- :mod:`.telemetry`: the registry a run emits through
  (``telemetry_from_config``);
- :mod:`.spans`: nested host spans, mirrored into a ``torch.profiler``
  trace while one records;
- :mod:`.ledger`: the wire ledger and its audit against the collectives a
  step issued;
- :mod:`.fidelity`: the per-group compression-fidelity events and their
  summaries;
- :mod:`.memory`: the device-memory sampler, the OOM report and
  ``tree_bytes``.

The rest of the JAX package's ``observe/`` (the health detectors, the live
plane, the run log merger, the cost model, MFU, the critical path and the
fabric matrix) is ROADMAP.md §A item 5; the step guard that writes the OOM
report is item 4.
"""

from . import fidelity, memory, spans  # noqa: F401
from .events import (  # noqa: F401
    SCHEMA_VERSION,
    AlertEvent,
    AutoscaleEvent,
    CollectiveEvent,
    CompileEvent,
    CritPathEvent,
    DataDropEvent,
    EpochEvent,
    Event,
    FailureEvent,
    FidelityEvent,
    JobEvent,
    JobFailedEvent,
    KVPoolEvent,
    LoaderEvent,
    MarkerEvent,
    MemoryEvent,
    MfuEvent,
    NoteEvent,
    PartitionEvent,
    PolicyEvent,
    PredictionEvent,
    PreemptEvent,
    RawEvent,
    RequestEvent,
    ReshapeEvent,
    ScheduleEvent,
    SpanEvent,
    StepEvent,
    StragglerEvent,
    TrainHealthEvent,
)
from .ledger import LedgerEntry, WireLedger  # noqa: F401
from .memory import tree_bytes  # noqa: F401
from .sinks import BannerSink, JsonlSink, MemorySink, Sink, StdoutSink, StreamJsonSink  # noqa: F401
from .spans import recording, set_ambient, span  # noqa: F401
from .telemetry import (  # noqa: F401
    Telemetry,
    audit_from_config,
    default_telemetry,
    telemetry_for_run,
    telemetry_from_config,
)
