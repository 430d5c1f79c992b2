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
  ``tree_bytes``;
- :mod:`.costmodel`: the cost model's ``canonical_config`` (the launcher's
  ``--plan``);
- :mod:`.runlog`: the run directory (its manifest, the rank shards, the
  supervisor's log and the alert feed) and the merge of its shards onto
  the supervisor's clock;
- :mod:`.analytics`: step statistics, stragglers and the effective
  bandwidth of a merged run;
- :mod:`.health`: the streaming detectors and their ``HealthMonitor``;
- :mod:`.live`: the live plane (the metric registry and its Prometheus
  text, the shard followers, the aggregator, ``/metrics``, the alert
  feed).

The rest of the JAX package's ``observe/`` (the rest of the cost model,
MFU, the critical path and the fabric matrix) is ROADMAP.md §A item 5.
"""

from . import analytics, fidelity, health, live, memory, runlog, spans  # noqa: F401
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
