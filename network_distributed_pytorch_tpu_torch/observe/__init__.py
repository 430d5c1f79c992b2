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
- :mod:`.costmodel`: the offline what-if cost model (calibration from a
  run report, the pricing of comm configs a fabric, the plan the
  launcher's ``--plan`` reads, the join of a prediction with a realized
  run);
- :mod:`.runlog`: the run directory (its manifest, the rank shards, the
  supervisor's log and the alert feed) and the merge of its shards onto
  the supervisor's clock;
- :mod:`.analytics`: step statistics, stragglers and the effective
  bandwidth of a merged run;
- :mod:`.health`: the streaming detectors and their ``HealthMonitor``;
- :mod:`.live`: the live plane (the metric registry and its Prometheus
  text, the shard followers, the aggregator, ``/metrics``, the alert
  feed);
- :mod:`.mfu`: the H100's peak tables, the roofline verdict and the MFU
  join of a step's counted FLOPs with its measured time;
- :mod:`.critpath`: the cross-rank critical path and its blame;
- :mod:`.fabric`: the measured per-edge fabric matrix.
"""

from . import analytics, costmodel, critpath, fabric, fidelity, health, live, memory, mfu, runlog, spans  # noqa: F401
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
