"""Typed telemetry events, the JAX package's ``observe/events.py`` for the
port: the same 30 classes, with the same ``KIND``, fields, ``record()``
and ``banner()``, so a run log of either package has one schema.

Every part of the port that reports (the metrics logger, the wire ledger
and its audit, the health and fidelity probe, the memory sampler, spans,
the checkpoint layer, the serving engines) emits one of these through an
:class:`..observe.telemetry.Telemetry`. An event has two renderings:

- ``record()``: the structured JSONL form (``{"event": <kind>, ...}``),
  what :class:`..observe.sinks.JsonlSink` writes and the JAX package's
  ``scripts/report.py`` reads back;
- ``banner()``: the optional human line for
  :class:`..observe.sinks.StdoutSink` (None: silent). The step and epoch
  banners are the reference's print format.

Later slices of the port (the live plane, the supervisor, the fleet
scheduler) emit the classes no ported module emits yet; they are plain
dataclasses, so they are all here.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import ClassVar, Dict, List, Optional, Tuple

SCHEMA_VERSION = 1


@dataclass
class Event:
    """Base event: ``record()`` for structured sinks, ``banner()`` for the
    stdout sink. ``_not_recorded`` lists presentation-only fields kept out
    of the JSONL record; ``STAMP_TS`` lets the telemetry add an emit-time
    timestamp (off for :class:`RawEvent`, whose payload is a verbatim
    contract with the program that parses it)."""

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
class StepEvent(Event):
    """One training step: loss, wall-clock, cumulative wire bits.

    ``valid=False`` marks a record whose timing origin is missing
    (``end_step`` without ``start_step``) — persisted rather than silently
    recorded as ~0 s. ``verbose`` is presentation-only: the metrics logger
    sets it on every ``log_every``-th step to request a stdout banner."""

    KIND: ClassVar[str] = "step"
    _not_recorded: ClassVar[Tuple[str, ...]] = ("verbose",)

    step: int
    epoch: int
    loss: float
    step_time_s: float
    bits_cumulative: int
    valid: bool = True
    verbose: bool = False

    def banner(self) -> Optional[str]:
        if not self.verbose:
            return None
        timing = f"{self.step_time_s * 1e3:.1f} ms" if self.valid else "untimed"
        return (
            f"step {self.step}: loss {self.loss:.4f}, {timing}, "
            f"{self.bits_cumulative / 8e6:.2f} MB on wire"
        )


@dataclass
class EpochEvent(Event):
    """Per-epoch mean loss in the reference's banner style
    (``ddp_powersgd_guide_cifar10/ddp_init.py:183``)."""

    KIND: ClassVar[str] = "epoch"

    epoch: int
    rank: int
    mean_loss: float
    bits_cumulative: int

    def banner(self) -> str:
        return (
            f">>>>> Rank {self.rank}, epoch {self.epoch}: "
            f"mean loss {self.mean_loss:.4f}, "
            f"{self.bits_cumulative / 8e6:.2f} MB communicated"
        )


@dataclass
class CollectiveEvent(Event):
    """One wire-ledger line: a collective (or a batch of ``count`` identical
    ones) a compiled step issues, attributed to its originating layer
    (reducer / trainer loss-sync / fsdp / pipeline). ``payload_bytes`` is
    the TOTAL across all ``count`` collectives of the entry."""

    KIND: ClassVar[str] = "collective"

    label: str  # which compiled step (e.g. "exact_cifar10")
    tag: str  # e.g. "grads", "powersgd.P", "loss-sync", "fsdp.param-gather"
    layer: str  # reducer | trainer | fsdp | pipeline
    op: str  # all-reduce | all-gather | reduce-scatter | ...
    axis: str  # mesh axis the collective rides ("data", "pipe", ...)
    dtype: str
    payload_bytes: int
    count: int = 1


@dataclass
class CompileEvent(Event):
    """The reconciliation of a step's analytic wire ledger against what
    the step really moved. The JAX package reconciles against the compiled
    HLO; the port, which runs eagerly and has no HLO, against the
    collectives ``parallel.comm.record_collectives`` saw during the
    step's first call (:func:`..observe.ledger.audit_recorded_step`). The
    field names stay the JAX package's so that the record schema is one:
    in the port's events ``hlo_bytes``, ``hlo_collective_count`` and
    ``hlo_by_kind`` hold the ISSUED collectives' payload bytes, count and
    count by kind. The delta is reported, never hidden. The compile-time
    cost and memory fields have no counterpart in eager PyTorch and stay
    None there, as the JAX package leaves them on a backend without
    ``cost_analysis`` or ``memory_analysis``."""

    KIND: ClassVar[str] = "compile"

    label: str
    analytic_bytes: int  # the wire ledger's total (reference n_bits model)
    hlo_bytes: int  # what the compiled executable actually moves
    delta_bytes: int  # hlo - analytic, signed
    exact: bool
    hlo_collective_count: int
    hlo_by_kind: Dict[str, int] = field(default_factory=dict)
    dense_grad_bytes: Optional[int] = None  # uncompressed gradient size
    compression_ratio: Optional[float] = None  # dense / reducer payload
    overlap: Dict = field(default_factory=dict)  # utils.overlap extract
    # device-cost extension (observe.mfu): per-step FLOPs/bytes recorded at
    # compile time so a report can join them with measured step times.
    # ``flops_source`` says where the count came from: "flop_counter" (the
    # port's audit: ``observe.ledger.count_flops`` on the first call),
    # "cost_analysis" (the JAX package's compiler model) or "analytic" (a
    # hand count). All None when unknown.
    flops_per_step: Optional[float] = None
    bytes_accessed_per_step: Optional[float] = None
    flops_source: Optional[str] = None
    device_kind: Optional[str] = None
    peak_flops_per_s: Optional[float] = None
    # compile-time device-memory footprint (observe.memory): the compiler's
    # buffer-assignment split for the compiled executable, the predicted
    # side of the report's predicted-vs-measured memory join. All None when
    # the backend exposes no memory analysis (the join then marks the
    # prediction unavailable instead of vanishing).
    argument_bytes: Optional[float] = None
    output_bytes: Optional[float] = None
    temp_bytes: Optional[float] = None
    generated_code_bytes: Optional[float] = None
    peak_hbm_bytes: Optional[float] = None  # the split's sum (predicted peak)
    # the comm knobs the step was compiled with (``reducer``,
    # ``reducer_rank``, ``comm_chunks``, ``comm_strategy``,
    # ``bucket_bytes``) — what lets the offline cost model
    # (:mod:`observe.costmodel`) identify WHICH config a run executed and
    # join its predictions against the measured step time
    comm_config: Dict = field(default_factory=dict)

    def banner(self) -> str:
        tail = "byte-exact" if self.exact else f"delta {self.delta_bytes:+d} B"
        ratio = (
            f", {self.compression_ratio:.1f}x compression"
            if self.compression_ratio is not None
            else ""
        )
        return (
            f"[observe] {self.label}: analytic {self.analytic_bytes} B/step "
            f"vs compiled HLO {self.hlo_bytes} B/step ({tail}){ratio}"
        )


@dataclass
class FailureEvent(Event):
    """A failure-domain lifecycle event: a detected failure (watchdog
    timeout, audit error, stale peer, non-finite loss, a ``preempt_notice``
    SIGTERM), an injected chaos fault, or a recovery action (retry,
    checkpoint fallback, supervisor restart, resume, an elastic
    ``resharded`` restore at a shrunk world, a ``preempt_checkpoint``
    emergency save). ``scripts/report.py`` orders these by timestamp into
    the run's failure timeline — including the graceful-vs-hard death
    tally it reads from supervisor ``worker_exit``/``worker_term``
    messages — so every kind shares one event type.

    ``rank``/``step``/``incarnation`` locate the event in the failure
    domain (None = not applicable): which worker, at which step of its
    life, in which supervisor-restart generation of that worker. The
    banner is the record itself as JSON — impossible to miss AND
    machine-parseable, like the watchdog's original structured report."""

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
class ReshapeEvent(Event):
    """The supervisor's quorum restart planner changed the world's mesh
    shape: deaths inside the correlation window were classified
    (``correlated`` — a zone outage — vs an independent single-rank death),
    the largest viable mesh was computed from the survivors against the
    min-world floor, and the run restarted at ``new_mesh``. One typed
    event per replan, carrying both shapes, so the report's recovery
    timeline (and its MTTR metric) can anchor detection → replan →
    first-step-after without parsing free-text messages. ``kind`` mirrors
    the FailureEvent field so the shared failure timeline can render it
    in-line."""

    KIND: ClassVar[str] = "reshape"

    old_world: int
    new_world: int
    old_mesh: Optional[Dict[str, int]] = None
    new_mesh: Optional[Dict[str, int]] = None
    dead_ranks: Optional[List[int]] = None
    correlated: bool = False
    kind: str = "quorum_replan"
    reason: str = ""

    def banner(self) -> str:
        rec = {k: v for k, v in self.record().items() if v is not None}
        return json.dumps(rec, default=str)


@dataclass
class PartitionEvent(Event):
    """One transition of the geo-resilient outer loop's partition state
    machine (:mod:`parallel.hierarchical` / ``resilience.guards.
    PartitionPolicy``): the cross-site edge was declared dead
    (``phase="partitioned"`` — outer-deadline expiry or an injected
    ``comm_partition`` fault), training continued site-local
    (``phase="local"``, one event per local-only outer round, with the
    running ``local_steps`` against the ``max_local_steps`` divergence
    budget), or the edge healed and the EF-corrected catch-up reduction
    merged the sites back (``phase="rejoin"``). ``outer_staleness`` is the
    number of outer rounds since the last completed cross-site sync — the
    live plane's staleness gauge reads it straight off this record.
    ``scripts/report.py`` orders these into the run's partition timeline
    next to the failure timeline. The banner is the record as JSON, like
    :class:`FailureEvent`."""

    KIND: ClassVar[str] = "partition"

    phase: str  # "partitioned" | "local" | "rejoin"
    edge: Optional[List[int]] = None  # (src, dst) rank pair, None = unknown
    local_steps: int = 0
    max_local_steps: Optional[int] = None
    outer_staleness: int = 0
    reason: str = ""
    rank: Optional[int] = None
    step: Optional[int] = None
    incarnation: Optional[int] = None

    def banner(self) -> str:
        rec = {k: v for k, v in self.record().items() if v is not None}
        return json.dumps(rec, default=str)


@dataclass
class MarkerEvent(Event):
    """A run-lifecycle marker. The ``run_start`` marker is the shared
    alignment anchor of :mod:`observe.runlog`: emitted as the FIRST record
    of every per-rank JSONL shard (``telemetry_for_run`` auto-emits it when
    the supervisor's run env is present), it pins a (wall clock, monotonic
    clock) pair per (rank, incarnation). The merger matches the marker's
    wall time against the supervisor's recorded spawn time to estimate each
    rank's clock offset, then places every later event on the supervisor's
    clock via its monotonic delta from the marker. Silent on stdout."""

    KIND: ClassVar[str] = "marker"

    kind: str = "run_start"
    run_id: str = ""
    rank: Optional[int] = None
    world_size: Optional[int] = None
    incarnation: Optional[int] = None


@dataclass
class StragglerEvent(Event):
    """A straggler verdict from :mod:`observe.analytics`: this rank's
    steady-state p50 step duration exceeds the cross-rank median by more
    than the configured ``threshold`` factor. ``factor`` is the measured
    ratio (p50 / median); the banner is the report's one-line verdict."""

    KIND: ClassVar[str] = "straggler"

    rank: int
    p50_s: float
    median_p50_s: float
    factor: float  # measured p50 / cross-rank median p50
    threshold: float  # the configured flag factor
    n_steps: int = 0

    def banner(self) -> str:
        return (
            f"[observe] straggler: rank {self.rank} p50 "
            f"{self.p50_s * 1e3:.1f} ms = {self.factor:.2f}x cross-rank "
            f"median {self.median_p50_s * 1e3:.1f} ms "
            f"(threshold {self.threshold:.2f}x, n={self.n_steps})"
        )


@dataclass
class SpanEvent(Event):
    """One closed host-side span (:mod:`observe.spans`): a named, nested
    phase of the run (``data_load``, ``step/compute``, ``checkpoint/save``).
    Emitted ONCE at close in complete-event form — duration measured on the
    monotonic clock, the emit-time ``ts``/``ts_mono`` stamp marks the END of
    the span, so a timeline places the start at ``t_end − dur_s``.
    ``parent_id`` links the enclosing span (None = top level) and ``depth``
    is the nesting level, which is what lets ``scripts/report.py
    --trace-out`` render the spans as a nested Perfetto flamegraph without
    re-deriving containment. Silent on stdout — a span per step would drown
    the banners."""

    KIND: ClassVar[str] = "span"

    name: str
    span_id: int
    parent_id: Optional[int]
    depth: int
    dur_s: float
    step: Optional[int] = None
    rank: Optional[int] = None


@dataclass
class CritPathEvent(Event):
    """One step's cross-rank critical-path blame verdict
    (:mod:`observe.critpath`): which rank gated the step, which phase of
    that rank's timeline (``data_load`` / ``compute`` / ``collective-wait``)
    carried the gating excess over the cross-rank median, and — when the
    phase is collective-wait — which ring edge the wait sat on.
    ``path_s`` is the critical rank's wall time through the step (the
    longest path through the stitched span graph); the per-phase seconds
    alongside make the verdict auditable. Timings inherit the clock-model
    merge tolerance (see DESIGN.md) — they are never bitwise cross-rank
    facts. Silent on stdout — one per step would drown the banners."""

    KIND: ClassVar[str] = "critpath"

    step: int
    rank: int  # the gating rank
    phase: str  # data_load | compute | collective-wait
    path_s: float  # the critical rank's total through the step
    edge_src: Optional[int] = None  # set when phase == collective-wait
    edge_dst: Optional[int] = None
    data_s: float = 0.0  # the critical rank's per-phase split
    compute_s: float = 0.0
    comm_s: float = 0.0


@dataclass
class MfuEvent(Event):
    """A per-window MFU + roofline verdict (:mod:`observe.mfu`): measured
    steady-state step time joined with the compile-time FLOPs record and the
    per-device peak table. ``bound`` is the roofline classification —
    ``compute`` / ``hbm`` / ``comm-exposed`` / ``unknown`` — with the
    numbers it was derived from carried alongside so the verdict is
    auditable rather than oracular."""

    KIND: ClassVar[str] = "mfu"

    label: str
    window: str  # e.g. "steady-state"
    n_steps: int
    step_time_s: float
    flops_per_step: float
    flops_source: str  # "flop_counter" | "cost_analysis" | "analytic"
    peak_flops_per_s: float  # 0.0 = unknown device (CPU smoke)
    mfu: Optional[float]  # None when peak is unknown
    bound: str  # compute | hbm | comm-exposed | unknown
    device_kind: str = ""
    bytes_accessed_per_step: Optional[float] = None
    arithmetic_intensity: Optional[float] = None  # flops / bytes accessed
    ridge_flops_per_byte: Optional[float] = None  # peak / HBM bytes/s
    hbm_bytes_per_s: Optional[float] = None
    exposed_comm_fraction: Optional[float] = None

    def banner(self) -> str:
        mfu = f"{self.mfu:.4f}" if self.mfu is not None else "n/a"
        bound = f"{self.bound}-bound" if self.bound in ("compute", "hbm") else self.bound
        return (
            f"[observe] mfu {self.label} ({self.window}, n={self.n_steps}): "
            f"{mfu} at {self.step_time_s * 1e3:.1f} ms/step, "
            f"{self.flops_per_step / 1e9:.2f} GF/step ({self.flops_source})"
            f" -> {bound}"
        )


@dataclass
class PolicyEvent(Event):
    """One transition of the degraded-fabric fallback controller
    (:mod:`resilience.controller`): the ladder was walked one rung down
    (``action="descend"``, the fabric degraded) or one rung up
    (``action="ascend"``, it recovered). ``trigger`` names the verdict
    that forced the move (deadline expiries, degraded steps, straggler
    flags, achieved-bandwidth collapse, or a sustained healthy streak);
    ``overrides`` is the new rung's knob dict (``reducer``,
    ``comm_chunks``, ``comm_strategy``, ...) so the record alone is
    enough to reproduce the reconfiguration. ``predicted_bytes_per_step``
    is the NEW rung's static wire-ledger cost, ``realized_bytes_per_step``
    the measured cost at the OLD rung — the pair is the controller's
    falsifiable claim that descending actually sheds bytes. The banner is
    the record as JSON, like :class:`FailureEvent`."""

    KIND: ClassVar[str] = "policy"

    action: str  # "descend" | "ascend"
    trigger: str
    epoch: int
    rung_before: str
    rung_after: str
    rung_index_before: int
    rung_index_after: int
    overrides: Dict = field(default_factory=dict)
    predicted_bytes_per_step: Optional[float] = None
    realized_bytes_per_step: Optional[float] = None
    rank: Optional[int] = None

    def banner(self) -> str:
        rec = {k: v for k, v in self.record().items() if v is not None}
        return json.dumps(rec, default=str)


@dataclass
class PredictionEvent(Event):
    """One what-if prediction of the offline analytic cost model
    (:mod:`observe.costmodel`): for a named comm config on a named fabric,
    the predicted step time and wire bytes with the per-component
    breakdown (compute, exposed comm, collective latency, compression
    compute) it was assembled from. ``config_key`` is the canonical
    config string predictions and realized runs join on — when the config
    is later actually executed, ``scripts/report.py`` fills
    ``realized_step_s``/``realized_bytes_per_step`` and the relative
    error becomes the gate's ``costmodel_error`` metric, extending
    :class:`PolicyEvent`'s bytes calibration to time. The banner is the
    record as JSON, like :class:`PolicyEvent`."""

    KIND: ClassVar[str] = "prediction"

    fabric: str
    config_key: str
    config: Dict = field(default_factory=dict)
    predicted_step_s: Optional[float] = None
    predicted_bytes_per_step: Optional[float] = None
    compute_s: Optional[float] = None
    exposed_comm_s: Optional[float] = None
    latency_s: Optional[float] = None
    compress_s: Optional[float] = None
    source_run: str = ""
    realized_step_s: Optional[float] = None
    realized_bytes_per_step: Optional[float] = None
    rank: Optional[int] = None

    def banner(self) -> str:
        rec = {k: v for k, v in self.record().items() if v is not None}
        return json.dumps(rec, default=str)


@dataclass
class DataDropEvent(Event):
    """Typed record of intentionally dropped training data (e.g. the
    DiLoCo entry discarding a malformed batch). The drop was
    always legal — the reference does the same — but a silent note makes
    skipped samples unauditable; this event carries the exact batch and
    sample counts so ``scripts/report.py`` can tally them per label."""

    KIND: ClassVar[str] = "data_drop"

    label: str
    epoch: int
    dropped_batches: int
    dropped_samples: int
    reason: str = ""
    rank: Optional[int] = None

    def banner(self) -> str:
        return (
            f"[observe] data_drop {self.label} epoch {self.epoch}: "
            f"{self.dropped_batches} batch(es) / {self.dropped_samples} "
            f"sample(s) dropped ({self.reason})"
        )


@dataclass
class LoaderEvent(Event):
    """One ingestion-pipeline verdict per epoch (or bench phase): how fast
    the data plane fed the device and where its time went.
    ``samples_per_s`` is end-to-end through decode + assemble + staging;
    ``wait_s`` is the staging loop's time blocked on the UPSTREAM producer
    (decode/assemble), so ``wait_s ≈ 0`` means ingestion outran the
    consumer and a large ``wait_s`` names the host hot path — the number
    ``bench.py``'s loader-isolation phase regresses against. ``native``
    says which decode/assemble path ran (True = the C++ loader, False =
    the Python fallback, None = unknown/mixed); ``cursor`` carries the
    global stream position for streamed-index runs (the same value
    checkpointed in ``_LOADER_STATE.json``)."""

    KIND: ClassVar[str] = "loader"

    label: str
    batches: int
    samples: int
    samples_per_s: float
    prefetch_depth: int = 0
    wait_s: float = 0.0
    native: Optional[bool] = None
    epoch: Optional[int] = None
    cursor: Optional[int] = None
    rank: Optional[int] = None

    def banner(self) -> str:
        path = {True: "native", False: "python", None: "?"}[self.native]
        return (
            f"[observe] loader {self.label}: {self.samples} sample(s) /"
            f" {self.batches} batch(es) at {self.samples_per_s:,.0f}"
            f" samples/s ({path} path, depth {self.prefetch_depth},"
            f" producer wait {self.wait_s:.3f}s)"
        )


@dataclass
class RequestEvent(Event):
    """Terminal record of one serving request through
    :mod:`serving.engine` — emitted once, when the request leaves the
    engine (``state`` ∈ ``finished`` / ``evicted`` / ``failed``), carrying
    the whole lifecycle's latency split: ``queue_s`` (submit → slot
    admission), ``prefill_s`` (prompt forward + first token), ``decode_s``
    (first token → last token) and ``total_s`` (submit → terminal), plus
    the token counts the SLO report divides by. ``requeues`` counts how
    many times the request was orphaned by a dead rank and reclaimed by a
    survivor (the elastic fail-over path). Durations come from the
    engine's monotonic clock; silent on stdout (one line per request would
    drown a load test) — ``scripts/report.py`` aggregates the p50/p99 SLO
    table from the JSONL records."""

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
class TrainHealthEvent(Event):
    """Periodic training-health sample — the runtime view of the paper's
    central tradeoff (compression rank vs. gradient fidelity). Emitted
    every ``--health-every`` steps OFF the hot path: the sampler is a
    separately dispatched probe (one extra forward+backward plus one
    collective-free compression round), never part of the compiled train
    step. ``grad_norm`` is the (cross-worker mean of the) local gradient
    2-norm, ``ef_memory_norm`` the error-feedback residual norm carried in
    :class:`parallel.trainer.TrainState`, and ``powersgd_rel_error`` the
    relative compression error ``‖M − P̂Qᵀ‖/‖M‖`` of one diagnostic
    low-rank round on the current gradient (0.0 for exact reducers, whose
    error is identically zero by construction; None when the emitter
    sampled no compression round at all). Silent on stdout; the live
    aggregator (:mod:`observe.live`) turns these into gauges and the
    EWMA detectors (:mod:`observe.health`) watch them for NaN precursors."""

    KIND: ClassVar[str] = "train_health"

    step: int
    epoch: int = 0
    grad_norm: float = 0.0
    ef_memory_norm: float = 0.0
    powersgd_rel_error: Optional[float] = None
    loss: Optional[float] = None
    rank: Optional[int] = None
    label: str = ""


@dataclass
class MemoryEvent(Event):
    """Periodic device-memory sample (:mod:`observe.memory`): the
    allocator's view of HBM occupancy read from ``device.memory_stats()``
    every ``--health-every`` steps, riding the same off-hot-path cadence
    as :class:`TrainHealthEvent`. ``bytes_in_use`` / ``peak_bytes_in_use``
    / ``bytes_limit`` are allocator-level numbers (see DESIGN.md's
    guarantee classes: never bitwise, merge-tolerance across ranks) — the
    MEASURED side of the report's predicted-vs-measured memory join, and
    the input to the EWMA headroom detector (:mod:`observe.health`) whose
    warn/critical verdicts are the OOM-precursor alert the supervisor and
    FallbackController act on. All-None fields mean the backend exposes no
    ``memory_stats`` (CPU) — the sampler degrades to silence rather than
    spam. Silent on stdout; the live aggregator turns these into
    ``live_hbm_bytes{rank=}`` gauges."""

    KIND: ClassVar[str] = "memory"

    step: int
    bytes_in_use: Optional[float] = None
    peak_bytes_in_use: Optional[float] = None
    bytes_limit: Optional[float] = None
    device_kind: str = ""
    rank: Optional[int] = None
    label: str = ""


@dataclass
class FidelityEvent(Event):
    """One per-group gradient-fidelity sample (:mod:`observe.fidelity`):
    the compression-side twin of the wire ledger, riding the same
    off-hot-path ``--health-every`` probe cadence as
    :class:`TrainHealthEvent` but attributed per shape-group / bucket
    instead of collapsed to one scalar. ``group`` is the fidelity group
    key (``grads``, ``grads.b{i}``, ``powersgd.g{k}:{n}x{m}r{r}``,
    ``powersgd.rank1``); ``tag`` is the wire-ledger tag the group's bytes
    are priced under in the SAME step, so a fidelity record and a
    :class:`CollectiveEvent` join exactly (orphan tags are a test
    failure, mirroring ``check_fault_registry``). ``rel_error`` /
    ``cosine_sim`` compare the compressed against the exact gradient for
    the group (exact reducers identically 0.0 / 1.0 by construction);
    ``ef_norm`` / ``ef_growth`` track the group's error-feedback memory
    and its per-sample growth rate; ``quantized_share`` is the fraction
    of the group's wire bytes sent below f32 (the bf16 wire dtype);
    ``replica_drift`` / ``anchor_drift`` carry the inner-replica
    divergence and site-anchor distance for hierarchical/DiLoCo states
    (identically zero for exact data-parallel reducers, whose replicas
    agree bitwise). Guarantee class (DESIGN.md): sampled,
    merge-tolerance, never bitwise. Silent on stdout; the live
    aggregator turns these into ``live_fidelity_rel_error{group=}`` /
    ``live_ef_norm{group=}`` / ``live_replica_drift`` gauges feeding the
    EF blow-up and fidelity-collapse detectors."""

    KIND: ClassVar[str] = "fidelity"

    step: int
    group: str
    tag: str = ""
    epoch: int = 0
    rel_error: float = 0.0
    cosine_sim: float = 1.0
    ef_norm: float = 0.0
    ef_growth: float = 0.0
    quantized_share: float = 0.0
    replica_drift: float = 0.0
    anchor_drift: float = 0.0
    rank: Optional[int] = None
    label: str = ""


@dataclass
class AlertEvent(Event):
    """A streaming-detector verdict (:mod:`observe.health`): an EWMA
    detector watching the live event stream decided a signal left its
    healthy envelope. ``alert`` names the detector (``grad_spike`` /
    ``loss_plateau`` / ``step_time_drift`` / ``bandwidth_collapse`` /
    ``slo_burn`` / ``ef_blowup`` / ``fidelity_collapse``), ``severity``
    is ``warn`` or ``critical`` (critical
    grad-norm alerts are the sustained-NaN-precursor signal the supervisor
    may restart on), and ``value``/``threshold`` carry the measurement
    that fired so the record is auditable. Alerts flow BACK into the
    control plane: the supervisor logs them in its own shard and appends
    them to ``alerts.jsonl``, which in-run followers (the toy worker, the
    adaptive train loop) tail to nudge the
    :class:`resilience.controller.FallbackController` mid-epoch. The
    banner is the record as JSON, like :class:`FailureEvent`."""

    KIND: ClassVar[str] = "alert"

    alert: str
    severity: str = "warn"
    value: float = 0.0
    threshold: float = 0.0
    message: str = ""
    rank: Optional[int] = None
    step: Optional[int] = None
    source: str = "aggregator"

    def banner(self) -> str:
        rec = {k: v for k, v in self.record().items() if v is not None}
        return json.dumps(rec, default=str)


@dataclass
class JobEvent(Event):
    """One fleet-job lifecycle transition through
    :class:`resilience.scheduler.FleetScheduler`: ``state`` ∈ ``submitted``
    (manifest claimed off the job spool) / ``started`` (a per-job
    Supervisor spawned over the granted ranks) / ``preempting`` (SIGTERM
    storm in flight) / ``parked`` (exit-75 drain landed, job re-queued) /
    ``resumed`` (re-admitted after a park) / ``completed`` / ``failed``.
    ``chip_seconds`` is world x wall seconds the slice was held for the
    segment ending at this transition; ``work_done`` counts the job's own
    progress units (train steps, served requests) so the fleet report can
    compute deadline-weighted goodput without re-reading worker state.
    The banner is the record as JSON, like :class:`FailureEvent`."""

    KIND: ClassVar[str] = "job"

    job_id: str
    state: str  # submitted|started|preempting|parked|resumed|completed|failed
    kind: str = ""  # train | serve
    priority: int = 0
    world: Optional[int] = None
    device_ranks: Optional[List[int]] = None
    deadline_s: Optional[float] = None
    chip_seconds: Optional[float] = None
    work_done: Optional[float] = None
    met_deadline: Optional[bool] = None
    preemptions: int = 0
    reason: str = ""

    def banner(self) -> str:
        rec = {k: v for k, v in self.record().items() if v is not None}
        return json.dumps(rec, default=str)


@dataclass
class PreemptEvent(Event):
    """The scheduler reclaimed chips from a running job: ``victim`` (the
    lower-priority job whose Supervisor got the SIGTERM → committed
    end-of-step checkpoint → exit-75 drain) and ``beneficiary`` (the job —
    typically a serving pool under SLO burn — the freed ranks go to).
    ``reason`` names the trigger (``slo_burn`` for the live-plane alert
    escalation, ``priority`` for plain queue-order preemption);
    ``budget_left`` is the victim's remaining preemption budget AFTER this
    preemption so a repeatedly-bullied job's exhaustion is auditable. The
    banner is the record as JSON, like :class:`FailureEvent`."""

    KIND: ClassVar[str] = "preempt"

    victim: str
    beneficiary: str = ""
    reason: str = ""
    device_ranks: Optional[List[int]] = None
    victim_priority: Optional[int] = None
    beneficiary_priority: Optional[int] = None
    budget_left: Optional[int] = None

    def banner(self) -> str:
        rec = {k: v for k, v in self.record().items() if v is not None}
        return json.dumps(rec, default=str)


@dataclass
class ScheduleEvent(Event):
    """One admission decision: the scheduler asked the offline cost model
    (:mod:`observe.costmodel`) which viable mesh slice hits the job's
    deadline cheapest and granted it. ``world``/``mesh`` are the chosen
    slice (mesh factored by ``plan_mesh``'s divisor discipline),
    ``device_ranks`` the concrete inventory ranks granted,
    ``predicted_step_s``/``predicted_chip_seconds`` the planner's price
    for the slice (None when no calibration exists and the scheduler fell
    back to smallest-viable). The banner is the record as JSON."""

    KIND: ClassVar[str] = "schedule"

    job_id: str
    world: int
    device_ranks: List[int] = field(default_factory=list)
    mesh: Optional[Dict[str, int]] = None
    predicted_step_s: Optional[float] = None
    predicted_chip_seconds: Optional[float] = None
    planner: str = ""  # "costmodel" | "fallback"
    reason: str = ""

    def banner(self) -> str:
        rec = {k: v for k, v in self.record().items() if v is not None}
        return json.dumps(rec, default=str)


@dataclass
class JobFailedEvent(Event):
    """A job exhausted its K-strike hard-failure budget and was quarantined:
    its manifest moved to the spool's ``quarantine/`` directory so the
    queue never wedges behind a crash-looper. ``strikes`` is the count of
    hard (non-preempt, non-zero) supervisor failures; ``last_rc`` the final
    exit code observed. The banner is the record as JSON."""

    KIND: ClassVar[str] = "job_failed"

    job_id: str
    strikes: int
    last_rc: Optional[int] = None
    kind: str = ""
    priority: int = 0
    reason: str = ""

    def banner(self) -> str:
        rec = {k: v for k, v in self.record().items() if v is not None}
        return json.dumps(rec, default=str)


@dataclass
class KVPoolEvent(Event):
    """Paged-KV pool occupancy sample (``serving.engine.PagedEngine``):
    the block allocator's view of the serving KV cache — free/used/shared
    block counts over the fixed ``n_blocks`` pool, the pool's device
    bytes, and the monotone sharing ledgers (prefix-index hits, prefill
    tokens skipped via sharing, copy-on-write block copies, admissions
    deferred for lack of blocks). Emitted every ``emit_pool_every`` decode
    ticks plus on eviction, so the live aggregator can expose
    ``live_kv_blocks_free`` / ``live_kv_prefix_hits_total`` /
    ``live_kv_cow_copies_total`` gauges and the report can fold pool bytes
    into the serving memory table. Counter fields are engine-lifetime
    totals (gauge-of-counter on the live plane). Silent on stdout."""

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
class AutoscaleEvent(Event):
    """The serving autoscaler changed (or tried to change) the spool-worker
    pool: ``direction`` is ``up`` (worker spawned on leased chips), ``down``
    (worker drained and its chips released), or ``denied`` (scale-up wanted
    but the scheduler had no grantable chips). ``reason`` names the trigger
    signal (``slo_burn`` for a live-plane burn escalation, ``queue_depth``
    for sustained spool backlog, ``drained`` for end-of-storm reaping);
    ``workers`` is the pool size AFTER the action and ``queue_depth`` /
    ``p99_s`` the gauge values that drove it, so every scaling decision is
    auditable from the event log alone. The banner is the record as JSON,
    like :class:`ScheduleEvent`."""

    KIND: ClassVar[str] = "autoscale"

    direction: str
    reason: str = ""
    workers: int = 0
    worker_id: Optional[int] = None
    device_ranks: Optional[List[int]] = None
    queue_depth: Optional[int] = None
    p99_s: Optional[float] = None
    escalation: Optional[int] = None

    def banner(self) -> str:
        rec = {k: v for k, v in self.record().items() if v is not None}
        return json.dumps(rec, default=str)


@dataclass
class NoteEvent(Event):
    """A free-form human banner (init lifecycle, dropped-batch notes,
    study tables) that should also land in the structured log."""

    KIND: ClassVar[str] = "note"

    message: str

    def banner(self) -> str:
        return self.message


@dataclass
class RawEvent(Event):
    """A verbatim payload for JSON contracts with the programs that parse
    them (bench phase lines, the launcher's ``--json`` summary): ``record()`` IS the payload,
    with no ``event`` wrapper and no timestamp stamping, so existing
    parsers see identical bytes."""

    KIND: ClassVar[str] = "raw"
    STAMP_TS: ClassVar[bool] = False

    payload: Dict

    def record(self) -> Dict:
        return dict(self.payload)
