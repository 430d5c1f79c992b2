"""The live telemetry plane: streaming metric aggregation + /metrics. The
port's own copy of the JAX package's ``observe/live.py``: the same metric
names, labels and alerts from the same records.

Everything the post-hoc ``scripts/report.py`` computes from completed
shards, this module computes INCREMENTALLY while the run is alive — same
event vocabulary, same analytics, so the live gauges and the post-hoc
report agree on what a number means:

- :class:`MetricRegistry` — counters, gauges, and ring-buffer histograms
  with rolling p50/p99, rendered in the Prometheus text exposition format.
- :class:`MetricSink` — a :class:`observe.sinks.Sink` adapter that derives
  metrics from the typed events in-process (per-rank live view, e.g. the
  serving engine's own registry).
- :class:`ShardFollower` — resumable tailing of one JSONL shard on top of
  :func:`observe.runlog.read_shard_from`: byte offsets, complete lines
  only, torn tails counted and retried, offsets persistable.
- :class:`LiveAggregator` — the supervisor-side merger: follows every
  rank shard (plus the supervisor's own), re-derives the skew-corrected
  run clock incrementally (same model as :func:`observe.runlog.merge_run`:
  manifest spawn times × ``run_start`` markers × monotonic deltas), feeds
  the registry and the :class:`observe.health.HealthMonitor` detectors,
  and collects the :class:`observe.events.AlertEvent`s they fire. The
  step-time gauge mirrors ``analytics.rank_step_stats`` (steady-state,
  first timed step per incarnation dropped) and the bytes/s gauge calls
  ``analytics.effective_bandwidth`` on the deduped live ledger — by
  construction the live numbers converge on the report's.
- :class:`MetricsHTTPServer` — a stdlib ``http.server`` daemon thread
  serving ``GET /metrics`` (Prometheus text) and ``GET /healthz``.
- :class:`AlertFeed` / :func:`append_alert` — the control-plane feedback
  channel: the supervisor appends fired alerts to ``alerts.jsonl`` in the
  run dir; in-run followers tail it and nudge the FallbackController
  mid-epoch.

torch-free, import-light, and CLOCK-FREE by design: the aggregator orders
and windows events by their own carried timestamps (event time), never by
arrival time, so replays and tests are exact. The single wall clock read
in this module is the exposition formatter
(:meth:`MetricRegistry.render_prometheus`, the ``live_scrape_unix_time``
gauge).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.bandwidth import ring_neighbors
from . import analytics, runlog
from .events import AlertEvent, Event
from .health import DetectorConfig, HealthMonitor
from .sinks import Sink

# one (fabric-independent) label set per metric family keeps cardinality
# bounded: ranks and alert kinds are the only open dimensions
_EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
DEFAULT_HISTOGRAM_WINDOW = 512


class RollingHistogram:
    """A fixed-size ring buffer of observations with rolling percentiles.
    ``count``/``total`` are cumulative (Prometheus summary semantics);
    percentiles cover the most recent ``window`` observations."""

    def __init__(self, window: int = DEFAULT_HISTOGRAM_WINDOW):
        self._ring: deque = deque(maxlen=max(1, int(window)))
        self.count = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        self._ring.append(value)
        self.count += 1
        self.total += value

    def percentile(self, p: float) -> float:
        return analytics.percentile(list(self._ring), p)

    def __len__(self) -> int:
        return len(self._ring)


_LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, object]) -> _LabelKey:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


class MetricRegistry:
    """Counters, gauges, and rolling histograms keyed by (name, labels),
    with Prometheus text rendering. Thread-safe: the exposition thread
    renders while the aggregator (or a worker's sink) writes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[_LabelKey, float] = {}
        self._gauges: Dict[_LabelKey, float] = {}
        self._hists: Dict[_LabelKey, RollingHistogram] = {}
        self._help: Dict[str, str] = {}

    def counter(self, name: str, inc: float = 1.0, help: str = "", **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            if help:
                self._help.setdefault(name, help)
            self._counters[k] = self._counters.get(k, 0.0) + float(inc)

    def gauge(self, name: str, value: float, help: str = "", **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            if help:
                self._help.setdefault(name, help)
            self._gauges[k] = float(value)

    def observe(
        self,
        name: str,
        value: float,
        window: int = DEFAULT_HISTOGRAM_WINDOW,
        help: str = "",
        **labels,
    ) -> None:
        k = _key(name, labels)
        with self._lock:
            if help:
                self._help.setdefault(name, help)
            hist = self._hists.get(k)
            if hist is None:
                hist = self._hists[k] = RollingHistogram(window)
        hist.observe(value)

    # -- read side (tests, dashboard tiles) --------------------------------

    def get_counter(self, name: str, **labels) -> float:
        return self._counters.get(_key(name, labels), 0.0)

    def get_gauge(self, name: str, **labels) -> Optional[float]:
        return self._gauges.get(_key(name, labels))

    def get_histogram(self, name: str, **labels) -> Optional[RollingHistogram]:
        return self._hists.get(_key(name, labels))

    def snapshot(self) -> Dict:
        """A plain-dict view for the dashboard and tests: metric name ->
        {labels-as-string: value}; histograms expose p50/p99/count."""
        with self._lock:
            out: Dict[str, Dict[str, object]] = {}
            for (name, labels), v in self._counters.items():
                out.setdefault(name, {})[_fmt_labels(labels)] = v
            for (name, labels), v in self._gauges.items():
                out.setdefault(name, {})[_fmt_labels(labels)] = v
            for (name, labels), h in self._hists.items():
                out.setdefault(name, {})[_fmt_labels(labels)] = {
                    "p50": h.percentile(50),
                    "p99": h.percentile(99),
                    "count": h.count,
                    "sum": h.total,
                }
            return out

    # -- exposition --------------------------------------------------------

    def render_prometheus(self) -> str:
        """The Prometheus text exposition (format 0.0.4). Histograms render
        as summaries (``{quantile=...}`` + ``_count``/``_sum``). This is
        the module's ONE sanctioned wall-clock site: scrape freshness is a
        wall-time fact, everything else in the live plane is event-time."""
        with self._lock:
            lines: List[str] = []

            def head(name: str, mtype: str) -> None:
                if name in self._help:
                    lines.append(f"# HELP {name} {self._help[name]}")
                lines.append(f"# TYPE {name} {mtype}")

            for name in sorted({n for n, _ in self._counters}):
                head(name, "counter")
                for (n, labels), v in sorted(self._counters.items()):
                    if n == name:
                        lines.append(f"{n}{_fmt_labels(labels)} {_fmt_value(v)}")
            for name in sorted({n for n, _ in self._gauges}):
                head(name, "gauge")
                for (n, labels), v in sorted(self._gauges.items()):
                    if n == name:
                        lines.append(f"{n}{_fmt_labels(labels)} {_fmt_value(v)}")
            for name in sorted({n for n, _ in self._hists}):
                head(name, "summary")
                for (n, labels), h in sorted(self._hists.items()):
                    if n != name:
                        continue
                    for q in (0.5, 0.99):
                        ql = labels + (("quantile", str(q)),)
                        lines.append(
                            f"{n}{_fmt_labels(ql)} {_fmt_value(h.percentile(q * 100))}"
                        )
                    lines.append(f"{n}_count{_fmt_labels(labels)} {h.count}")
                    lines.append(
                        f"{n}_sum{_fmt_labels(labels)} {_fmt_value(h.total)}"
                    )
            lines.append("# TYPE live_scrape_unix_time gauge")
            lines.append(f"live_scrape_unix_time {_fmt_value(time.time())}")
            return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# event -> metric derivation (shared by the in-process sink and the
# shard-tailing aggregator)
# ---------------------------------------------------------------------------


def ingest_record(
    registry: MetricRegistry, rec: Dict, rank: Optional[int] = None
) -> None:
    """Derive the per-event metrics from one JSONL record. ``rank`` is the
    shard's rank when the record itself carries none."""
    kind = rec.get("event")
    r = rec.get("rank", rank)
    rlabel = "?" if r is None else str(r)
    if kind == "step":
        registry.counter(
            "live_steps_total", help="training steps observed", rank=rlabel
        )
        dt = rec.get("step_time_s")
        if rec.get("valid", True) and isinstance(dt, (int, float)):
            registry.observe(
                "live_step_time_seconds", dt,
                help="per-step wall time (rolling window)", rank=rlabel,
            )
        loss = rec.get("loss")
        if isinstance(loss, (int, float)):
            registry.gauge(
                "live_loss", loss, help="last observed training loss",
                rank=rlabel,
            )
    elif kind == "collective":
        payload = rec.get("payload_bytes")
        if isinstance(payload, (int, float)):
            registry.counter(
                "live_comm_bytes_total", payload,
                help="wire-ledger payload bytes observed",
                tag=str(rec.get("tag", "?")),
            )
    elif kind == "train_health":
        for field, metric in (
            ("grad_norm", "live_grad_norm"),
            ("ef_memory_norm", "live_ef_memory_norm"),
            ("powersgd_rel_error", "live_powersgd_rel_error"),
        ):
            v = rec.get(field)
            if isinstance(v, (int, float)):
                registry.gauge(
                    metric, v, help=f"last sampled {field}", rank=rlabel
                )
    elif kind == "fidelity":
        group = str(rec.get("group", "?"))
        for field, metric, helptxt in (
            ("rel_error", "live_fidelity_rel_error",
             "last sampled per-group relative compression error"),
            ("ef_norm", "live_ef_norm",
             "last sampled per-group error-feedback memory norm"),
            ("ef_growth", "live_ef_growth",
             "per-group EF-norm growth since the previous sample"),
            ("cosine_sim", "live_fidelity_cosine_sim",
             "last sampled per-group compressed-vs-exact cosine similarity"),
        ):
            v = rec.get(field)
            if isinstance(v, (int, float)):
                registry.gauge(
                    metric, v, help=helptxt, rank=rlabel, group=group
                )
        # whole-state drift scalars ride every group's event identically;
        # ungrouped gauges (last writer wins, the values agree)
        for field, metric, helptxt in (
            ("replica_drift", "live_replica_drift",
             "RMS per-worker parameter divergence from the replica mean"),
            ("anchor_drift", "live_anchor_drift",
             "mean-parameter distance from the last applied outer anchor"),
        ):
            v = rec.get(field)
            if isinstance(v, (int, float)):
                registry.gauge(metric, v, help=helptxt, rank=rlabel)
    elif kind == "memory":
        for field, metric in (
            ("bytes_in_use", "live_hbm_bytes"),
            ("peak_bytes_in_use", "live_hbm_peak_bytes"),
            ("bytes_limit", "live_hbm_limit_bytes"),
        ):
            v = rec.get(field)
            if isinstance(v, (int, float)):
                registry.gauge(
                    metric, v,
                    help=f"device memory {field} (allocator view)",
                    rank=rlabel,
                )
    elif kind == "request":
        registry.counter(
            "live_serving_requests_total",
            help="terminal serving requests",
            state=str(rec.get("state", "?")),
        )
        for field, metric in (
            ("total_s", "live_serving_total_seconds"),
            ("queue_s", "live_serving_queue_seconds"),
            ("decode_s", "live_serving_decode_seconds"),
        ):
            v = rec.get(field)
            if isinstance(v, (int, float)):
                registry.observe(
                    metric, v, help=f"serving request {field} (rolling)"
                )
        decode = rec.get("decode_s")
        tokens = rec.get("tokens_generated")
        if (
            isinstance(decode, (int, float))
            and isinstance(tokens, int)
            and tokens > 0
        ):
            registry.observe(
                "live_serving_decode_ms_per_token", 1e3 * decode / tokens,
                help="per-token decode latency (rolling)",
            )
    elif kind == "kv_pool":
        # paged-KV pool occupancy (PagedEngine): free blocks are a live
        # gauge; the sharing/COW ledgers are engine-lifetime totals carried
        # as gauges-of-counters (each sample supersedes the last)
        for field, metric, helptxt in (
            ("blocks_free", "live_kv_blocks_free",
             "free KV blocks in the paged pool"),
            ("blocks_used", "live_kv_blocks_used",
             "allocated KV blocks in the paged pool"),
            ("blocks_shared", "live_kv_blocks_shared",
             "KV blocks with refcount > 1 (prefix-shared)"),
            ("pool_bytes", "live_kv_pool_bytes",
             "device bytes of the paged KV block pool"),
            ("prefix_hits_total", "live_kv_prefix_hits_total",
             "admissions served from the prefix index (lifetime)"),
            ("cow_copies_total", "live_kv_cow_copies_total",
             "copy-on-write block copies (lifetime)"),
            ("admissions_deferred_total", "live_kv_admissions_deferred_total",
             "admissions deferred for lack of free blocks (lifetime)"),
        ):
            v = rec.get(field)
            if isinstance(v, (int, float)):
                registry.gauge(metric, v, help=helptxt, rank=rlabel)
    elif kind == "autoscale":
        registry.counter(
            "live_autoscale_events_total",
            help="serving autoscaler actions",
            direction=str(rec.get("direction", "?")),
            reason=str(rec.get("reason", "?")),
        )
        workers = rec.get("workers")
        if isinstance(workers, (int, float)):
            registry.gauge(
                "live_serving_workers", float(workers),
                help="spool workers currently in the serving pool",
            )
    elif kind == "alert":
        registry.counter(
            "live_alerts_total",
            help="alerts observed in the event stream",
            alert=str(rec.get("alert", "?")),
            severity=str(rec.get("severity", "?")),
        )
    elif kind == "failure":
        registry.counter(
            "live_failures_total",
            help="failure-domain events observed",
            kind=str(rec.get("kind", "?")),
        )
    elif kind == "job":
        registry.counter(
            "live_fleet_jobs_total",
            help="fleet job lifecycle transitions",
            state=str(rec.get("state", "?")),
            job_kind=str(rec.get("kind", "?")),
        )
        world = rec.get("world")
        if rec.get("state") in ("started", "resumed") and isinstance(
            world, (int, float)
        ):
            registry.gauge(
                "live_fleet_job_world", world,
                help="chips currently granted to the job",
                job=str(rec.get("job_id", "?")),
            )
        elif rec.get("state") in ("parked", "completed", "failed"):
            registry.gauge(
                "live_fleet_job_world", 0,
                help="chips currently granted to the job",
                job=str(rec.get("job_id", "?")),
            )
    elif kind == "partition":
        # the geo plane: cross-site partition lifecycle. partition_active
        # flips 1 on "partitioned"/"local" and back to 0 on "rejoin";
        # outer staleness (site-local steps accrued against the
        # divergence budget) is the gauge HealthMonitor's staleness
        # detector consumes.
        phase = str(rec.get("phase", "?"))
        registry.counter(
            "live_partition_events_total",
            help="typed cross-site partition events",
            phase=phase,
        )
        registry.gauge(
            "live_partition_active", 0.0 if phase == "rejoin" else 1.0,
            help="1 while training is degraded to site-local steps",
            rank=rlabel,
        )
        steps_local = rec.get("local_steps")
        if isinstance(steps_local, (int, float)):
            registry.gauge(
                "live_outer_staleness_steps", float(steps_local),
                help="site-local steps accrued since the last applied"
                     " outer sync (the divergence budget's numerator)",
                rank=rlabel,
            )
        budget = rec.get("max_local_steps")
        if isinstance(budget, (int, float)):
            registry.gauge(
                "live_outer_staleness_budget_steps", float(budget),
                help="site-local divergence budget (--max-local-steps)",
                rank=rlabel,
            )
    elif kind == "preempt":
        registry.counter(
            "live_fleet_preemptions_total",
            help="scheduler preemptions (victim chips reclaimed)",
            reason=str(rec.get("reason", "?")),
        )
    elif kind == "job_failed":
        registry.counter(
            "live_fleet_quarantines_total",
            help="jobs quarantined after exhausting their strike budget",
            job_kind=str(rec.get("kind", "?")),
        )


class MetricSink(Sink):
    """In-process adapter: feed a registry straight from a Telemetry's
    event stream (the per-rank live view — e.g. the serving engine keeps
    one so its SLO split is scrapeable without a run dir)."""

    def __init__(self, registry: Optional[MetricRegistry] = None):
        self.registry = registry or MetricRegistry()

    def emit(self, event: Event, record: Dict) -> None:
        ingest_record(self.registry, record)


# ---------------------------------------------------------------------------
# resumable shard tailing
# ---------------------------------------------------------------------------


class ShardFollower:
    """Incremental reader of one JSONL shard. ``poll()`` returns the newly
    completed records since the last poll; ``offset`` is a plain byte
    position that can be persisted and handed to a future follower to
    resume exactly-once. Torn/undecodable COMPLETE lines are counted in
    ``torn``; a half-written tail is simply not consumed yet."""

    def __init__(self, path: str, offset: int = 0):
        self.path = path
        self.offset = int(offset)
        self.torn = 0

    def poll(self) -> List[Dict]:
        try:
            events, self.offset, skipped = runlog.read_shard_from(
                self.path, self.offset
            )
        except OSError:
            return []
        self.torn += skipped
        return events


class AlertFeed:
    """Worker-side tail of the run's ``alerts.jsonl`` feedback channel.
    ``poll()`` returns new alert records (dicts); callers hand the
    relevant ones to ``FallbackController.nudge``."""

    def __init__(self, run_dir: str):
        self._follower = ShardFollower(os.path.join(run_dir, runlog.ALERTS_LOG))

    def poll(self) -> List[Dict]:
        return [
            r for r in self._follower.poll() if r.get("event") == "alert"
        ]


def append_alert(run_dir: str, record: Dict) -> None:
    """Append one alert record to the run's feedback channel (supervisor
    side). Plain line-buffered append: followers only consume complete
    lines, so a torn write is retried, never split."""
    path = os.path.join(run_dir, runlog.ALERTS_LOG)
    with open(path, "a") as f:
        f.write(json.dumps(record, default=str) + "\n")


# ---------------------------------------------------------------------------
# the supervisor-side aggregator
# ---------------------------------------------------------------------------


class _ShardClock:
    """Incremental form of merge_run's per-shard alignment state: the
    current run_start marker, its manifest spawn time, and the wall-clock
    offset fallback."""

    def __init__(self):
        self.marker: Optional[Dict] = None
        self.spawn: Optional[float] = None
        self.offset: Optional[float] = None
        self.incarnations = 0


class LiveAggregator:
    """Follow every shard of a live run directory, feed the registry and
    the health detectors, and fire alerts. All ordering/windowing is event
    time (the skew-corrected run clock); ``poll()`` is cheap enough for
    the supervisor's 100 ms loop."""

    def __init__(
        self,
        run_dir: str,
        registry: Optional[MetricRegistry] = None,
        monitor: Optional[HealthMonitor] = None,
        detector_config: Optional[DetectorConfig] = None,
        window_s: float = 10.0,
    ):
        self.run_dir = run_dir
        self.registry = registry or MetricRegistry()
        self.monitor = monitor or HealthMonitor(detector_config)
        self.window_s = float(window_s)
        self.alerts: List[AlertEvent] = []
        self.manifest: Optional[runlog.RunManifest] = None
        self._followers: Dict[str, ShardFollower] = {}
        self._rank_of: Dict[str, Optional[int]] = {}
        self._clocks: Dict[str, _ShardClock] = {}
        self._startup_deltas: List[float] = []
        # steady-state step times per rank (first timed step per
        # incarnation dropped — mirrors analytics.rank_step_stats)
        self._steady: Dict[int, List[float]] = {}
        self._pending_first: Dict[Tuple[int, int], bool] = {}
        self._ledger: Dict[Tuple, Dict] = {}  # deduped collective records
        self._overlap: Optional[Dict] = None
        # per-rank exposed-comm span waits: rank r's collective-wait spans
        # price its OUTGOING ring edge (r, (r+1) mod W), the same charging
        # rule observe.fabric and observe.critpath use
        self._comm_waits: Dict[int, List[float]] = {}
        self._step_times: deque = deque()  # (t_run, rank) of steps, windowed
        self._now: Optional[float] = None  # max observed run time

    # -- discovery ---------------------------------------------------------

    def _reload_manifest(self) -> None:
        try:
            self.manifest = runlog.RunManifest.load(self.run_dir)
        except (OSError, ValueError, json.JSONDecodeError):
            pass

    def discover(self) -> None:
        """Pick up shards that appeared since the last poll (a freshly
        spawned rank, the supervisor's own log)."""
        self._reload_manifest()
        names: List[str] = []
        try:
            names = sorted(os.listdir(self.run_dir))
        except OSError:
            return
        sup = (
            self.manifest.supervisor_log
            if self.manifest is not None
            else runlog.SUPERVISOR_LOG
        )
        for name in names:
            if name in self._followers:
                continue
            rank: Optional[int] = None
            if name == sup:
                rank = None
            elif name.startswith("events_rank") and name.endswith(".jsonl"):
                try:
                    rank = int(name[len("events_rank"):-len(".jsonl")])
                except ValueError:
                    continue
            else:
                continue
            self._followers[name] = ShardFollower(
                os.path.join(self.run_dir, name)
            )
            self._rank_of[name] = rank
            self._clocks[name] = _ShardClock()

    # -- offset persistence ------------------------------------------------

    def save_offsets(self, path: str) -> None:
        rec = {name: f.offset for name, f in self._followers.items()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)

    def load_offsets(self, path: str) -> None:
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError, json.JSONDecodeError):
            return
        self.discover()
        for name, offset in rec.items():
            if name in self._followers and isinstance(offset, int):
                self._followers[name].offset = offset

    # -- clock -------------------------------------------------------------

    def _startup(self) -> float:
        if not self._startup_deltas:
            return 0.0
        return analytics.percentile(self._startup_deltas, 50)

    def _run_time(self, name: str, rec: Dict) -> Optional[float]:
        """Place one record on the supervisor's clock — the incremental
        twin of merge_run's alignment (monotonic delta from the current
        marker, wall-offset fallback, raw wall clock last)."""
        if self._rank_of[name] is None:
            ts = rec.get("ts")
            return float(ts) if isinstance(ts, (int, float)) else None
        clock = self._clocks[name]
        if runlog._is_run_start(rec):
            clock.marker = rec
            clock.incarnations += 1
            if self.manifest is None or rec.get("incarnation") is None:
                self._reload_manifest()
            clock.spawn = (
                self.manifest.spawn_time(
                    self._rank_of[name], rec.get("incarnation")
                )
                if self.manifest is not None
                else None
            )
            clock.offset = None
            if clock.spawn is not None and isinstance(
                rec.get("ts"), (int, float)
            ):
                delta = rec["ts"] - clock.spawn
                self._startup_deltas.append(delta)
                clock.offset = delta - self._startup()
        marker = clock.marker
        if (
            marker is not None
            and clock.spawn is not None
            and isinstance(marker.get("ts_mono"), (int, float))
            and isinstance(rec.get("ts_mono"), (int, float))
        ):
            return clock.spawn + self._startup() + (
                rec["ts_mono"] - marker["ts_mono"]
            )
        if clock.offset is not None and isinstance(rec.get("ts"), (int, float)):
            return rec["ts"] - clock.offset
        ts = rec.get("ts")
        return float(ts) if isinstance(ts, (int, float)) else None

    # -- ingest ------------------------------------------------------------

    def _fire(self, alerts: List[AlertEvent]) -> List[AlertEvent]:
        for a in alerts:
            self.alerts.append(a)
            self.registry.counter(
                "live_alerts_fired_total",
                help="alerts fired by the live detectors",
                alert=a.alert,
                severity=a.severity,
            )
        return alerts

    def _ingest(self, name: str, rec: Dict) -> List[AlertEvent]:
        rank = self._rank_of[name]
        t = self._run_time(name, rec)
        if t is not None:
            self._now = t if self._now is None else max(self._now, t)
        ingest_record(self.registry, rec, rank=rank)
        fired: List[AlertEvent] = []
        kind = rec.get("event")
        r = rec.get("rank", rank)
        if kind == "step" and rank is not None:
            dt = rec.get("step_time_s")
            if rec.get("valid", True) and isinstance(dt, (int, float)):
                key = (rank, self._clocks[name].incarnations)
                if self._pending_first.setdefault(key, True):
                    # first timed step of this incarnation pays compile;
                    # report drops it from steady-state, so do we
                    self._pending_first[key] = False
                else:
                    self._steady.setdefault(rank, []).append(float(dt))
                    fired += self.monitor.observe_step_time(
                        float(dt), rank=r, step=rec.get("step")
                    )
                if t is not None:
                    self._step_times.append((t, rank))
            loss = rec.get("loss")
            if isinstance(loss, (int, float)):
                fired += self.monitor.observe_loss(
                    float(loss), step=rec.get("step")
                )
        elif kind == "collective":
            key = (
                rec.get("label"), rec.get("tag"), rec.get("op"), rec.get("dtype")
            )
            if isinstance(rec.get("payload_bytes"), (int, float)):
                self._ledger.setdefault(key, dict(rec))
        elif kind == "compile" and self._overlap is None:
            ov = rec.get("overlap")
            if isinstance(ov, dict) and ov:
                self._overlap = ov
        elif kind == "span" and rank is not None:
            dur = rec.get("dur_s")
            if (
                isinstance(dur, (int, float))
                and dur >= 0
                and "comm" in str(rec.get("name") or "")
            ):
                self._comm_waits.setdefault(rank, []).append(float(dur))
        elif kind == "train_health":
            gn = rec.get("grad_norm")
            if isinstance(gn, (int, float)):
                fired += self.monitor.observe_grad_norm(
                    float(gn), rank=r, step=rec.get("step")
                )
        elif kind == "fidelity":
            group = str(rec.get("group", "?"))
            rel = rec.get("rel_error")
            ef = rec.get("ef_norm")
            if isinstance(rel, (int, float)):
                fired += self.monitor.observe_fidelity(
                    group, float(rel), rank=r, step=rec.get("step")
                )
            if isinstance(ef, (int, float)):
                fired += self.monitor.observe_ef_norm(
                    group, float(ef), rank=r, step=rec.get("step")
                )
        elif kind == "memory":
            in_use = rec.get("bytes_in_use")
            limit = rec.get("bytes_limit")
            if isinstance(in_use, (int, float)) and isinstance(
                limit, (int, float)
            ):
                fired += self.monitor.observe_hbm(
                    float(in_use), float(limit), rank=r, step=rec.get("step")
                )
        elif kind == "partition":
            # the outer-staleness gauge feeds the budget-burn detector;
            # a rejoin resets the stretch to zero observations naturally
            # (local_steps drops back) — only live burn is observed here
            steps_local = rec.get("local_steps")
            budget = rec.get("max_local_steps")
            if (
                rec.get("phase") in ("partitioned", "local")
                and isinstance(steps_local, (int, float))
                and isinstance(budget, (int, float))
            ):
                fired += self.monitor.observe_outer_staleness(
                    float(steps_local), float(budget),
                    rank=r, step=rec.get("step"),
                )
        return self._fire(fired)

    # -- derived gauges ----------------------------------------------------

    def step_p50_s(self) -> Optional[float]:
        """Cross-rank median of per-rank steady-state p50 step time — the
        same statistic run_report publishes as ``step_p50_s``."""
        p50s = [
            analytics.percentile(d, 50) for d in self._steady.values() if d
        ]
        return analytics.percentile(p50s, 50) if p50s else None

    def bandwidth(self) -> Optional[Dict]:
        """``analytics.effective_bandwidth`` over the live deduped ledger
        at the live steady-state p50 — the report's achieved-bytes/s."""
        p50 = self.step_p50_s()
        if not p50 or not self._ledger:
            return None
        world = self.manifest.world_size if self.manifest is not None else 1
        return analytics.effective_bandwidth(
            p50, list(self._ledger.values()), world, overlap=self._overlap
        )

    def edge_rates(self) -> Dict[Tuple[int, int], float]:
        """Effective per-edge wire rate off the live evidence: the deduped
        ledger's per-step ring-link bytes over each src rank's p50 exposed
        comm wait (first wait per rank dropped as warmup). Empty when the
        run has no comm spans or no ledger."""
        world = self.manifest.world_size if self.manifest is not None else 1
        if world < 2 or not self._ledger or not self._comm_waits:
            return {}
        per_step_bytes = sum(
            float(rec.get("payload_bytes") or 0.0)
            for rec in self._ledger.values()
        )
        if per_step_bytes <= 0:
            return {}
        per_edge_bytes = 2.0 * (world - 1) / world * per_step_bytes
        out: Dict[Tuple[int, int], float] = {}
        for src, dst in ring_neighbors(world):
            waits = self._comm_waits.get(src) or []
            eligible = waits[1:] if len(waits) > 1 else waits
            if not eligible:
                continue
            p50 = analytics.percentile(eligible, 50)
            if p50 and p50 > 0:
                out[(src, dst)] = per_edge_bytes / p50
        return out

    def _refresh_gauges(self) -> List[AlertEvent]:
        fired: List[AlertEvent] = []
        p50 = self.step_p50_s()
        if p50 is not None:
            self.registry.gauge(
                "live_step_time_p50_seconds", p50,
                help="cross-rank steady-state p50 step time",
            )
            p99s = [
                analytics.percentile(d, 99)
                for d in self._steady.values() if d
            ]
            if p99s:
                self.registry.gauge(
                    "live_step_time_p99_seconds",
                    max(p99s),
                    help="worst-rank steady-state p99 step time",
                )
        # event-time step rate over the trailing window
        if self._now is not None:
            lo = self._now - self.window_s
            while self._step_times and self._step_times[0][0] < lo:
                self._step_times.popleft()
            span = min(
                self.window_s,
                (self._now - self._step_times[0][0]) if self._step_times else 0.0,
            )
            if span > 0 and len(self._step_times) > 1:
                self.registry.gauge(
                    "live_step_rate_per_s",
                    len(self._step_times) / span,
                    help="steps/s across ranks (event-time window)",
                )
        bw = self.bandwidth()
        if bw is not None:
            achieved = bw["total"]["achieved_bytes_per_s"]
            self.registry.gauge(
                "live_comm_bytes_per_s", achieved,
                help="achieved wire rate at live steady-state p50",
            )
            for fabric, util in bw["total"]["utilization"].items():
                self.registry.gauge(
                    "live_fabric_utilization", util,
                    help="achieved rate / fabric line rate",
                    fabric=fabric,
                )
            fired += self.monitor.observe_bytes_per_s(achieved)
        for (src, dst), rate in sorted(self.edge_rates().items()):
            self.registry.gauge(
                "live_edge_bytes_per_s", rate,
                help="effective per-ring-edge wire rate (ledger bytes over"
                     " the src rank's p50 exposed comm wait)",
                edge=f"{src}->{dst}",
            )
            # per-edge collapse detection: the alert names the edge and
            # blames the src rank, not just the run
            fired += self.monitor.observe_bytes_per_s(rate, edge=(src, dst))
        hist = self.registry.get_histogram("live_serving_total_seconds")
        if hist is not None and len(hist):
            p99 = hist.percentile(99)
            self.registry.gauge(
                "live_serving_p99_total_seconds", p99,
                help="rolling p99 end-to-end serving latency",
            )
            fired += self.monitor.observe_serving_p99(p99)
        torn = sum(f.torn for f in self._followers.values())
        self.registry.gauge(
            "live_torn_lines_total", torn,
            help="incomplete/undecodable shard lines seen so far",
        )
        return self._fire(fired)

    def poll(self) -> List[AlertEvent]:
        """Drain every follower, update metrics and detectors, and return
        the alerts that fired during THIS poll."""
        self.discover()
        fired: List[AlertEvent] = []
        ingested = 0
        for name in sorted(self._followers):
            for rec in self._followers[name].poll():
                if not isinstance(rec, dict):
                    continue
                fired += self._ingest(name, rec)
                ingested += 1
        if ingested:
            # derived gauges (and their detectors) advance on EVENTS, not
            # on idle polls — the detector sustain/cooldown counters stay
            # meaningful at any poll frequency
            fired += self._refresh_gauges()
        return fired


# ---------------------------------------------------------------------------
# the exposition server
# ---------------------------------------------------------------------------


class MetricsHTTPServer:
    """``GET /metrics`` (Prometheus text 0.0.4) + ``GET /healthz`` on a
    stdlib ThreadingHTTPServer daemon thread. ``port=0`` binds an
    ephemeral port; the bound port is in ``.port`` and can be advertised
    with :meth:`write_port_file` so scrapers never race the bind."""

    def __init__(
        self,
        registry_or_render,
        port: int = 0,
        host: str = "127.0.0.1",
    ):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        if isinstance(registry_or_render, MetricRegistry):
            render: Callable[[], str] = registry_or_render.render_prometheus
        else:
            render = registry_or_render

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(handler):  # noqa: N805 - http.server API
                if handler.path.split("?", 1)[0] == "/metrics":
                    body = render().encode("utf-8")
                    handler.send_response(200)
                    handler.send_header("Content-Type", _EXPOSITION_CONTENT_TYPE)
                elif handler.path == "/healthz":
                    body = b"ok\n"
                    handler.send_response(200)
                    handler.send_header("Content-Type", "text/plain")
                else:
                    body = b"not found\n"
                    handler.send_response(404)
                    handler.send_header("Content-Type", "text/plain")
                handler.send_header("Content-Length", str(len(body)))
                handler.end_headers()
                handler.wfile.write(body)

            def log_message(handler, fmt, *args):  # silence per-request lines
                pass

        self._server = ThreadingHTTPServer((host, int(port)), _Handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = int(self._server.server_address[1])
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="metrics-exposition",
            daemon=True,
        )

    def start(self) -> "MetricsHTTPServer":
        self._thread.start()
        return self

    def write_port_file(self, run_dir: str) -> str:
        path = os.path.join(run_dir, runlog.METRICS_PORT_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(self.port))
        os.replace(tmp, path)
        return path

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)


def read_port_file(run_dir: str) -> Optional[int]:
    """The bound /metrics port the supervisor advertised for this run, or
    None when no exposition server is (yet) up."""
    try:
        with open(os.path.join(run_dir, runlog.METRICS_PORT_NAME)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None
