"""Run-level telemetry: the manifest + the cross-rank shard merger. The
port's own copy of the JAX package's ``observe/runlog.py``: the constants,
the manifest's JSON and the merge are the same, so a run directory reads
the same in both packages.

The telemetry core is strictly per-process: one JSONL shard per rank. A
supervised multi-rank run needs a RUN-level view — one wall-clock-ordered
timeline across every rank and incarnation — and that requires solving two
problems this module owns:

**Clock alignment.** Each rank stamps events with its own wall clock; across
hosts those clocks disagree. The supervisor records the spawn time of every
(rank, incarnation) in the manifest using ITS clock, and every shard leads
with a ``run_start`` :class:`observe.events.MarkerEvent` carrying the
worker's (``ts``, ``ts_mono``) pair at telemetry creation. The per-spawn
delta ``marker.ts − spawned_unix`` is startup latency *plus* that rank's
clock offset; assuming startup latency is roughly equal across ranks (they
run the same interpreter and imports), the cross-spawn **median** delta
estimates the shared startup latency, and each spawn's deviation from it is
its clock offset. Events are then placed on the supervisor's clock as
``spawned_unix + startup + (event.ts_mono − marker.ts_mono)`` — monotonic
deltas, immune to wall-clock steps — with ``event.ts − offset`` as the
fallback for records lacking ``ts_mono``. The supervisor's own shard needs
no correction (it IS the reference clock).

**Torn tails.** A SIGKILLed rank's final JSONL line is legitimately
half-written. The shard loader skips undecodable lines and COUNTS them —
the count is surfaced in the merged timeline and the run report instead of
either raising or silently pretending the log is whole.

torch-free and resilience-free: ``resilience.supervisor`` imports observe,
so the worker env-var names of its contract are duplicated here as literals
rather than imported back.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .events import MarkerEvent

# run env exported by the supervisor to every worker (and by launch.py for
# manual --run-dir workers); presence of ENV_RUN_ID is what makes
# telemetry_for_run auto-emit the run_start marker
ENV_RUN_DIR = "RUNLOG_RUN_DIR"
ENV_RUN_ID = "RUNLOG_RUN_ID"
# resilience.supervisor's worker env contract, duplicated literally so the
# observe layer (which resilience imports) never imports resilience back
_ENV_RANK = "RESILIENCE_RANK"
_ENV_WORLD = "RESILIENCE_WORLD"
_ENV_INCARNATION = "RESILIENCE_INCARNATION"

MANIFEST_NAME = "run.json"
SUPERVISOR_LOG = "events_supervisor.jsonl"
# the control-plane feedback channel: the supervisor appends every fired
# AlertEvent record here, and in-run followers (toy worker, adaptive train
# loop) tail it with read_shard_from to nudge the FallbackController
# mid-epoch. Plain JSONL, same torn-tail tolerance as the shards.
ALERTS_LOG = "alerts.jsonl"
# the supervisor writes the BOUND /metrics port here once the exposition
# server is listening (metrics_port=0 binds an ephemeral port), so probes
# and dashboards can discover the endpoint without racing the bind
METRICS_PORT_NAME = "metrics_port"
SCHEMA = 1


def shard_name(rank: int) -> str:
    return f"events_rank{rank}.jsonl"


def shard_path(run_dir: str, rank: int) -> str:
    return os.path.join(run_dir, shard_name(rank))


def default_run_id(run_dir: str) -> str:
    """A stable id derived from the run directory, so every manually
    launched rank of the same ``--run-dir`` derives the same id."""
    return os.path.basename(os.path.normpath(run_dir)) or "run"


def _env_int(env: Dict[str, str], key: str) -> Optional[int]:
    try:
        return int(env[key])
    except (KeyError, TypeError, ValueError):
        return None


def shard_event_log_from_env(env=None) -> Optional[str]:
    """This rank's shard path, when the process is part of a managed run
    (supervisor env present); None otherwise."""
    env = os.environ if env is None else env
    run_dir = env.get(ENV_RUN_DIR)
    rank = _env_int(env, _ENV_RANK)
    if not run_dir or rank is None:
        return None
    return shard_path(run_dir, rank)


def run_marker_from_env(env=None) -> Optional[MarkerEvent]:
    """The ``run_start`` marker for this process, built from the run env —
    None when the process is not a rank of a managed run."""
    env = os.environ if env is None else env
    run_id = env.get(ENV_RUN_ID)
    if not run_id:
        return None
    return MarkerEvent(
        kind="run_start",
        run_id=run_id,
        rank=_env_int(env, _ENV_RANK),
        world_size=_env_int(env, _ENV_WORLD),
        incarnation=_env_int(env, _ENV_INCARNATION),
    )


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------


@dataclass
class RunManifest:
    """What the supervisor knows about the run: identity, world size, the
    per-rank shard layout, and one spawn record per (rank, incarnation)
    with the PARENT-clock spawn time the merger aligns against. Saved
    atomically on every spawn so a crashed supervisor leaves a readable
    manifest."""

    run_id: str
    world_size: int
    created_unix: float
    shards: Dict[int, str] = field(default_factory=dict)
    incarnations: Dict[int, int] = field(default_factory=dict)  # spawns/rank
    spawns: List[Dict] = field(default_factory=list)
    supervisor_log: str = SUPERVISOR_LOG
    schema: int = SCHEMA

    def record_spawn(
        self, rank: int, incarnation: int, world_size: int, spawned_unix: float
    ) -> None:
        self.shards[rank] = shard_name(rank)
        self.incarnations[rank] = max(
            self.incarnations.get(rank, 0), incarnation + 1
        )
        self.spawns.append(
            {
                "rank": rank,
                "incarnation": incarnation,
                "world_size": world_size,
                "spawned_unix": spawned_unix,
            }
        )

    def spawn_time(self, rank: int, incarnation) -> Optional[float]:
        for s in self.spawns:
            if s["rank"] == rank and s["incarnation"] == incarnation:
                return s["spawned_unix"]
        return None

    def save(self, run_dir: str) -> str:
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, MANIFEST_NAME)
        rec = {
            "schema": self.schema,
            "run_id": self.run_id,
            "world_size": self.world_size,
            "created_unix": self.created_unix,
            "supervisor_log": self.supervisor_log,
            "shards": {str(r): name for r, name in sorted(self.shards.items())},
            "incarnations": {
                str(r): n for r, n in sorted(self.incarnations.items())
            },
            "spawns": self.spawns,
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f, indent=1)
        os.replace(tmp, path)
        return path

    @staticmethod
    def load(run_dir: str) -> "RunManifest":
        path = os.path.join(run_dir, MANIFEST_NAME)
        with open(path) as f:
            rec = json.load(f)
        return RunManifest(
            run_id=rec.get("run_id", ""),
            world_size=int(rec.get("world_size", 0)),
            created_unix=float(rec.get("created_unix", 0.0)),
            shards={int(r): n for r, n in rec.get("shards", {}).items()},
            incarnations={
                int(r): int(n) for r, n in rec.get("incarnations", {}).items()
            },
            spawns=list(rec.get("spawns", [])),
            supervisor_log=rec.get("supervisor_log", SUPERVISOR_LOG),
            schema=int(rec.get("schema", SCHEMA)),
        )


def new_manifest(run_id: str, world_size: int) -> RunManifest:
    return RunManifest(
        run_id=run_id, world_size=world_size, created_unix=time.time()
    )


# ---------------------------------------------------------------------------
# shard loading + the merger
# ---------------------------------------------------------------------------


def load_shard(path: str) -> Tuple[List[Dict], int]:
    """Parse one JSONL shard, skipping (and counting) lines that are not
    JSON objects — foreign stdout, and the half-written final line of a
    SIGKILLed rank."""
    events: List[Dict] = []
    skipped = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if isinstance(rec, dict):
                events.append(rec)
            else:
                skipped += 1
    return events, skipped


def read_shard_from(path: str, offset: int = 0) -> Tuple[List[Dict], int, int]:
    """The resumable form of :func:`load_shard`: parse the shard from byte
    ``offset``, consuming only newline-TERMINATED lines, and return
    ``(events, new_offset, skipped)``.

    ``new_offset`` always points just past the last consumed newline, so a
    half-written trailing line (a live writer mid-``write``, or the torn
    tail of a SIGKILLed rank) is left UNCONSUMED — the next poll re-reads
    it once its newline lands, which is what makes incremental tailing
    duplicate-free AND drop-free. Complete lines that still fail to decode
    (foreign stdout interleaved into the shard) are skipped and counted,
    exactly like :func:`load_shard`. A shard that shrank below ``offset``
    (never the case for append-only runlog shards, but possible for a
    recreated file) resets the follower to the start of the file.

    Offsets are plain byte positions: persist them (``json.dump``) and a
    restarted follower resumes with ``read_shard_from(path, saved_offset)``
    seeing every event exactly once.
    """
    events: List[Dict] = []
    skipped = 0
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size < offset:
            offset = 0  # file was truncated/recreated: start over
        f.seek(offset)
        chunk = f.read(size - offset)
    end = chunk.rfind(b"\n")
    if end < 0:
        return [], offset, 0  # no complete line yet
    new_offset = offset + end + 1
    for raw in chunk[: end + 1].split(b"\n"):
        line = raw.strip()
        if not line:
            continue
        try:
            rec = json.loads(line.decode("utf-8", errors="replace"))
        except json.JSONDecodeError:
            skipped += 1
            continue
        if isinstance(rec, dict):
            events.append(rec)
        else:
            skipped += 1
    return events, new_offset, skipped


def _percentile(values: List[float], p: float) -> float:
    if not values:
        return float("nan")
    ordered = sorted(values)
    k = max(0, min(len(ordered) - 1, round(p / 100 * (len(ordered) - 1))))
    return ordered[int(k)]


def _is_run_start(e: Dict) -> bool:
    return e.get("event") == "marker" and e.get("kind") == "run_start"


@dataclass
class MergedRun:
    """One run's cross-rank timeline. ``events`` is ordered by ``t_run``
    (supervisor-clock time; events with no timestamp sort last), and every
    event carries a ``rank`` (None = the supervisor's own shard)."""

    manifest: RunManifest
    events: List[Dict]
    per_rank: Dict[int, Dict]
    torn_lines: int
    startup_s: float  # the cross-spawn median marker-minus-spawn estimate
    # the merge-tolerance bound every stitched cross-rank comparison
    # inherits: the worst per-spawn deviation from the shared startup
    # median. Two ranks' t_run values closer than this are NOT ordered
    # facts: a cross-rank analysis quotes this number instead of
    # pretending bitwise alignment.
    clock_skew_bound_s: float = 0.0


def merge_run(run_dir: str, manifest: Optional[RunManifest] = None) -> MergedRun:
    """Merge a run directory's rank shards (plus the supervisor's shard)
    into one supervisor-clock-ordered timeline. See the module docstring
    for the alignment model; per-rank clock offsets land in ``per_rank``."""
    manifest = manifest if manifest is not None else RunManifest.load(run_dir)
    shard_events: Dict[int, List[Dict]] = {}
    per_rank: Dict[int, Dict] = {}
    torn_total = 0
    for rank, name in sorted(manifest.shards.items()):
        path = os.path.join(run_dir, name)
        try:
            evs, skipped = load_shard(path)
        except OSError:
            per_rank[rank] = {
                "events": 0, "torn_lines": 0, "markers": 0,
                "clock_offset_s": 0.0, "missing": True,
            }
            continue
        shard_events[rank] = evs
        torn_total += skipped
        per_rank[rank] = {
            "events": len(evs),
            "torn_lines": skipped,
            "markers": sum(1 for e in evs if _is_run_start(e)),
            "clock_offset_s": 0.0,
        }

    # shared startup-latency estimate: median over every (rank, incarnation)
    # of (marker wall time − parent-clock spawn time); each spawn's
    # deviation from it is that rank's clock offset
    deltas: List[float] = []
    for rank, evs in shard_events.items():
        for e in evs:
            if not _is_run_start(e):
                continue
            spawn = manifest.spawn_time(rank, e.get("incarnation"))
            if spawn is not None and isinstance(e.get("ts"), (int, float)):
                deltas.append(e["ts"] - spawn)
    startup = _percentile(deltas, 50) if deltas else 0.0
    skew_bound = max((abs(d - startup) for d in deltas), default=0.0)

    merged: List[Tuple[Optional[float], int, Dict]] = []
    seq = 0
    for rank, evs in shard_events.items():
        # events between marker k and marker k+1 in file order belong to
        # marker k's incarnation (step records carry no incarnation field)
        marker: Optional[Dict] = None
        spawn: Optional[float] = None
        offset: Optional[float] = None
        first_offset: Optional[float] = None
        for e in evs:
            e = dict(e)
            e.setdefault("rank", rank)
            if _is_run_start(e):
                marker = e
                spawn = manifest.spawn_time(rank, e.get("incarnation"))
                offset = None
                if spawn is not None and isinstance(e.get("ts"), (int, float)):
                    offset = (e["ts"] - spawn) - startup
                    if first_offset is None:
                        first_offset = offset
            t: Optional[float] = None
            if (
                marker is not None
                and spawn is not None
                and isinstance(marker.get("ts_mono"), (int, float))
                and isinstance(e.get("ts_mono"), (int, float))
            ):
                t = spawn + startup + (e["ts_mono"] - marker["ts_mono"])
            elif offset is not None and isinstance(e.get("ts"), (int, float)):
                t = e["ts"] - offset
            elif isinstance(e.get("ts"), (int, float)):
                t = e["ts"]
            e["t_run"] = t
            merged.append((t, seq, e))
            seq += 1
        if first_offset is not None:
            per_rank[rank]["clock_offset_s"] = first_offset

    # the supervisor's own shard is already on the reference clock
    sup_path = os.path.join(run_dir, manifest.supervisor_log)
    if os.path.exists(sup_path):
        evs, skipped = load_shard(sup_path)
        torn_total += skipped
        for e in evs:
            e = dict(e)
            e.setdefault("rank", None)
            t = e.get("ts") if isinstance(e.get("ts"), (int, float)) else None
            e["t_run"] = t
            merged.append((t, seq, e))
            seq += 1

    merged.sort(key=lambda x: (x[0] is None, x[0] if x[0] is not None else 0.0, x[1]))
    return MergedRun(
        manifest=manifest,
        events=[e for _, _, e in merged],
        per_rank=per_rank,
        torn_lines=torn_total,
        startup_s=startup,
        clock_skew_bound_s=skew_bound,
    )
