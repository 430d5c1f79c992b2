"""The supervising launcher: spawn, watch, restart, degrade; and the serving
autoscaler. The JAX package's ``resilience/supervisor.py``, for workers
that are ``torch.distributed`` ranks.

The parent spawns one worker process per rank, watches exit codes and the
heartbeat directory, restarts crashed or hung ranks with a bounded,
seeded exponential backoff (a restarted worker resumes from the newest
committed checkpoint: ``utils.checkpoint.restore_latest``), and when a
rank exhausts ``max_restarts`` restarts the survivors on a shrunk world
(graceful degradation) instead of declaring the run dead. Deaths are
classified before they are handled: hard deaths of several distinct ranks
inside the correlation window are one incident (a zone outage), and the
quorum planner (:func:`plan_mesh`) replans the whole world at the largest
viable mesh with a typed ``ReshapeEvent``. A worker exiting with
``CKPT_UNWRITABLE_EXIT_CODE`` fails the run at once: restarting into a
read-only checkpoint root is a restart storm. Shutdowns are graceful
first: SIGTERM, ``term_grace_s`` for the worker's ``PreemptionGuard`` to
commit an emergency checkpoint, then SIGKILL.

Where the port differs: a ``torch.distributed`` process group cannot
admit a replacement rank, and survivors of a dead peer are stuck in its
collectives (NCCL) or raise out of them (Gloo). So at a world of one the
supervisor behaves as the JAX package's, and at a world of more than one a
rank's death restarts the whole generation:

- the deaths of a sweep, and those of the correlation window after it (a
  zone outage's ranks do not die in the same millisecond), are gathered
  before anything is restarted; a rank that exits with a code (not a
  signal) after a peer's death raised out of a collective, and counts as
  graceful;
- each survivor gets SIGTERM, then SIGKILL after ``term_grace_s``
  (``worker_term``, a graceful shutdown);
- the dead rank's restart budget is charged (``worker_restart``), every
  rank is spawned again with a new incarnation, and the generation gets a
  fresh rendezvous (:attr:`Supervisor.coordinator`, a ``file://`` store in
  a directory the supervisor owns, so no port can be taken in between).

The event kinds are the JAX package's. With a ``run_dir`` the supervisor
keeps the run's manifest (``observe.runlog``: identity, the shard layout
and a spawn time on its own clock for each rank's life), exports the run's
environment to every worker (each worker's telemetry then leads its shard
with a ``run_start`` marker), and with ``metrics_port`` it runs the live
telemetry plane (``observe.live``) in its poll loop: the aggregator tails
the shards and feeds the detectors (``detector_config``), every fired
alert goes to the supervisor's own log and to the run's ``alerts.jsonl``
(what the workers' ``AlertFeed`` reads), ``/metrics`` serves the registry
on 127.0.0.1, and ``alert_restart_after`` critical alerts of one rank kill
that rank. At a world above one that death restarts the whole generation,
like any other.

:class:`ServingAutoscaler` sizes a pool of spool-serving workers to demand
(the live plane's SLO burn and the spool's backlog), leasing a chip a
worker from a ``resilience.scheduler.FleetScheduler``.

The parent holds no card: this module imports neither torch nor anything
that does at import time, and never touches a device (an emitted event,
the run directory and the live plane import ``observe``, which imports
torch but creates no CUDA context).
"""

from __future__ import annotations

import json
import os
import random
import shutil
import signal
import subprocess
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

# environment contract with workers (read via :func:`incarnation_from_env`)
ENV_INCARNATION = "RESILIENCE_INCARNATION"
ENV_RANK = "RESILIENCE_RANK"
ENV_WORLD = "RESILIENCE_WORLD"
# JSON mesh-axes dict ({"data": D, "fsdp": F, "tensor": T}), exported only
# for mesh-shaped runs — a replanned worker reads its NEW shape from here
ENV_MESH = "RESILIENCE_MESH"
# JSON list of FLEET device ranks granted to this job (rank-subset mode):
# worker rank r of a scheduled job sits on fleet chip device_ranks[r].
# Exported only when the supervisor was constructed with a device grant —
# an exclusive-ownership launch omits it and workers assume chips 0..W-1.
ENV_DEVICE_RANKS = "RESILIENCE_DEVICE_RANKS"


def incarnation_from_env(default: int = 0) -> int:
    """Which life of this worker is running (0 = first launch; the
    supervisor increments it on every restart)."""
    try:
        return int(os.environ.get(ENV_INCARNATION, default))
    except ValueError:
        return default


def mesh_from_env() -> Optional[Dict[str, int]]:
    """The mesh shape this worker was launched at, or None for a pure-DP
    world (workers then derive everything from ``--num-processes``)."""
    raw = os.environ.get(ENV_MESH)
    if not raw:
        return None
    try:
        axes = json.loads(raw)
    except ValueError:
        return None
    if not isinstance(axes, dict):
        return None
    return {str(k): int(v) for k, v in axes.items()}


def device_ranks_from_env() -> Optional[List[int]]:
    """The fleet chip ranks this worker's job was granted, or None for an
    exclusive-ownership launch (workers then assume chips 0..W-1)."""
    raw = os.environ.get(ENV_DEVICE_RANKS)
    if not raw:
        return None
    try:
        ranks = json.loads(raw)
    except ValueError:
        return None
    if not isinstance(ranks, list):
        return None
    return [int(r) for r in ranks]


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def plan_mesh(mesh_axes: Dict[str, int], survivors: int, min_world: int = 1) -> Optional[Dict[str, int]]:
    """The quorum restart planner's policy table: the largest viable mesh
    that fits on ``survivors`` ranks, or None when no shape clears the
    ``min_world`` floor.

    Each model axis (tensor, fsdp) stays at a DIVISOR of its old degree, so
    sharded parameters re-split evenly; the data axis is free (the reshard
    layer folds or zero-pads EF memories either way). Among candidates the
    planner maximizes the world first, then trades TP degree for DP (the
    smallest tensor wins the tie, then the smallest fsdp)."""
    from .reshard import normalize_mesh_axes

    axes = normalize_mesh_axes(mesh_axes)
    if survivors < 1:
        return None
    best = None
    best_key = None
    for tensor in _divisors(axes["tensor"]):
        for fsdp in _divisors(axes["fsdp"]):
            model = tensor * fsdp
            if model > survivors:
                continue
            data = survivors // model
            world = model * data
            key = (world, -tensor, -fsdp)
            if best_key is None or key > best_key:
                best_key = key
                best = {"data": data, "fsdp": fsdp, "tensor": tensor}
    if best is None or best_key[0] < max(1, min_world):
        return None
    return best


@dataclass
class SupervisorConfig:
    max_restarts: int = 3  # per rank, per world generation
    backoff_base_s: float = 0.25
    backoff_max_s: float = 10.0
    backoff_jitter: float = 0.1  # seeded — reproducible schedules
    poll_interval_s: float = 0.1
    heartbeat_dir: Optional[str] = None
    heartbeat_timeout_s: Optional[float] = None  # None = no hang detection
    startup_grace_s: float = 60.0  # first-beat allowance after (re)spawn
    term_grace_s: float = 5.0  # SIGTERM -> SIGKILL escalation window
    allow_degraded: bool = True
    min_world_size: int = 1
    deadline_s: Optional[float] = None  # whole-run wall clock cap
    seed: int = 0
    # live telemetry plane (observe.live): None = disabled; 0 = bind an
    # ephemeral port (advertised in the run dir's metrics_port file).
    # Needs a run_dir: the aggregator tails the run's JSONL shards.
    metrics_port: Optional[int] = None
    # observe.health.DetectorConfig for the aggregator's streaming
    # detectors (None = defaults)
    detector_config: Any = None
    # kill a rank after this many CRITICAL alerts attributed to it (the
    # NaN-precursor path); the restart that follows spends the rank's
    # ordinary budget. 0 = log only.
    alert_restart_after: int = 0
    # the mesh shape the world was launched at ({"data": D, "fsdp": F,
    # "tensor": T}; None = pure DP). With a mesh, degraded restarts go
    # through the quorum planner (:func:`plan_mesh`) instead of only
    # shrinking the data axis, and workers get the shape via ENV_MESH.
    mesh_axes: Optional[Dict[str, int]] = None
    # hard deaths of >= correlated_threshold DISTINCT ranks within this
    # window are classified as one correlated incident (zone outage): the
    # planner replans the whole world at once instead of burning each
    # rank's restart budget independently.
    correlation_window_s: float = 2.0
    correlated_threshold: int = 2
    # how many times this run accepts a scheduler preemption request
    # (:meth:`Supervisor.request_preempt`) before refusing
    preemption_budget: int = 3


@dataclass
class SupervisorResult:
    success: bool
    world_size: int  # final (possibly shrunk) world
    total_restarts: int
    degraded: bool
    exit_codes: Dict[int, int] = field(default_factory=dict)
    reason: str = ""
    final_mesh: Optional[Dict[str, int]] = None  # None for pure-DP runs
    # the run ended because the scheduler reclaimed its chips (a graceful
    # SIGTERM -> committed-checkpoint -> exit-75 drain), not a failure
    preempted: bool = False


@dataclass
class _Worker:
    rank: int
    proc: subprocess.Popen
    incarnation: int
    spawned_at: float
    restarts: int = 0
    done: bool = False


class Supervisor:
    """Run ``world_size`` workers to completion, restarting as needed.

    ``argv_for_rank(rank, world_size, incarnation) -> List[str]`` builds a
    worker's command line — world_size is passed on every call because a
    degraded restart relaunches the survivors with a smaller world. While
    it runs, :attr:`coordinator` is the current generation's rendezvous
    (a ``file://`` init method in a temporary directory of the
    supervisor's own, removed when the run ends) at a world of more than
    one, and None at a world of one.
    """

    def __init__(
        self,
        argv_for_rank: Callable[[int, int, int], List[str]],
        world_size: int,
        config: Optional[SupervisorConfig] = None,
        telemetry: Any = None,
        env: Optional[Dict[str, str]] = None,
        log_dir: Optional[str] = None,
        run_dir: Optional[str] = None,
        run_id: Optional[str] = None,
        device_ranks: Optional[List[int]] = None,
    ):
        self.argv_for_rank = argv_for_rank
        self.world_size = world_size
        self.config = config or SupervisorConfig()
        self.telemetry = telemetry
        self.env = env
        self.log_dir = log_dir
        self.total_restarts = 0
        self.degraded = False
        if device_ranks is not None and len(device_ranks) != world_size:
            raise ValueError(f"device_ranks has {len(device_ranks)} entries for world_size={world_size}")
        self.device_ranks = list(device_ranks) if device_ranks else None
        self._preempt_reason: Optional[str] = None
        self.preempt_count = 0
        self._incarnations: Dict[int, int] = {}  # next incarnation per rank
        self._rng = random.Random(self.config.seed)
        self.mesh: Optional[Dict[str, int]] = None
        if self.config.mesh_axes is not None:
            from .reshard import normalize_mesh_axes

            self.mesh = normalize_mesh_axes(self.config.mesh_axes, world_size=world_size)
        # (monotonic time, rank) of recent HARD deaths — the correlated-vs-
        # independent classifier's evidence window
        self._death_log: List[tuple] = []
        self._rendezvous_dir: Optional[str] = None
        self.generation = 0  # worlds spawned so far
        self.coordinator: Optional[str] = None
        # (time of the death, time of the respawn) of each restart
        self.restart_times: List[tuple] = []
        # the run directory (observe.runlog): the manifest, with a spawn
        # record on this process's clock for each (rank, incarnation), the
        # times the shard merger aligns the workers' clocks against
        self.run_dir = run_dir
        self.run_id: Optional[str] = None
        self._manifest = None
        # the live plane (started in run(), closed in its finally): the
        # aggregator tailing the shards and the /metrics server
        self._aggregator = None
        self._metrics_server = None
        self._critical_alerts: Dict[int, int] = {}  # rank -> critical alerts
        self.metrics_port: Optional[int] = None  # the bound port once serving
        if run_dir is not None:
            from ..observe import runlog

            self.run_id = run_id or f"{runlog.default_run_id(run_dir)}.{int(time.time())}"
            self._manifest = runlog.new_manifest(self.run_id, world_size)
            self._manifest.save(run_dir)

    # -- telemetry ----------------------------------------------------------
    def _emit(self, kind: str, rank: Optional[int] = None, message: str = "",
              incarnation: Optional[int] = None) -> None:
        if self.telemetry is None:
            return
        from ..observe import FailureEvent

        self.telemetry.emit(
            FailureEvent(kind=kind, label="supervisor", message=message, rank=rank, incarnation=incarnation)
        )

    # -- process management -------------------------------------------------
    def _new_generation(self, world_size: int) -> None:
        """A fresh rendezvous for the next world (none at a world of one):
        a store file nobody has used, so nothing of a dead generation's
        group (a port, a stale file) can be met again."""
        self.generation += 1
        if world_size == 1:
            self.coordinator = None
            return
        if self._rendezvous_dir is None:
            self._rendezvous_dir = tempfile.mkdtemp(prefix="supervisor-rendezvous-")
        self.coordinator = "file://" + os.path.join(self._rendezvous_dir, f"rendezvous.{self.generation}")

    def _spawn(self, rank: int, world_size: int) -> _Worker:
        incarnation = self._incarnations.get(rank, 0)
        self._incarnations[rank] = incarnation + 1
        argv = self.argv_for_rank(rank, world_size, incarnation)
        env = dict(self.env if self.env is not None else os.environ)
        env[ENV_INCARNATION] = str(incarnation)
        env[ENV_RANK] = str(rank)
        env[ENV_WORLD] = str(world_size)
        if self.mesh is not None:
            env[ENV_MESH] = json.dumps(self.mesh)
        if self.device_ranks is not None:
            env[ENV_DEVICE_RANKS] = json.dumps(self.device_ranks)
        if self._manifest is not None:
            from ..observe import runlog

            env[runlog.ENV_RUN_DIR] = self.run_dir
            env[runlog.ENV_RUN_ID] = self.run_id
            self._manifest.record_spawn(
                rank=rank, incarnation=incarnation, world_size=world_size, spawned_unix=time.time()
            )
            self._manifest.save(self.run_dir)
        stdout = stderr = None
        if self.log_dir is not None:
            os.makedirs(self.log_dir, exist_ok=True)
            log = open(os.path.join(self.log_dir, f"rank{rank}.{incarnation}.log"), "w")
            stdout, stderr = log, subprocess.STDOUT
        proc = subprocess.Popen(argv, env=env, stdout=stdout, stderr=stderr)
        if stdout is not None:
            stdout.close()  # the child holds its own descriptor
        return _Worker(rank=rank, proc=proc, incarnation=incarnation, spawned_at=time.monotonic())

    def _spawn_world(self, world_size: int, restarts: Optional[Dict[int, int]] = None) -> Dict[int, _Worker]:
        self._new_generation(world_size)
        workers = {r: self._spawn(r, world_size) for r in range(world_size)}
        for r, n in (restarts or {}).items():
            if r in workers:
                workers[r].restarts = n
        return workers

    def _backoff(self, restarts: int) -> float:
        delay = min(self.config.backoff_base_s * (2 ** max(0, restarts - 1)), self.config.backoff_max_s)
        return delay * (1.0 + self.config.backoff_jitter * self._rng.random())

    def _read_beat(self, rank: int) -> Optional[Dict]:
        # HeartbeatMonitor's file layout, read without importing it
        path = os.path.join(self.config.heartbeat_dir, f"heartbeat_{rank}.json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _is_hung(self, w: _Worker) -> bool:
        cfg = self.config
        if cfg.heartbeat_dir is None or cfg.heartbeat_timeout_s is None:
            return False
        age = time.monotonic() - w.spawned_at
        beat = self._read_beat(w.rank)
        # a beat from a PREVIOUS incarnation is the dead predecessor's file,
        # not evidence of life — this is what the incarnation field is for
        if beat is None or beat.get("incarnation", 0) != w.incarnation:
            return age > cfg.startup_grace_s + cfg.heartbeat_timeout_s
        return time.time() - beat.get("ts", 0.0) > cfg.heartbeat_timeout_s

    def _kill(self, w: _Worker) -> str:
        """Graceful-first shutdown: SIGTERM, wait ``term_grace_s`` for the
        worker to commit its emergency checkpoint and exit (the
        ``PreemptionGuard`` contract), SIGKILL only on overstay. Returns
        ``"graceful"`` or ``"hard"`` — how the worker actually died."""
        try:
            w.proc.terminate()
            try:
                w.proc.wait(timeout=max(0.0, self.config.term_grace_s))
                return "graceful"
            except subprocess.TimeoutExpired:
                pass
            w.proc.kill()
            w.proc.wait(timeout=10)
        except (OSError, subprocess.TimeoutExpired):
            pass
        return "hard"

    def _kill_all(self, workers: List[_Worker]) -> Dict[int, str]:
        """:meth:`_kill` of several workers at once: every one gets SIGTERM,
        then one ``term_grace_s`` for them all, then SIGKILL for those
        still there, so a world's shutdown costs one grace, not one a rank.
        Returns how each died, by rank."""
        deadline = time.monotonic() + max(0.0, self.config.term_grace_s)
        for w in workers:
            try:
                w.proc.terminate()
            except OSError:
                pass
        how: Dict[int, str] = {}
        for w in workers:
            try:
                w.proc.wait(timeout=max(0.0, deadline - time.monotonic()))
                how[w.rank] = "graceful"
                continue
            except subprocess.TimeoutExpired:
                pass
            try:
                w.proc.kill()
                w.proc.wait(timeout=10)
            except (OSError, subprocess.TimeoutExpired):
                pass
            how[w.rank] = "hard"
        return how

    def request_preempt(self, reason: str = "") -> bool:
        """Ask this run to yield its chips: the run loop answers with a
        graceful SIGTERM drain and returns a ``preempted=True`` result.
        Returns False, and does nothing, once the preemption budget is
        spent. Safe to call from another thread; idempotent while a drain
        is pending."""
        if self._preempt_reason is not None:
            return True
        if self.preempt_count >= max(0, self.config.preemption_budget):
            return False
        self.preempt_count += 1
        self._preempt_reason = reason or "preempted"
        return True

    @staticmethod
    def _death(rc: Optional[int]) -> str:
        """Classify an observed exit code: clean completion, a honoured
        SIGTERM (with or without the preempt exit code), or anything else
        (crash, SIGKILL, chaos exit)."""
        from .guards import PREEMPT_EXIT_CODE

        graceful = rc in (0, PREEMPT_EXIT_CODE, -int(signal.SIGTERM))
        return "graceful" if graceful else "hard"

    # -- the live telemetry plane ------------------------------------------
    def _start_live_plane(self) -> None:
        cfg = self.config
        if self.run_dir is None or cfg.metrics_port is None:
            return
        from ..observe import live as live_mod

        self._aggregator = live_mod.LiveAggregator(self.run_dir, detector_config=cfg.detector_config)
        try:
            self._metrics_server = live_mod.MetricsHTTPServer(self._aggregator.registry, port=cfg.metrics_port).start()
        except OSError as e:
            self._emit("metrics_error", message=f"exposition bind failed: {e}")
            return
        self.metrics_port = self._metrics_server.port
        self._metrics_server.write_port_file(self.run_dir)
        self._emit("metrics_up", message=f"/metrics serving on port {self.metrics_port}")

    def _close_live_plane(self) -> None:
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None

    def _poll_live(self, workers: Dict[int, "_Worker"]) -> None:
        """Drain the aggregator: log every fired alert in the supervisor's
        own log, append it to the run's ``alerts.jsonl`` (what the
        workers' ``AlertFeed`` reads), and, when ``alert_restart_after``
        is set, kill a rank that has had that many critical alerts; the
        sweep that follows handles the death as any other (at a world
        above one, a restart of the whole generation)."""
        if self._aggregator is None:
            return
        from ..observe import live as live_mod

        cfg = self.config
        for alert in self._aggregator.poll():
            rec = dict(alert.record())
            rec.setdefault("ts", time.time())
            live_mod.append_alert(self.run_dir, rec)
            if self.telemetry is not None:
                self.telemetry.emit(alert)
            if alert.severity != "critical" or alert.rank is None:
                continue
            rank = int(alert.rank)
            self._critical_alerts[rank] = self._critical_alerts.get(rank, 0) + 1
            if cfg.alert_restart_after > 0 and self._critical_alerts[rank] >= cfg.alert_restart_after:
                self._critical_alerts[rank] = 0
                w = workers.get(rank)
                if w is not None and not w.done and w.proc.poll() is None:
                    self._emit(
                        "alert_restart", rank=rank, incarnation=w.incarnation,
                        message=f"sustained critical {alert.alert} x{cfg.alert_restart_after}; recycling rank",
                    )
                    self._kill(w)

    # -- the run loop -------------------------------------------------------
    def run(self) -> SupervisorResult:
        self._start_live_plane()
        try:
            return self._run_loop()
        finally:
            # one last drain, so that what the workers wrote in their last
            # moments still reaches the gauges and the alert feed
            self._poll_live({})
            self._close_live_plane()
            if self._rendezvous_dir is not None:
                shutil.rmtree(self._rendezvous_dir, ignore_errors=True)
                self._rendezvous_dir = None

    def _run_loop(self) -> SupervisorResult:
        from .guards import CKPT_UNWRITABLE_EXIT_CODE

        cfg = self.config
        world = self.world_size
        started = time.monotonic()
        workers = self._spawn_world(world)
        exit_codes: Dict[int, int] = {}

        def fail(reason: str) -> SupervisorResult:
            self._kill_all([w for w in workers.values() if not w.done])
            self._emit("run_failed", message=reason)
            return SupervisorResult(
                success=False, world_size=world, total_restarts=self.total_restarts, degraded=self.degraded,
                exit_codes=exit_codes, reason=reason, final_mesh=self.mesh,
            )

        def replan(dead_ranks: List[int], correlated: bool) -> Optional[int]:
            """Quorum restart: compute the largest viable mesh from the
            survivors, announce it (typed ReshapeEvent + the degraded_restart
            line the timeline renders), and shut the old world down. Returns
            the new world size, or None when no shape clears the min-world
            floor (the caller then fails the run)."""
            dead = sorted(set(dead_ranks))
            if not cfg.allow_degraded:
                return None
            old_mesh = self.mesh or {"data": world, "fsdp": 1, "tensor": 1}
            new_mesh = plan_mesh(old_mesh, world - len(dead), cfg.min_world_size)
            if new_mesh is None:
                return None
            new_world = new_mesh["data"] * new_mesh["fsdp"] * new_mesh["tensor"]
            label = "correlated" if correlated else "independent"
            self._emit(
                "degraded_restart", rank=dead[0],
                message=f"world {world} -> {new_world} ({label} death of ranks {dead})",
            )
            if self.telemetry is not None:
                from ..observe import ReshapeEvent

                self.telemetry.emit(
                    ReshapeEvent(
                        old_world=world, new_world=new_world, old_mesh=old_mesh, new_mesh=new_mesh,
                        dead_ranks=dead, correlated=correlated,
                        reason=f"{label} death of {len(dead)} rank(s); replanned against"
                               f" min_world={cfg.min_world_size}",
                    )
                )
            live = [w for w in workers.values() if not w.done and w.proc.poll() is None]
            how = self._kill_all(live)
            for w in live:
                self._emit(
                    "worker_term", rank=w.rank, incarnation=w.incarnation,
                    message=f"{how[w.rank]} shutdown for world reshape",
                )
            if self.mesh is not None:
                self.mesh = new_mesh
            if self.device_ranks is not None:
                # the survivors renumber 0..W'-1 onto the FIRST W' chips of
                # the grant; the tail is freed for the scheduler to reclaim
                self.device_ranks = self.device_ranks[:new_world]
            return new_world

        def exited(rank: int, w: _Worker, rc: Optional[int], after_peer: bool = False) -> bool:
            """Record a death; False when it is the fail-fast exit code."""
            exit_codes[rank] = rc if rc is not None else -1
            how = "graceful" if after_peer else self._death(rc)
            note = ", after a peer's death" if after_peer else ""
            self._emit(
                "worker_exit", rank=rank, incarnation=w.incarnation,
                message=f"exit code {rc} ({how} death{note})",
            )
            if rc == CKPT_UNWRITABLE_EXIT_CODE:
                return False
            if how == "hard":
                self._death_log.append((time.monotonic(), rank))
            return True

        while True:
            if cfg.deadline_s is not None and time.monotonic() - started > cfg.deadline_s:
                return fail(f"deadline {cfg.deadline_s}s exceeded")

            preempt = self._preempt_reason
            if preempt is not None:
                # preemption drain: graceful-first kill of every live worker,
                # then report preempted so the scheduler parks the job
                for w in workers.values():
                    if w.done or w.proc.poll() is not None:
                        continue
                    how = self._kill(w)
                    rc = w.proc.returncode
                    exit_codes[w.rank] = rc if rc is not None else -1
                    self._emit(
                        "worker_term", rank=w.rank, incarnation=w.incarnation,
                        message=f"{how} shutdown for preemption ({preempt})",
                    )
                self._emit("run_preempted", message=preempt)
                return SupervisorResult(
                    success=False, world_size=world, total_restarts=self.total_restarts, degraded=self.degraded,
                    exit_codes=exit_codes, reason=f"preempted: {preempt}", final_mesh=self.mesh, preempted=True,
                )

            # the live plane first: an alert reaches the feed (and may kill
            # a sick rank) before this sweep looks at exit codes
            self._poll_live(workers)

            restart_queue: List[int] = []
            dead_rank: Optional[int] = None
            died_at = time.monotonic()
            deaths: List[tuple] = []  # (rank, worker, exit code, killed as hung)
            for rank, w in workers.items():
                if w.done:
                    continue
                rc = w.proc.poll()
                if rc == 0:
                    w.done = True
                    exit_codes[rank] = 0
                    self._emit("worker_complete", rank=rank, incarnation=w.incarnation)
                    continue
                hung = False
                if rc is None:
                    if not self._is_hung(w):
                        continue
                    self._emit("worker_hang", rank=rank, incarnation=w.incarnation, message="heartbeat stale; killing")
                    self._kill(w)
                    rc, hung = w.proc.returncode, True
                deaths.append((rank, w, rc, hung))
                if world == 1:
                    break

            primary = {rank for rank, _, _, _ in deaths}
            if world > 1 and deaths:
                # a process group takes no new member: gather the deaths of
                # the next moment too (the rest of a zone; survivors raising
                # out of a collective), then restart the whole generation
                settle_until = time.monotonic() + cfg.correlation_window_s
                while time.monotonic() < settle_until and any(
                    not w.done and w.proc.poll() is None for w in workers.values()
                ):
                    time.sleep(min(0.01, cfg.poll_interval_s))
                    for rank, w in workers.items():
                        if w.done or rank in {d[0] for d in deaths} or w.proc.poll() is None:
                            continue
                        if w.proc.returncode == 0:
                            w.done = True
                            exit_codes[rank] = 0
                            self._emit("worker_complete", rank=rank, incarnation=w.incarnation)
                        else:
                            deaths.append((rank, w, w.proc.returncode, False))
                # the primary deaths: hung ranks and deaths by a signal; a
                # rank that exited with a code while a peer died that way
                # raised out of a collective, and counts as graceful
                signalled = {
                    rank for rank, _, rc, hung in deaths
                    if hung or (rc is not None and rc < 0 and rc != -int(signal.SIGTERM))
                }
                primary = signalled or primary

            for rank, w, rc, _ in deaths:
                w.done = True  # handled here, never polled again
                if not exited(rank, w, rc, after_peer=rank not in primary):
                    return fail(
                        f"rank {rank} reports checkpoint dir unwritable (exit {rc}); failing fast instead of a"
                        f" restart storm"
                    )
            for rank, w, _, _ in deaths:
                if rank not in primary:
                    continue
                if w.restarts >= cfg.max_restarts:
                    if dead_rank is None:
                        dead_rank = rank
                    continue
                restart_queue.append(rank)

            # correlated-vs-independent classification: hard deaths of >= K
            # DISTINCT ranks inside the window are one incident (a zone
            # outage), replanned as a whole instead of restarted one by one
            now = time.monotonic()
            self._death_log = [(t, r) for t, r in self._death_log if now - t <= cfg.correlation_window_s]
            burst = sorted({r for _, r in self._death_log})
            if len(burst) >= max(2, cfg.correlated_threshold):
                new_world = replan(burst, correlated=True)
                if new_world is None:
                    return fail(
                        f"correlated death of ranks {burst}: no viable mesh above min_world={cfg.min_world_size}"
                    )
                self.degraded = True
                world = new_world
                exit_codes = {}
                self._death_log.clear()
                workers = self._spawn_world(world)
                self.restart_times.append((died_at, time.monotonic()))
                continue

            if dead_rank is not None:
                new_world = replan([dead_rank], correlated=False)
                if new_world is None:
                    return fail(f"rank {dead_rank} exceeded max_restarts={cfg.max_restarts}")
                # reshaped world: renumber 0..W'-1, fresh restart budgets —
                # workers recompute mesh/partition/ledger from the new size
                self.degraded = True
                world = new_world
                exit_codes = {}
                self._death_log.clear()
                workers = self._spawn_world(world)
                self.restart_times.append((died_at, time.monotonic()))
                continue

            if restart_queue and world > 1:
                # the generation restart: survivors down (graceful first),
                # the dead ranks' budgets charged, every rank up again
                live = [w for w in workers.values() if w.rank not in restart_queue and w.proc.poll() is None]
                how = self._kill_all(live)
                for w in live:
                    self._emit(
                        "worker_term", rank=w.rank, incarnation=w.incarnation,
                        message=f"graceful shutdown for generation restart ({how[w.rank]} exit)",
                    )
                budgets = {r: w.restarts for r, w in workers.items()}
                delay = 0.0
                for rank in restart_queue:
                    budgets[rank] += 1
                    self.total_restarts += 1
                    delay = max(delay, self._backoff(budgets[rank]))
                    self._emit(
                        "worker_restart", rank=rank, incarnation=self._incarnations.get(rank, 0),
                        message=f"restart {budgets[rank]}/{cfg.max_restarts} after {delay:.2f}s backoff"
                                f" (generation restart of world {world})",
                    )
                time.sleep(delay)
                exit_codes = {}
                workers = self._spawn_world(world, budgets)
                self.restart_times.append((died_at, time.monotonic()))
                continue

            for rank in restart_queue:
                w = workers[rank]
                restarts = w.restarts + 1
                self.total_restarts += 1
                delay = self._backoff(restarts)
                self._emit(
                    "worker_restart", rank=rank, incarnation=self._incarnations.get(rank, 0),
                    message=f"restart {restarts}/{cfg.max_restarts} after {delay:.2f}s backoff",
                )
                time.sleep(delay)
                self._new_generation(world)
                workers[rank] = self._spawn(rank, world)
                workers[rank].restarts = restarts
                self.restart_times.append((died_at, time.monotonic()))

            if all(w.done for w in workers.values()):
                self._emit("run_complete", message=f"world_size={world}")
                return SupervisorResult(
                    success=True, world_size=world, total_restarts=self.total_restarts, degraded=self.degraded,
                    exit_codes=exit_codes, final_mesh=self.mesh,
                )
            time.sleep(cfg.poll_interval_s)


# -- serving-pool autoscaling ----------------------------------------------
@dataclass
class AutoscalerConfig:
    """Knobs for :class:`ServingAutoscaler`.

    ``queue_high`` is backlog per live worker: the pool scales up when the
    spool's queue depth stays at or above ``queue_high * n_workers`` for
    ``queue_sustain`` consecutive polls. An SLO burn escalates through the
    ``serving.frontend.BurnEscalator`` (the detector's sustain, the
    escalation's own sustain and a cooldown), so one transient alert never
    spawns a worker.
    """

    min_workers: int = 1
    max_workers: int = 3
    chips_per_worker: int = 1
    poll_s: float = 0.05
    queue_high: int = 8
    queue_sustain: int = 3
    cooldown_s: float = 1.0
    burn_sustain: int = 1
    term_grace_s: float = 5.0
    max_wall_s: Optional[float] = None
    detector_config: Any = None
    owner: str = "serve-pool"


class ServingAutoscaler:
    """An elastic spool-serving pool: spawn and retire workers from live
    signals.

    Where :class:`Supervisor` keeps a fixed world alive, this keeps a
    variable one sized to demand: it tails the run's live telemetry plane
    (the serving p99 gauge and the SLO-burn alerts that the workers'
    ``RequestEvent``s feed) and the spool's queue depth, and answers
    sustained pressure by leasing chips from the fleet scheduler and
    spawning another spool worker. Workers share one ``FileSpool``
    directory, so a new worker pulls queued requests as soon as it is up.
    Drain is organic: spool workers exit 0 once the spool is drained, and
    the autoscaler releases their chip leases as they go.

    Identities follow ``FileSpool.requeue_orphans``: a crashed worker is
    replaced under the same worker id at incarnation + 1 (so the
    replacement proves its predecessor dead and recovers its claims);
    scale-ups take fresh ids below ``max_workers``, and the world exported
    to every spawn is ``max_workers``, so no live id is ever at or above it.
    A worker's environment carries only its own lease in
    ``RESILIENCE_DEVICE_RANKS`` (a list of one chip), where a supervised
    job's carries the whole job's list.

    ``argv_for_worker(worker_id, device_ranks) -> List[str]`` builds a
    worker's command line; ``device_ranks`` is the chip lease (empty when
    no scheduler is attached).
    """

    def __init__(
        self,
        argv_for_worker: Callable[[int, List[int]], List[str]],
        spool: Any,
        run_dir: str,
        scheduler: Any = None,
        config: Optional[AutoscalerConfig] = None,
        telemetry: Any = None,
        env: Optional[Dict[str, str]] = None,
        log_dir: Optional[str] = None,
        run_id: Optional[str] = None,
    ):
        from ..observe import live as live_mod
        from ..observe import runlog
        from ..serving.frontend import BurnEscalator

        self.argv_for_worker = argv_for_worker
        self.spool = spool
        self.run_dir = run_dir
        self.scheduler = scheduler
        self.config = config or AutoscalerConfig()
        self.telemetry = telemetry
        self.env = env
        self.log_dir = log_dir
        cfg = self.config
        if not (1 <= cfg.min_workers <= cfg.max_workers):
            raise ValueError(f"need 1 <= min_workers <= max_workers, got {cfg.min_workers}..{cfg.max_workers}")
        self._workers: Dict[int, _Worker] = {}
        self._chips: Dict[int, List[int]] = {}  # worker id -> leased chips
        self._incarnations: Dict[int, int] = {}
        self._queue_streak = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.denied = 0
        self.spawned_total = 0
        self.workers_peak = 0
        self.run_id = run_id or f"{runlog.default_run_id(run_dir)}.{int(time.time())}"
        self._manifest = runlog.new_manifest(self.run_id, cfg.max_workers)
        self._manifest.save(run_dir)
        self._escalator = BurnEscalator(alert="slo_burn", sustain=cfg.burn_sustain, cooldown_s=cfg.cooldown_s)
        self._aggregator = live_mod.LiveAggregator(run_dir, detector_config=cfg.detector_config)

    # -- telemetry ----------------------------------------------------------
    def _emit_autoscale(self, direction: str, reason: str, worker_id: Optional[int] = None,
                        device_ranks: Optional[List[int]] = None, escalation: Optional[int] = None) -> None:
        if self.telemetry is None:
            return
        from ..observe import AutoscaleEvent

        self.telemetry.emit(
            AutoscaleEvent(
                direction=direction, reason=reason, workers=len(self._workers), worker_id=worker_id,
                device_ranks=device_ranks, queue_depth=self.spool.queue_depth(), p99_s=self._p99(),
                escalation=escalation,
            )
        )

    def _p99(self) -> Optional[float]:
        return self._aggregator.registry.get_gauge("live_serving_p99_total_seconds")

    # -- worker lifecycle ---------------------------------------------------
    def _spawn(self, worker_id: int, chips: List[int]) -> None:
        from ..observe import runlog

        cfg = self.config
        incarnation = self._incarnations.get(worker_id, 0)
        self._incarnations[worker_id] = incarnation + 1
        argv = self.argv_for_worker(worker_id, chips)
        env = dict(self.env if self.env is not None else os.environ)
        env[ENV_INCARNATION] = str(incarnation)
        env[ENV_RANK] = str(worker_id)
        env[ENV_WORLD] = str(cfg.max_workers)
        if chips:
            env[ENV_DEVICE_RANKS] = json.dumps(chips)
        env[runlog.ENV_RUN_DIR] = self.run_dir
        env[runlog.ENV_RUN_ID] = self.run_id
        self._manifest.record_spawn(
            rank=worker_id, incarnation=incarnation, world_size=cfg.max_workers, spawned_unix=time.time()
        )
        self._manifest.save(self.run_dir)
        stdout = stderr = None
        if self.log_dir is not None:
            os.makedirs(self.log_dir, exist_ok=True)
            log = open(os.path.join(self.log_dir, f"worker{worker_id}.{incarnation}.log"), "w")
            stdout, stderr = log, subprocess.STDOUT
        proc = subprocess.Popen(argv, env=env, stdout=stdout, stderr=stderr)
        if stdout is not None:
            stdout.close()  # the child holds its own descriptor
        self._workers[worker_id] = _Worker(
            rank=worker_id, proc=proc, incarnation=incarnation, spawned_at=time.monotonic()
        )
        self._chips[worker_id] = list(chips)
        self.spawned_total += 1
        self.workers_peak = max(self.workers_peak, len(self._workers))

    def _release(self, worker_id: int) -> None:
        chips = self._chips.pop(worker_id, [])
        if chips and self.scheduler is not None:
            self.scheduler.lease_release(self.config.owner, chips)

    def _fresh_id(self) -> Optional[int]:
        for wid in range(self.config.max_workers):
            if wid not in self._workers:
                return wid
        return None

    def _scale_up(self, reason: str, escalation: Optional[int] = None) -> bool:
        cfg = self.config
        wid = self._fresh_id()
        if wid is None:
            return False  # already at max_workers
        chips: List[int] = []
        if self.scheduler is not None:
            chips = self.scheduler.lease(cfg.owner, cfg.chips_per_worker, reason=reason)
            if not chips:
                self.denied += 1
                self._emit_autoscale("denied", reason, worker_id=wid, escalation=escalation)
                return False
        self._spawn(wid, chips)
        self.scale_ups += 1
        self._emit_autoscale("up", reason, worker_id=wid, device_ranks=chips or None, escalation=escalation)
        return True

    # -- signal plumbing ----------------------------------------------------
    def _poll_signals(self, scale: bool = True) -> None:
        """Drain the live plane (a sustained SLO burn asks for a worker),
        then the queue depth. With ``scale=False`` the alerts are only
        recorded and start no worker: ``run`` passes it once the spool is
        drained (the p99 that burned outlives the demand) and in its last
        drain, after the pool has wound down. The JAX package's autoscaler
        scales up in both cases; a worker it spawns on a drained spool
        exits at once, and under a stale burn the pool respawns until its
        wall cap, or is left with a worker nobody reaps and its chip
        leased."""
        from ..observe import live as live_mod

        for alert in self._aggregator.poll():
            rec = dict(alert.record())
            rec.setdefault("ts", time.time())
            live_mod.append_alert(self.run_dir, rec)
            if self.telemetry is not None:
                self.telemetry.emit(alert)
            decision = self._escalator.observe(rec)
            if decision is not None and scale:
                self._scale_up("slo_burn", escalation=decision.get("escalation"))
        if not scale:
            return
        # a backlog persistently above the per-worker high-water mark means
        # the pool is undersized even before any SLO alert (a cold start
        # before any request finishes)
        cfg = self.config
        n_live = max(1, len(self._workers))
        if self.spool.queue_depth() >= cfg.queue_high * n_live:
            self._queue_streak += 1
        else:
            self._queue_streak = 0
        if self._queue_streak >= cfg.queue_sustain and self._scale_up("queue_depth"):
            self._queue_streak = 0

    def _reap(self) -> None:
        """Sweep exited workers: a clean exit is an organic scale-down (the
        spool drained under it); a crash is replaced under the same id, so
        the incarnation bump lets the replacement reclaim the orphans."""
        for wid in list(self._workers):
            rc = self._workers[wid].proc.poll()
            if rc is None:
                continue
            del self._workers[wid]
            if rc == 0:
                self._release(wid)
                self.scale_downs += 1
                self._emit_autoscale("down", "drained", worker_id=wid)
            else:
                # the same id (its incarnation already bumped in _spawn) on
                # the same lease: requeue_orphans proves the predecessor dead
                self._spawn(wid, self._chips.get(wid, []))

    def _kill_all(self, reason: str) -> None:
        grace = self.config.term_grace_s
        for wid in list(self._workers):
            w = self._workers.pop(wid)
            try:
                w.proc.terminate()
                try:
                    w.proc.wait(timeout=max(0.0, grace))
                except subprocess.TimeoutExpired:
                    w.proc.kill()
                    w.proc.wait(timeout=10)
            except (OSError, subprocess.TimeoutExpired):
                pass
            self._release(wid)
            self.scale_downs += 1
            self._emit_autoscale("down", reason, worker_id=wid)

    # -- the run loop -------------------------------------------------------
    def run(self) -> Dict:
        """Serve until the spool drains and the pool winds itself down.
        Returns the summary: scale-ups and downs, denials, the peak size,
        the wall seconds and whether the spool drained."""
        cfg = self.config
        started = time.monotonic()
        for _ in range(cfg.min_workers):
            self._scale_up("min_workers")
        timed_out = False
        while True:
            self._reap()
            drained = self.spool.drained()
            if not self._workers:
                if drained:
                    break
                # requests still pending with the pool empty (every worker
                # drained in a lull): start the minimum again
                for _ in range(cfg.min_workers):
                    self._scale_up("min_workers")
            self._poll_signals(scale=not drained)
            if cfg.max_wall_s is not None and time.monotonic() - started > cfg.max_wall_s:
                timed_out = True
                self._kill_all("wall_cap")
                break
            time.sleep(cfg.poll_s)
        # one last drain, so that the workers' final events reach the alert
        # feed and the gauges before the caller reads them
        self._poll_signals(scale=False)
        return {
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "denied": self.denied,
            "spawned_total": self.spawned_total,
            "workers_peak": self.workers_peak,
            "drained": self.spool.drained() and not timed_out,
            "wall_s": time.monotonic() - started,
        }
