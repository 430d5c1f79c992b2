"""The fleet control plane: a gang scheduler over a chip inventory, the JAX
package's ``resilience/scheduler.py`` for the port's workers.

One :class:`Supervisor` owns one job; this module is the layer above it,
where several jobs (training runs, serving pools) contend for one fixed
inventory of chips and the decisions are placement and eviction:

- **The job spool.** Jobs arrive as manifests on a :class:`JobSpool`, the
  ``serving.frontend.FileSpool`` claim protocol over job documents
  (atomic-rename claims, crash-safe parks through ``release_doc``) with a
  ``quarantine/`` side directory, so that a crash-looping manifest leaves
  the queue instead of wedging it. The wire schema is the JAX package's:
  a manifest written by either package loads in the other.
- **Priced admission.** With a calibration (``FleetConfig.calibration``)
  each admission asks the offline cost model
  (:func:`observe.costmodel.search_slices`) which viable slice meets the
  job's deadline at the fewest chip-seconds, over the worlds that
  :func:`plan_mesh`'s divisor discipline allows; without one it grants the
  smallest viable slice, and the typed ``ScheduleEvent`` names the
  fallback. ``FleetConfig.fabric`` defaults to the port's in-node row,
  ``"NVLink4(H100)"`` (the JAX package's default, ``"tpu_ici"``, is a row
  of neither package's table, so its priced admission always falls back).
- **Gang semantics.** A job runs on all its granted chips or none: the
  grant is a prefix of the free list, exported to the workers as
  ``RESILIENCE_DEVICE_RANKS`` (the launcher's worker takes the card it was
  granted: ``launch.worker_cuda_device``), and every chip returns to the
  inventory when the job's supervisor thread is reaped.
- **SLO-driven preemption.** Serving jobs run with the live plane armed
  (``metrics_port=0`` and ``FleetConfig.serve_detector``); the scheduler
  tails each pool's ``alerts.jsonl`` (``observe.live.AlertFeed``) through a
  ``serving.BurnEscalator``, and on a sustained ``slo_burn`` asks the
  lowest-priority running training job's supervisor to yield
  (:meth:`Supervisor.request_preempt`): SIGTERM, the worker's
  ``PreemptionGuard`` commits an emergency checkpoint and exits
  ``PREEMPT_EXIT_CODE``, and the job is parked back on the spool (a
  preemption, never a strike). The freed chips are reserved for the
  burning pool until it finishes; the parked job resumes from its
  committed checkpoint when chips free up.
- **K-strike quarantine.** A hard failure (not a preemption) is a strike;
  at ``max_strikes`` the manifest moves to ``quarantine/`` with a typed
  ``JobFailedEvent`` and the queue moves on.

Like the supervisor, this module imports neither torch nor anything that
does at import time and never touches a card; the events, the live plane,
the cost model and the spool (``observe``, ``serving``) are imported where
they are used, and they import torch but create no CUDA context.
``python -m network_distributed_pytorch_tpu_torch.launch fleet`` is the
command-line entry (:func:`main`).
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .supervisor import Supervisor, SupervisorConfig, plan_mesh

JOB_SCHEMA = 1
TRAIN = "train"
SERVE = "serve"

# argv placeholder tokens substituted per worker at spawn time
_ARGV_TOKENS = ("{rank}", "{world}", "{incarnation}", "{device_rank}")


# ---------------------------------------------------------------------------
# job manifests + the job spool
# ---------------------------------------------------------------------------


@dataclass
class JobManifest:
    """One job as it lives on the spool: the submission (argv template,
    priority, deadline, mesh bounds) plus the bookkeeping the scheduler
    carries across parks by rewriting the document (preemptions, strikes,
    chip-seconds), so that a restarted scheduler re-claims a parked job
    with its history.

    ``argv`` entries may contain the placeholder tokens ``{rank}``,
    ``{world}``, ``{incarnation}`` and ``{device_rank}`` (the fleet chip
    granted to that worker), substituted at spawn time.
    """

    job_id: str
    argv: List[str]
    kind: str = TRAIN  # train | serve
    priority: int = 0  # higher = more important
    deadline_s: Optional[float] = None  # wall budget from first submission
    min_world: int = 1
    max_world: int = 1
    steps: Optional[float] = None  # work units, for goodput weighting
    mesh_axes: Optional[Dict[str, int]] = None  # None = pure DP
    env: Dict[str, str] = field(default_factory=dict)
    max_restarts: int = 1  # per-admission Supervisor budget
    preemption_budget: int = 3  # lifetime parks before refusing
    max_strikes: int = 3  # hard failures before quarantine
    # -- bookkeeping carried across parks (rewritten into the spool doc) --
    preemptions: int = 0
    strikes: int = 0
    chip_seconds: float = 0.0
    work_done: float = 0.0
    last_rc: Optional[int] = None

    def __post_init__(self):
        if self.kind not in (TRAIN, SERVE):
            raise ValueError(f"job kind must be train|serve, got {self.kind!r}")
        if self.min_world < 1 or self.max_world < self.min_world:
            raise ValueError(f"bad world bounds [{self.min_world}, {self.max_world}]")
        if not self.argv:
            raise ValueError("job argv template is empty")

    def to_wire(self) -> Dict:
        return {
            "schema": JOB_SCHEMA,
            "job_id": self.job_id,
            "argv": list(self.argv),
            "kind": self.kind,
            "priority": self.priority,
            "deadline_s": self.deadline_s,
            "min_world": self.min_world,
            "max_world": self.max_world,
            "steps": self.steps,
            "mesh_axes": self.mesh_axes,
            "env": dict(self.env),
            "max_restarts": self.max_restarts,
            "preemption_budget": self.preemption_budget,
            "max_strikes": self.max_strikes,
            "preemptions": self.preemptions,
            "strikes": self.strikes,
            "chip_seconds": self.chip_seconds,
            "work_done": self.work_done,
            "last_rc": self.last_rc,
        }

    @classmethod
    def from_wire(cls, doc: Dict) -> "JobManifest":
        return cls(**{k: doc[k] for k in doc if k != "schema"})

    def worker_argv(self, rank: int, world: int, incarnation: int, device_rank: int) -> List[str]:
        subs = dict(zip(_ARGV_TOKENS, (rank, world, incarnation, device_rank)))
        out = []
        for a in self.argv:
            for token, value in subs.items():
                a = a.replace(token, str(value))
            out.append(a)
        return out


class JobSpool:
    """Job manifests under the ``FileSpool`` claim protocol, plus the
    ``quarantine/`` exit ramp.

    The scheduler claims as rank 0 incarnation 0; a replacement scheduler
    after a crash recovers live claims with :meth:`recover`, as a serving
    survivor recovers a dead rank's requests."""

    def __init__(self, root: str):
        from ..serving.frontend import FileSpool

        self.root = root
        self._spool = FileSpool(root, rank=0, incarnation=0)
        self.quarantine_dir = os.path.join(root, "quarantine")
        os.makedirs(self.quarantine_dir, exist_ok=True)

    def submit(self, jobs: List[JobManifest]) -> int:
        return self._spool.ensure_docs({j.job_id: j.to_wire() for j in jobs})

    def claim(self) -> Optional[JobManifest]:
        """Claim the next queued manifest, or None. A malformed document is
        quarantined on the spot: a bad submission must not crash-loop the
        control plane itself."""
        while True:
            got = self._spool.claim_doc()
            if got is None:
                return None
            entry_id, doc = got
            try:
                return JobManifest.from_wire(doc)
            except (TypeError, ValueError) as e:
                doc["quarantine_reason"] = f"malformed manifest: {e}"
                self._quarantine_doc(entry_id, doc)

    def park(self, job: JobManifest) -> None:
        """Return a claimed job to the queue with its updated bookkeeping
        (``release_doc``'s crash-safe rename)."""
        self._spool.release_doc(job.job_id, job.to_wire())

    def complete(self, job: JobManifest, **extra: Any) -> None:
        doc = job.to_wire()
        doc["state"] = "completed"
        doc.update(extra)
        self._spool.complete_doc(job.job_id, doc)

    def quarantine(self, job: JobManifest, reason: str = "") -> None:
        doc = job.to_wire()
        if reason:
            doc["quarantine_reason"] = reason
        self._quarantine_doc(job.job_id, doc)

    def _quarantine_doc(self, entry_id: str, doc: Dict) -> None:
        from ..serving.frontend import _atomic_write

        # the forensics copy first, then the done-side record that keeps
        # drained() honest and releases the claim: the queue is never
        # blocked behind a quarantined manifest
        _atomic_write(os.path.join(self.quarantine_dir, f"{entry_id}.json"), doc)
        done = dict(doc)
        done["state"] = "quarantined"
        self._spool.complete_doc(entry_id, done)

    def queued(self) -> int:
        try:
            return len([n for n in os.listdir(self._spool.queue_dir) if n.endswith(".json")])
        except OSError:
            return 0

    def quarantined_ids(self) -> List[str]:
        try:
            return sorted(n[: -len(".json")] for n in os.listdir(self.quarantine_dir) if n.endswith(".json"))
        except OSError:
            return []

    def recover(self, world: int = 1) -> int:
        """Re-queue the claims a dead scheduler left (the serving spool's
        dead-claimant rules)."""
        return self._spool.requeue_orphans(world)


# ---------------------------------------------------------------------------
# the fleet scheduler
# ---------------------------------------------------------------------------


@dataclass
class FleetConfig:
    n_devices: int = 4
    poll_s: float = 0.05
    max_wall_s: Optional[float] = None  # whole-fleet wall cap
    term_grace_s: float = 5.0  # per-job SIGTERM -> SIGKILL window
    supervisor_poll_s: float = 0.05
    escalation_sustain: int = 1  # slo_burn alerts before escalating
    escalation_cooldown_s: float = 5.0  # between escalations per pool
    # observe.health.DetectorConfig armed on serving jobs' live plane
    # (None = detector defaults; serving jobs always get metrics_port=0)
    serve_detector: Any = None
    # observe.costmodel.CostCalibration for slice pricing (None = fallback
    # planner: smallest viable slice)
    calibration: Any = None
    # the fabric row handed to the cost model: the port's in-node row (the
    # JAX package's default, "tpu_ici", is a row of neither table)
    fabric: str = "NVLink4(H100)"


class _JobRun:
    """One admitted job segment: the Supervisor, its thread, the grant."""

    def __init__(
        self,
        job: JobManifest,
        supervisor: Supervisor,
        device_ranks: List[int],
        run_dir: Optional[str],
        feed: Any,
        escalator: Any,
    ):
        self.job = job
        self.supervisor = supervisor
        self.device_ranks = list(device_ranks)
        self.run_dir = run_dir
        self.feed = feed
        self.escalator = escalator
        self.started_mono = time.monotonic()
        self.preempt_pending = False
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._main, name=f"job-{job.job_id}", daemon=True)

    def _main(self) -> None:
        try:
            self.result = self.supervisor.run()
        except BaseException as e:  # a supervisor bug is a job strike
            self.error = e


class _LockedTelemetry:
    """Serialise the emits of concurrent per-job Supervisor threads onto one
    shared fleet registry (the JSONL sink is a plain buffered file)."""

    def __init__(self, inner: Any):
        self._inner = inner
        self._lock = threading.Lock()

    def emit(self, event: Any) -> None:
        with self._lock:
            self._inner.emit(event)

    def close(self) -> None:
        with self._lock:
            self._inner.close()


class FleetScheduler:
    """Admit, run, preempt, park and quarantine jobs over ``n_devices``
    chips. :meth:`run` drives the whole fleet to completion (or the wall
    cap) and returns the goodput summary."""

    def __init__(
        self,
        spool: Any,
        config: Optional[FleetConfig] = None,
        telemetry: Any = None,
        run_dir: Optional[str] = None,
    ):
        self.spool = JobSpool(spool) if isinstance(spool, str) else spool
        self.cfg = config or FleetConfig()
        if self.cfg.n_devices < 1:
            raise ValueError("fleet needs at least one device")
        self.run_dir = run_dir
        self._own_telemetry = telemetry is None and run_dir is not None
        if self._own_telemetry:
            from ..observe import runlog
            from ..observe.telemetry import telemetry_for_run

            runlog.new_manifest(run_id="fleet", world_size=self.cfg.n_devices).save(run_dir)
            telemetry = telemetry_for_run(event_log=os.path.join(run_dir, runlog.SUPERVISOR_LOG), stdout=False)
        self.telemetry = _LockedTelemetry(telemetry) if telemetry is not None else None
        self._free: List[int] = list(range(self.cfg.n_devices))
        self._running: Dict[str, _JobRun] = {}
        self._pending: List[JobManifest] = []
        # chips held for a burning pool until it finishes: job_id -> ranks
        self._reserved: Dict[str, List[int]] = {}
        self._born: Dict[str, float] = {}  # first-submission clock
        # chips leased out of the inventory by name (the serving
        # autoscaler's pools); lease and release may be called from another
        # thread than run(), so the inventory handoff takes a lock
        self._leases: Dict[str, List[int]] = {}
        self._inv_lock = threading.Lock()
        self._parked_ids: set = set()
        self._segments: Dict[str, int] = {}
        self._final: Dict[str, Dict] = {}  # job_id -> terminal record
        self.preempt_count = 0
        self._stop_admitting = False

    # -- event plumbing ----------------------------------------------------

    def _emit(self, event: Any) -> None:
        if self.telemetry is not None:
            self.telemetry.emit(event)

    def _job_event(self, job: JobManifest, state: str, **kw: Any) -> None:
        from ..observe.events import JobEvent

        self._emit(
            JobEvent(
                job_id=job.job_id, state=state, kind=job.kind, priority=job.priority, deadline_s=job.deadline_s,
                preemptions=job.preemptions, **kw,
            )
        )

    # -- spool intake ------------------------------------------------------

    def _claim_new(self) -> None:
        while True:
            job = self.spool.claim()
            if job is None:
                break
            if job.job_id not in self._born:
                self._born[job.job_id] = time.monotonic()
                self._job_event(job, "submitted")
            self._pending.append(job)
        self._pending.sort(key=lambda j: (-j.priority, j.job_id))

    # -- admission ---------------------------------------------------------

    def _grantable(self, job: JobManifest) -> List[int]:
        """Free chips this job may draw on: the inventory minus the chips
        reserved for other jobs (a reservation for this job counts)."""
        held_for_others = set()
        for owner, ranks in self._reserved.items():
            if owner != job.job_id:
                held_for_others.update(ranks)
        return [r for r in self._free if r not in held_for_others]

    # -- chip leasing (serving autoscaler) ---------------------------------

    def lease(self, owner: str, n: int, reason: str = "") -> List[int]:
        """Grant ``n`` free chips to an out-of-band pool (the serving
        autoscaler growing its workers). Returns the granted ranks: possibly
        fewer than asked (whatever is free and unreserved), empty when the
        inventory has nothing to give. Granted chips leave the free list
        until :meth:`lease_release`. Safe against the scheduler's own run
        loop; every grant is a typed ``ScheduleEvent`` (``planner="lease"``),
        so scaling decisions audit from the event log like admissions."""
        if n < 1:
            return []
        with self._inv_lock:
            held = set()
            for ranks in self._reserved.values():
                held.update(ranks)
            granted = [r for r in self._free if r not in held][:n]
            if not granted:
                return []
            self._free = [r for r in self._free if r not in granted]
            self._leases.setdefault(owner, []).extend(granted)
        from ..observe.events import ScheduleEvent

        self._emit(
            ScheduleEvent(
                job_id=owner, world=len(granted), device_ranks=list(granted), planner="lease",
                reason=reason or "autoscale",
            )
        )
        return granted

    def lease_release(self, owner: str, ranks: Optional[List[int]] = None) -> None:
        """Return leased chips to the free inventory (all of ``owner``'s
        lease when ``ranks`` is None). Unknown ranks are ignored: release is
        idempotent, so a drained worker's chips cannot be freed twice."""
        with self._inv_lock:
            held = self._leases.get(owner, [])
            back = [r for r in (held if ranks is None else ranks) if r in held]
            if not back:
                return
            self._leases[owner] = [r for r in held if r not in back]
            if not self._leases[owner]:
                self._leases.pop(owner, None)
            self._free.extend(back)
            self._free.sort()
        from ..observe.events import ScheduleEvent

        self._emit(ScheduleEvent(job_id=owner, world=0, device_ranks=list(back), planner="lease", reason="release"))

    def leased(self, owner: str) -> List[int]:
        return list(self._leases.get(owner, []))

    def _viable_worlds(self, job: JobManifest, cap: int) -> List[int]:
        if job.mesh_axes is None:
            return list(range(job.min_world, cap + 1))
        worlds = set()
        for survivors in range(job.min_world, cap + 1):
            mesh = plan_mesh(job.mesh_axes, survivors, job.min_world)
            if mesh is not None:
                worlds.add(mesh["data"] * mesh["fsdp"] * mesh["tensor"])
        return sorted(worlds)

    def _price(self, job: JobManifest, worlds: List[int]) -> Dict[str, Any]:
        """The world to grant: priced by the cost model when a calibration
        exists, else the smallest viable one."""
        if self.cfg.calibration is not None:
            from ..observe import costmodel

            remaining = None
            if job.deadline_s is not None:
                remaining = max(0.0, job.deadline_s - (time.monotonic() - self._born[job.job_id]))
            try:
                ranked = costmodel.search_slices(
                    self.cfg.calibration, worlds, self.cfg.fabric, steps=job.steps, deadline_s=remaining
                )
            except (ValueError, KeyError, TypeError) as e:
                return {"world": worlds[0], "planner": "fallback", "reason": f"pricing failed: {e}"}
            if ranked:
                best = ranked[0]
                return {
                    "world": best["world"],
                    "planner": "costmodel",
                    "predicted_step_s": best.get("predicted_step_s"),
                    "predicted_chip_seconds": best.get("predicted_chip_seconds"),
                    "reason": "cheapest deadline-meeting slice" if best.get("meets_deadline")
                    else "no slice meets deadline; fastest wall",
                }
        return {"world": worlds[0], "planner": "fallback", "reason": "no calibration; smallest viable slice"}

    def _admit(self) -> None:
        if self._stop_admitting:
            return
        still: List[JobManifest] = []
        for job in self._pending:
            grantable = self._grantable(job)
            cap = min(len(grantable), job.max_world)
            worlds = self._viable_worlds(job, cap) if cap >= job.min_world else []
            if not worlds:
                still.append(job)
                continue
            choice = self._price(job, worlds)
            world = choice["world"]
            mesh = plan_mesh(job.mesh_axes, world, job.min_world) if job.mesh_axes is not None else None
            self._launch(job, world, grantable[:world], mesh, choice)
        self._pending = still

    def _launch(
        self,
        job: JobManifest,
        world: int,
        ranks: List[int],
        mesh: Optional[Dict[str, int]],
        choice: Dict[str, Any],
    ) -> None:
        from ..observe.events import ScheduleEvent

        seg = self._segments.get(job.job_id, 0)
        self._segments[job.job_id] = seg + 1
        job_run_dir = None
        if self.run_dir is not None:
            job_run_dir = os.path.join(self.run_dir, "jobs", f"{job.job_id}.seg{seg}")
            os.makedirs(job_run_dir, exist_ok=True)
        serve = job.kind == SERVE
        sup_cfg = SupervisorConfig(
            max_restarts=job.max_restarts,
            poll_interval_s=self.cfg.supervisor_poll_s,
            term_grace_s=self.cfg.term_grace_s,
            allow_degraded=True,
            min_world_size=job.min_world,
            mesh_axes=mesh,
            metrics_port=0 if (serve and job_run_dir) else None,
            detector_config=self.cfg.serve_detector if serve else None,
            preemption_budget=max(0, job.preemption_budget - job.preemptions),
        )
        env = dict(os.environ)
        env.update(job.env)

        def argv_for_rank(rank: int, w: int, incarnation: int, _job=job, _ranks=ranks) -> List[str]:
            return _job.worker_argv(rank, w, incarnation, _ranks[rank])

        supervisor = Supervisor(
            argv_for_rank, world, config=sup_cfg, telemetry=self.telemetry, env=env, run_dir=job_run_dir,
            run_id=f"{job.job_id}-seg{seg}", device_ranks=ranks,
        )
        feed = escalator = None
        if serve:
            from ..serving.frontend import BurnEscalator

            escalator = BurnEscalator(sustain=self.cfg.escalation_sustain, cooldown_s=self.cfg.escalation_cooldown_s)
            if job_run_dir:
                from ..observe.live import AlertFeed

                feed = AlertFeed(job_run_dir)
        run = _JobRun(job, supervisor, ranks, job_run_dir, feed, escalator)
        granted = set(ranks)
        with self._inv_lock:
            self._free = [r for r in self._free if r not in granted]
        self._running[job.job_id] = run
        self._emit(
            ScheduleEvent(
                job_id=job.job_id, world=world, device_ranks=list(ranks), mesh=mesh,
                predicted_step_s=choice.get("predicted_step_s"),
                predicted_chip_seconds=choice.get("predicted_chip_seconds"),
                planner=choice["planner"], reason=choice.get("reason", ""),
            )
        )
        state = "resumed" if job.job_id in self._parked_ids else "started"
        self._job_event(job, state, world=world, device_ranks=list(ranks))
        run.thread.start()

    # -- SLO escalation -> preemption ----------------------------------------

    def _escalate(self) -> None:
        for run in list(self._running.values()):
            if run.feed is None or run.escalator is None:
                continue
            for rec in run.feed.poll():
                esc = run.escalator.observe(rec)
                if esc is not None:
                    self._preempt_for(run, esc)

    def _preempt_for(self, beneficiary: _JobRun, esc: Dict) -> None:
        from ..observe.events import PreemptEvent

        ben = beneficiary.job
        victims = [
            r for r in self._running.values()
            if r.job.kind == TRAIN and r.job.priority < ben.priority and not r.preempt_pending
        ]
        # lowest priority first; among equals the youngest segment (the
        # least sunk work) takes the hit
        victims.sort(key=lambda r: (r.job.priority, -r.started_mono))
        for victim in victims:
            reason = f"slo_burn:{ben.job_id}"
            if not victim.supervisor.request_preempt(reason):
                continue  # budget spent: the bullied job keeps its chips
            victim.preempt_pending = True
            self.preempt_count += 1
            self._reserved.setdefault(ben.job_id, []).extend(victim.device_ranks)
            sup = victim.supervisor
            budget_left = max(0, sup.config.preemption_budget - sup.preempt_count)
            self._job_event(
                victim.job, "preempting", world=len(victim.device_ranks), device_ranks=list(victim.device_ranks),
                reason=reason,
            )
            self._emit(
                PreemptEvent(
                    victim=victim.job.job_id, beneficiary=ben.job_id, reason="slo_burn",
                    device_ranks=list(victim.device_ranks), victim_priority=victim.job.priority,
                    beneficiary_priority=ben.priority, budget_left=budget_left,
                )
            )
            return

    # -- reaping -----------------------------------------------------------

    def _reap(self) -> None:
        now = time.monotonic()
        for job_id in list(self._running):
            run = self._running[job_id]
            if run.thread.is_alive():
                continue
            run.thread.join()
            del self._running[job_id]
            job = run.job
            job.chip_seconds += (now - run.started_mono) * len(run.device_ranks)
            with self._inv_lock:
                self._free.extend(run.device_ranks)
                self._free.sort()
            # a finished job releases any reservation held on its behalf
            self._reserved.pop(job_id, None)
            res = run.result
            if run.error is not None:
                self._strike(job, None, f"supervisor error: {run.error!r}")
            elif res is not None and res.success:
                self._complete(job, now)
            elif res is not None and res.preempted:
                job.preemptions += 1
                self._job_event(job, "parked", chip_seconds=job.chip_seconds, reason=res.reason)
                self._parked_ids.add(job_id)
                self.spool.park(job)
            else:
                rc = None
                if res is not None and res.exit_codes:
                    nonzero = [c for c in res.exit_codes.values() if c]
                    rc = nonzero[0] if nonzero else 0
                self._strike(job, rc, res.reason if res is not None else "no result")

    def _complete(self, job: JobManifest, now: float) -> None:
        job.work_done = float(job.steps) if job.steps else 1.0
        met = None
        if job.deadline_s is not None:
            met = (now - self._born[job.job_id]) <= job.deadline_s
        self._job_event(job, "completed", chip_seconds=job.chip_seconds, work_done=job.work_done, met_deadline=met)
        self.spool.complete(job, met_deadline=met)
        self._final[job.job_id] = {
            "state": "completed",
            "kind": job.kind,
            "priority": job.priority,
            "chip_seconds": job.chip_seconds,
            "work_done": job.work_done,
            "met_deadline": met,
            "preemptions": job.preemptions,
            "strikes": job.strikes,
        }

    def _strike(self, job: JobManifest, rc: Optional[int], reason: str) -> None:
        job.strikes += 1
        job.last_rc = rc
        if job.strikes >= job.max_strikes:
            from ..observe.events import JobFailedEvent

            self._emit(
                JobFailedEvent(
                    job_id=job.job_id, strikes=job.strikes, last_rc=rc, kind=job.kind, priority=job.priority,
                    reason=reason,
                )
            )
            self._job_event(
                job, "failed", chip_seconds=job.chip_seconds,
                reason=f"quarantined after {job.strikes} strikes: {reason}",
            )
            self.spool.quarantine(job, reason)
            self._final[job.job_id] = {
                "state": "quarantined",
                "kind": job.kind,
                "priority": job.priority,
                "chip_seconds": job.chip_seconds,
                "work_done": 0.0,
                "met_deadline": False if job.deadline_s is not None else None,
                "preemptions": job.preemptions,
                "strikes": job.strikes,
                "last_rc": rc,
            }
        else:
            self._job_event(
                job, "parked", chip_seconds=job.chip_seconds, reason=f"strike {job.strikes}/{job.max_strikes}: {reason}"
            )
            self._parked_ids.add(job.job_id)
            self.spool.park(job)

    # -- the driving loop --------------------------------------------------

    def run(self) -> Dict:
        t0 = time.monotonic()
        deadline = t0 + self.cfg.max_wall_s if self.cfg.max_wall_s is not None else None
        try:
            while True:
                self._claim_new()
                self._reap()
                self._escalate()
                self._admit()
                if not self._running and not self._pending and self.spool.queued() == 0:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    self._stop_admitting = True
                    for run in self._running.values():
                        if not run.preempt_pending:
                            run.supervisor.request_preempt("fleet_deadline")
                            run.preempt_pending = True
                    if not self._running:
                        break
                time.sleep(self.cfg.poll_s)
        finally:
            if self._own_telemetry and self.telemetry is not None:
                self.telemetry.close()
        return self.summary(wall_s=time.monotonic() - t0)

    def summary(self, wall_s: Optional[float] = None) -> Dict:
        """Deadline-weighted goodput over every chip-second the fleet spent:
        completed work counts 1.0 when its deadline was met (or it had
        none), 0.5 when missed; quarantined jobs burned chips for no work
        and lower the ratio."""
        total_chip_s = sum(rec["chip_seconds"] for rec in self._final.values())
        weighted = 0.0
        for rec in self._final.values():
            if rec["state"] != "completed":
                continue
            weighted += (0.5 if rec["met_deadline"] is False else 1.0) * rec["work_done"]
        completed = sorted(j for j, r in self._final.items() if r["state"] == "completed")
        quarantined = sorted(j for j, r in self._final.items() if r["state"] == "quarantined")
        out = {
            "n_devices": self.cfg.n_devices,
            "jobs": dict(sorted(self._final.items())),
            "completed": completed,
            "quarantined": quarantined,
            "unfinished": sorted(set(self._born) - set(completed) - set(quarantined)),
            "preemptions": self.preempt_count,
            "total_chip_seconds": total_chip_s,
            "weighted_work": weighted,
            "goodput": (weighted / total_chip_s) if total_chip_s else 0.0,
        }
        if wall_s is not None:
            out["wall_s"] = wall_s
        return out


# ---------------------------------------------------------------------------
# the command line (``launch fleet`` delegates here)
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fleet", description="gang-schedule spooled jobs over a fixed chip inventory")
    p.add_argument("--spool-dir", required=True, help="job spool root")
    p.add_argument("--devices", type=int, default=4, help="chip inventory")
    p.add_argument("--run-dir", default=None, help="fleet run directory")
    p.add_argument("--submit", default=None, help="JSON file with a list of job manifests to submit first")
    p.add_argument("--max-wall-s", type=float, default=None)
    p.add_argument("--poll-s", type=float, default=0.05)
    p.add_argument("--out", default=None, help="write the goodput summary JSON here")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    from ..serving.frontend import _atomic_write

    args = build_parser().parse_args(argv)
    spool = JobSpool(args.spool_dir)
    spool.recover()
    if args.submit:
        with open(args.submit) as f:
            docs = json.load(f)
        spool.submit([JobManifest.from_wire(d) for d in docs])
    cfg = FleetConfig(n_devices=args.devices, poll_s=args.poll_s, max_wall_s=args.max_wall_s)
    summary = FleetScheduler(spool, config=cfg, run_dir=args.run_dir).run()
    if args.out:
        _atomic_write(args.out, summary)
    return 0 if not summary["unfinished"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
