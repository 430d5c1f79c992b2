"""Deterministic fault injection: the ``ChaosPlan``, the JAX package's
``resilience/chaos.py``.

A chaos plan is a seeded, schedule-driven list of faults (kind x trigger
step x target rank x incarnation) threaded into the layers that can fail.
Every trigger is a step INDEX, not a wall-clock timer, so an injected
failure is exactly reproducible, which makes the chaos matrix a test suite.

The registry keeps all 24 kinds of the JAX package, so every plan it
accepts also loads here. Where they bite in the port:

====================  =======================================================
``loader_bad_batch``     the loader yields a NaN-poisoned batch
                         (:func:`chaos_batches`, on the host batch)
``loader_short_batch``   the loader yields a batch cut to half its leading dim
``loader_slow_shard``    every batch of a window pays a fixed host sleep
``loader_skewed_shard``  the same, the sleep ramping over the window
``step_transient``       the step raises a transient ``RuntimeError``
                         (:class:`ChaosStep`)
``step_nan``             the step reports a NaN loss without touching state
``oom``                  the step dies with a ``RESOURCE_EXHAUSTED`` error
``ckpt_torn``            the checkpoint just written loses its commit marker
                         and half of its largest payload file
                         (:func:`apply_checkpoint_fault`)
``ckpt_bitflip``         one seeded byte of the largest payload file flips
``ckpt_unwritable``      the checkpoint root loses its write permission
``proc_exit``            the worker exits with ``CHAOS_EXIT_CODE`` (43)
``proc_kill``            the worker SIGKILLs itself
``proc_hang``            the worker sleeps (its heartbeat goes stale)
``proc_preempt``         the worker SIGTERMs itself (``PreemptionGuard``)
``zone_outage``          every rank of ``payload["ranks"]`` SIGKILLs itself
``host_flap``            the rank SIGKILLs itself in each of its first
                         ``payload["flaps"]`` lives
``comm_throttle``        every collective launch of the rank sleeps its
                         bytes over a mock line rate (:class:`CommFaultInjector`,
                         a ``parallel.comm`` fence hook), for a window
``comm_flap``            the same throttle, clearing after 3 steps
``comm_slow_edge``       the same throttle, paid by the edge's source rank
``comm_stall``           one chunk's launch sleeps ``stall_seconds``, once
``comm_partition``       every launch sleeps ``max_sleep_s`` and
                         ``partitioned`` holds until ``comm_heal``
``comm_heal``            clears a partition and a throttle
``grad_spike``           the health sampler's reading times ``factor``: the
                         toy test worker's ``--health-every`` pops it, as
                         the JAX package's toy worker does (the live plane's
                         spike detector pages on it); no training path pops
                         it, as none of the JAX package's does
``fidelity_degrade``     accepted and registered; nothing on the port's
                         paths pops it (no fidelity sampler of the toy)
====================  =======================================================

Process- and step-level faults carry an ``incarnation`` filter (default 0)
so a supervisor-restarted worker does not re-crash on the same schedule.

Every rank of a run loads the same plan. In the JAX package one process
drives the whole mesh; in the port each rank is a process, and a step
fault that made one rank retry (or a loader fault that made one rank drop
a batch) while its peers stepped on would leave them waiting in the step's
collectives. So :class:`ChaosStep` takes the ``world_size``: at step ``i``
each rank also looks for a step fault aimed at another rank, and raises
its peer twin (the same error, or the same NaN loss, without the
``chaos_injected`` event). The ranks retry together, and no collective is
added to the step. Checkpoint faults at a world above one are applied
once, by rank 0, unless the spec names the rank.

Imports no torch at import time: the supervising parent and the toy test
workers load plans without a device runtime. The checkpoint helpers import
``utils.checkpoint`` (torch) when they run, and an emitted event imports
``observe``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from dataclasses import dataclass, field
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple,
)

import numpy as np

# one definition of each, in .guards (a worker that honoured SIGTERM: 75, a
# graceful death; a checkpoint directory that refused the save: 44, a hard
# death that fails the run fast), importable from here as in the JAX package
from .guards import CKPT_UNWRITABLE_EXIT_CODE, PREEMPT_EXIT_CODE  # noqa: F401

LOADER_FAULTS = (
    "loader_bad_batch", "loader_short_batch",
    "loader_slow_shard", "loader_skewed_shard",
)
STEP_FAULTS = ("step_transient", "step_nan")
CHECKPOINT_FAULTS = ("ckpt_torn", "ckpt_bitflip", "ckpt_unwritable")
PROCESS_FAULTS = ("proc_exit", "proc_kill", "proc_hang", "proc_preempt")
# correlated faults: the production failure modes single-rank chaos can't
# express. ``zone_outage`` SIGKILLs every rank in ``payload["ranks"]`` in
# the same tick (each process pops its own plan instance, so one spec with
# rank=None fires on every zone member); ``host_flap`` re-kills the same
# rank each life until ``payload["flaps"]`` restarts have burned.
CORRELATED_FAULTS = ("zone_outage", "host_flap")
# ``comm_slow_edge`` is the heterogeneous-link fault: a per-rank-pair
# throttle (payload {"edge": [src, dst], "bytes_per_s": ...}) that only
# the edge's SRC rank pays, so a per-edge blame pipeline (observe.critpath
# / observe.fabric) can be verified end to end against a known-slow link.
# ``comm_partition`` / ``comm_heal`` are the geo-resilience pair: a
# partition (payload {"edge": [src, dst], "max_sleep_s": ..., optional
# "duration_steps": ...}) makes every collective launch on the target rank
# block long enough to trip the outer-deadline watchdog AND flips the
# host-visible ``partitioned`` flag host-only workers poll; a heal clears it
# (emitting ``comm_fault_cleared``) so the rejoin path can run.
COMM_FAULTS = (
    "comm_throttle", "comm_stall", "comm_flap", "comm_slow_edge",
    "comm_partition", "comm_heal",
)
HEALTH_FAULTS = ("grad_spike", "fidelity_degrade")
# memory faults bite at the step boundary like STEP_FAULTS, but are their
# own group so host-only workers (the toy test worker) can pop them
# without also claiming the transient/NaN kinds
MEMORY_FAULTS = ("oom",)
FAULT_KINDS = (
    LOADER_FAULTS + STEP_FAULTS + CHECKPOINT_FAULTS + PROCESS_FAULTS
    + CORRELATED_FAULTS + COMM_FAULTS + HEALTH_FAULTS + MEMORY_FAULTS
)

# The registry the satellite asks for: every fault kind names the ONE
# injection site that consumes it, and every registered kind must be in
# FAULT_KINDS. ``check_fault_registry`` asserts the bijection at import
# time, so adding a kind to a group without teaching an injector about it
# (or vice versa) fails the first import instead of silently never firing.
INJECTION_SITES: Dict[str, str] = {
    "loader_bad_batch": "loader",       # chaos_batches
    "loader_short_batch": "loader",     # chaos_batches
    "loader_slow_shard": "loader",      # chaos_batches (timing, not content)
    "loader_skewed_shard": "loader",    # chaos_batches (timing, not content)
    "step_transient": "step",           # ChaosStep
    "step_nan": "step",                 # ChaosStep
    "ckpt_torn": "checkpoint",          # apply_checkpoint_fault
    "ckpt_bitflip": "checkpoint",       # apply_checkpoint_fault
    "ckpt_unwritable": "checkpoint",    # apply_checkpoint_fault
    "proc_exit": "process",             # ChaosStep (process-level branch)
    "proc_kill": "process",             # ChaosStep (process-level branch)
    "proc_hang": "process",             # ChaosStep (process-level branch)
    "proc_preempt": "process",          # ChaosStep (process-level branch)
    "zone_outage": "process",           # ChaosStep (process-level branch)
    "host_flap": "process",             # ChaosStep (process-level branch)
    "comm_throttle": "comm-hook",       # CommFaultInjector fence hook
    "comm_stall": "comm-hook",          # CommFaultInjector fence hook
    "comm_flap": "comm-hook",           # CommFaultInjector fence hook
    "comm_slow_edge": "comm-hook",      # CommFaultInjector fence hook
    "comm_partition": "comm-hook",      # CommFaultInjector fence hook (and its host-side flag)
    "comm_heal": "comm-hook",           # CommFaultInjector.advance
    "grad_spike": "health-probe",       # health sampler (TrainHealthEvent)
    "fidelity_degrade": "health-probe", # health sampler (FidelityEvent group)
    "oom": "step",                      # ChaosStep (allocator-death branch)
}


def check_fault_registry() -> None:
    """Assert FAULT_KINDS and INJECTION_SITES agree exactly (both ways)."""
    kinds = set(FAULT_KINDS)
    sites = set(INJECTION_SITES)
    missing = sorted(kinds - sites)
    stray = sorted(sites - kinds)
    if missing or stray:
        raise AssertionError(
            f"fault registry drift: kinds without an injection site "
            f"{missing}; injection-site kinds not in FAULT_KINDS {stray}"
        )
    if len(FAULT_KINDS) != len(kinds):
        raise AssertionError(
            f"duplicate fault kind in FAULT_KINDS: {FAULT_KINDS}"
        )


check_fault_registry()

# exit code a chaos-injected clean crash uses — distinguishable from both
# success (0) and a signal death (negative returncode) in supervisor logs
CHAOS_EXIT_CODE = 43


class ChaosTransientError(RuntimeError):
    """The injected transient fault: a ``RuntimeError`` so the stock
    ``retry_transient`` path treats it exactly like a real blip."""


class ChaosOutOfMemoryError(RuntimeError):
    """The injected allocator death. A ``RuntimeError`` whose message is
    ``RESOURCE_EXHAUSTED``-shaped, so the guarded step's OOM detection
    (``guards.is_oom_error``, which also knows ``torch.cuda.OutOfMemoryError``)
    treats it as the real thing: write the forensics, then die, never
    retry."""


@dataclass
class FaultSpec:
    """One scheduled fault. ``step`` is the per-process step index at which
    it triggers (for checkpoint faults: the epoch of the save); ``rank``
    None matches any rank; ``incarnation`` None matches any restart
    generation (default 0: fire only in a worker's first life). ``payload``
    carries kind-specific knobs (``hang_seconds``, ``exit_code``;
    ``ranks`` restricts a correlated fault to a zone — when present it
    overrides ``rank``; ``flaps`` caps how many lives a ``host_flap``
    kills)."""

    kind: str
    step: int
    rank: Optional[int] = None
    incarnation: Optional[int] = 0
    payload: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (known: {FAULT_KINDS})"
            )
        if isinstance(self.step, bool) or not isinstance(self.step, int):
            raise ValueError(f"step must be an int, got {self.step!r}")
        if self.rank is not None and (
            isinstance(self.rank, bool) or not isinstance(self.rank, int)
        ):
            raise ValueError(f"rank must be an int or None, got {self.rank!r}")
        if self.incarnation is not None and (
            isinstance(self.incarnation, bool)
            or not isinstance(self.incarnation, int)
        ):
            raise ValueError(
                f"incarnation must be an int or None, got {self.incarnation!r}"
            )
        if not isinstance(self.payload, dict):
            raise ValueError(f"payload must be a dict, got {self.payload!r}")
        ranks = self.payload.get("ranks")
        if ranks is not None:
            if not isinstance(ranks, (list, tuple)) or not ranks or not all(
                isinstance(r, int) and not isinstance(r, bool) for r in ranks
            ):
                raise ValueError(
                    f"payload['ranks'] must be a non-empty list of ints,"
                    f" got {ranks!r}"
                )

    def matches(self, step: int, rank: int, incarnation: int) -> bool:
        if self.step != step:
            return False
        ranks = self.payload.get("ranks")
        if ranks is not None:
            if rank not in ranks:
                return False
        elif self.rank is not None and self.rank != rank:
            return False
        return self.incarnation is None or self.incarnation == incarnation


class ChaosPlan:
    """A seeded fault schedule with once-per-spec firing semantics."""

    def __init__(self, faults: Iterable[FaultSpec] = (), seed: int = 0):
        self.faults: List[FaultSpec] = list(faults)
        self.seed = seed
        self._fired: set = set()

    # -- (de)serialization: the config/JSON surface -------------------------
    def to_json(self) -> Dict:
        return {
            "seed": self.seed,
            "faults": [dataclasses.asdict(f) for f in self.faults],
        }

    @classmethod
    def from_json(cls, obj: Dict) -> "ChaosPlan":
        """Build a plan from its JSON form, validating every entry at load
        time: an unknown kind, a stray field, or a malformed value raises
        ``ValueError`` naming the offending entry index — not a crash hours
        later at injection time."""
        faults = []
        for i, f in enumerate(obj.get("faults", ())):
            if not isinstance(f, dict):
                raise ValueError(
                    f"chaos plan fault[{i}] must be an object, got {f!r}"
                )
            try:
                faults.append(FaultSpec(**f))
            except (TypeError, ValueError) as e:
                raise ValueError(f"chaos plan fault[{i}] invalid: {e}") from e
        return cls(faults=faults, seed=obj.get("seed", 0))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)
        return path

    @classmethod
    def load(cls, path: str) -> "ChaosPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))

    # -- trigger matching ---------------------------------------------------
    def pop(
        self,
        kinds: Iterable[str],
        step: int,
        rank: int = 0,
        incarnation: int = 0,
    ) -> Optional[FaultSpec]:
        """First unfired fault of one of ``kinds`` matching this (step,
        rank, incarnation); marks it fired so it triggers exactly once."""
        kinds = set(kinds)
        for i, f in enumerate(self.faults):
            if i in self._fired or f.kind not in kinds:
                continue
            if f.matches(step, rank, incarnation):
                self._fired.add(i)
                return f
        return None

    def pop_peer(
        self,
        kinds: Iterable[str],
        step: int,
        rank: int,
        world_size: int,
        incarnation: int = 0,
    ) -> Optional[FaultSpec]:
        """First unfired fault of one of ``kinds`` that matches this (step,
        incarnation) for another rank of a world of ``world_size``; marks it
        fired. How a rank sees, from its own copy of the plan, the fault its
        peer is about to raise."""
        kinds = set(kinds)
        for i, f in enumerate(self.faults):
            if i in self._fired or f.kind not in kinds:
                continue
            if any(f.matches(step, r, incarnation) for r in range(world_size) if r != rank):
                self._fired.add(i)
                return f
        return None


def _emit_injected(telemetry, spec: FaultSpec, step: int, rank: int,
                   incarnation: int, detail: str = "") -> None:
    if telemetry is None:
        return
    from ..observe import FailureEvent

    telemetry.emit(
        FailureEvent(
            kind="chaos_injected",
            label=spec.kind,
            message=detail,
            rank=rank,
            step=step,
            incarnation=incarnation,
        )
    )


class ChaosStep:
    """Wraps a training step with the plan's step- and process-level
    faults, checked at each step boundary BEFORE the real step runs.
    Attribute access (``bits_per_step``, ``ledger``, ``reducer``)
    delegates to the wrapped step so loops and audits see it unchanged.

    At ``world_size > 1`` a ``step_transient`` or ``step_nan`` aimed at
    another rank at this step raises its peer twin here (no event): every
    rank fails the same attempts, so they retry together."""

    def __init__(
        self,
        step: Callable,
        plan: ChaosPlan,
        rank: int = 0,
        incarnation: int = 0,
        telemetry: Any = None,
        world_size: int = 1,
    ):
        self._inner = step
        self._plan = plan
        self._rank = rank
        self._incarnation = incarnation
        self._telemetry = telemetry
        self._world_size = world_size
        self._step_index = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __call__(self, state, batch):
        i = self._step_index
        self._step_index += 1
        spec = self._plan.pop(
            STEP_FAULTS + PROCESS_FAULTS + CORRELATED_FAULTS + MEMORY_FAULTS,
            i, self._rank, self._incarnation,
        )
        if spec is not None:
            _emit_injected(
                self._telemetry, spec, i, self._rank, self._incarnation
            )
            if spec.kind == "proc_exit":
                os._exit(int(spec.payload.get("exit_code", CHAOS_EXIT_CODE)))
            if spec.kind in ("proc_kill", "zone_outage"):
                # zone_outage: one spec with payload["ranks"] fires on every
                # zone member in the same tick (each process pops its own
                # plan copy) — the correlated burst the quorum planner sees
                os.kill(os.getpid(), signal.SIGKILL)
            if spec.kind == "host_flap":
                # re-kill the same rank each life until the flap budget is
                # spent; a later incarnation finally survives the step
                if self._incarnation < int(spec.payload.get("flaps", 2)):
                    os.kill(os.getpid(), signal.SIGKILL)
            if spec.kind == "proc_hang":
                # stops beating AND never returns within the deadline — the
                # exact shape of a peer dead mid-collective
                time.sleep(float(spec.payload.get("hang_seconds", 3600.0)))
            if spec.kind == "proc_preempt":
                # a preemption notice, self-delivered: the Python-level
                # SIGTERM handler (PreemptionGuard) runs before the step
                # below, flags the request, and the loop commits the
                # emergency checkpoint right after this step completes
                os.kill(os.getpid(), signal.SIGTERM)
            if spec.kind == "step_transient":
                raise ChaosTransientError(
                    f"injected transient at step {i} (rank {self._rank})"
                )
            if spec.kind == "step_nan":
                # a NaN gradient burst as the guard sees it: the reported
                # loss is non-finite and the state must not advance
                return state, float("nan")
            if spec.kind == "oom":
                want = int(spec.payload.get("bytes", 1 << 30))
                raise ChaosOutOfMemoryError(
                    f"RESOURCE_EXHAUSTED: Out of memory while trying to "
                    f"allocate {want} bytes (injected at step {i}, "
                    f"rank {self._rank})"
                )
        elif self._world_size > 1:
            peer = self._plan.pop_peer(STEP_FAULTS, i, self._rank, self._world_size, self._incarnation)
            if peer is not None and peer.kind == "step_transient":
                raise ChaosTransientError(f"a peer rank's injected transient at step {i} (rank {self._rank})")
            if peer is not None:
                return state, float("nan")
        return self._inner(state, batch)


def chaos_batches(
    batches_for_epoch: Callable[[int], Iterator[Any]],
    plan: ChaosPlan,
    rank: int = 0,
    incarnation: int = 0,
    telemetry: Any = None,
) -> Callable[[int], Iterator[Any]]:
    """Wrap a per-epoch batch generator factory with the plan's loader
    faults. The trigger index counts batches ACROSS epochs within this
    process, matching the step indexing of :class:`ChaosStep`.

    Content faults (``loader_bad_batch`` / ``loader_short_batch``) poison
    ONE batch. Timing faults (``loader_slow_shard`` /
    ``loader_skewed_shard``) open a WINDOW: from the trigger batch, the
    next ``payload["batches"]`` (default 8) batches each pay a host-side
    sleep — fixed ``payload["delay_s"]`` (default 0.05) for the slow
    shard, ramping ``delay_s * (k+1)/batches`` for the skewed shard — so
    the target rank's step p50 rises and the straggler detector must name
    it with no other signal."""
    counter = {"i": 0}
    # open timing window: remaining batches, window size, per-batch delay fn
    slow: Dict[str, Any] = {"left": 0, "total": 0, "delay": None}
    rng = np.random.RandomState(plan.seed)

    def poisoned(batch, spec: FaultSpec):
        leaves = list(batch.values()) if isinstance(batch, dict) else list(batch)
        if spec.kind == "loader_bad_batch":
            bad = np.asarray(leaves[0]).copy()
            flat = bad.reshape(-1)
            # poison a seeded subset so detection can't rely on [0] alone
            n = max(1, flat.size // 8)
            idx = rng.choice(flat.size, size=n, replace=False)
            if np.issubdtype(bad.dtype, np.floating):
                flat[idx] = np.nan
            else:  # integer labels: out-of-range garbage
                flat[idx] = np.iinfo(bad.dtype).max
            leaves[0] = bad
        elif spec.kind == "loader_short_batch":
            cut = max(1, np.asarray(leaves[0]).shape[0] // 2)
            leaves = [np.asarray(a)[:cut] for a in leaves]
        if isinstance(batch, dict):
            return dict(zip(batch.keys(), leaves))
        return tuple(leaves)

    def gen(epoch: int):
        for batch in batches_for_epoch(epoch):
            i = counter["i"]
            counter["i"] += 1
            spec = plan.pop(LOADER_FAULTS, i, rank, incarnation)
            if spec is not None:
                _emit_injected(telemetry, spec, i, rank, incarnation)
                if spec.kind in ("loader_slow_shard", "loader_skewed_shard"):
                    n = max(1, int(spec.payload.get("batches", 8)))
                    delay_s = float(spec.payload.get("delay_s", 0.05))
                    if spec.kind == "loader_slow_shard":
                        slow["delay"] = lambda k: delay_s
                    else:
                        slow["delay"] = lambda k, n=n: delay_s * (k + 1) / n
                    slow["left"] = n
                    slow["total"] = n
                else:
                    batch = poisoned(batch, spec)
            if slow["left"] > 0:
                time.sleep(slow["delay"](slow["total"] - slow["left"]))
                slow["left"] -= 1
            yield batch

    return gen


class CommFaultInjector:
    """The comm faults of a plan (``COMM_FAULTS``): a callable registered as
    a ``parallel.comm`` fence hook, and :meth:`advance`, which the training
    loop calls once a step before running it.

    ``advance`` does the plan's bookkeeping on the loop's thread (pop the
    specs, start and clear throttles, emit ``chaos_injected`` and
    ``comm_fault_cleared``); ``__call__``, at the fence points of this
    rank's collectives (``device_index == rank``), only sleeps: the
    collective is delayed and not one byte is added to the wire.

    Payload knobs, the JAX package's: ``bytes_per_s`` (the mock line rate,
    10GbE by default), ``max_sleep_s`` (the clamp of a chunk's sleep),
    ``duration_steps`` / ``clears_after`` (a throttle's or a flap's life in
    steps; a flap clears after 3 by default), ``stall_seconds`` and
    ``chunk`` (which chunk's launch hangs, once)."""

    def __init__(self, plan: ChaosPlan, rank: int = 0, incarnation: int = 0, telemetry: Any = None):
        self._plan = plan
        self._rank = rank
        self._incarnation = incarnation
        self._telemetry = telemetry
        self._step_index = -1
        self._throttle: Optional[Dict[str, Any]] = None
        self._stall: Optional[Dict[str, Any]] = None
        self._partition: Optional[Dict[str, Any]] = None

    # -- the plan's bookkeeping (the loop's thread, once a step) -----------------
    @property
    def throttled(self) -> bool:
        return self._throttle is not None

    @property
    def stall_pending(self) -> bool:
        return self._stall is not None

    @property
    def partitioned(self) -> bool:
        """True while a ``comm_partition`` holds the edge down: the host
        flag the hierarchical round's ``OuterSyncDriver`` polls."""
        return self._partition is not None

    @property
    def partition_edge(self) -> Optional[Tuple[int, int]]:
        """The (src, dst) ranks of the partition (None without one, or when
        the spec named no edge)."""
        p = self._partition
        if p is None or not p.get("edge"):
            return None
        return (int(p["edge"][0]), int(p["edge"][1]))

    @property
    def throttle_edge(self) -> Optional[Tuple[int, int]]:
        """The (src, dst) ranks of a ``comm_slow_edge`` throttle (None for
        a throttle or flap without an edge)."""
        t = self._throttle
        if t is None or not t.get("edge"):
            return None
        return (int(t["edge"][0]), int(t["edge"][1]))

    def host_throttle_sleep_s(self, payload_bytes: float) -> float:
        """The sleep the hook would add to ONE collective of this payload,
        for a host that models the throttle inline; 0.0 without a throttle
        or where this rank is not the edge's source."""
        t = self._throttle
        if t is None:
            return 0.0
        edge = self.throttle_edge
        if edge is not None and edge[0] != self._rank:
            return 0.0
        return min(float(payload_bytes) / t["bytes_per_s"], t["max_sleep_s"])

    def _emit_cleared(self, kind: str, step_index: int) -> None:
        if self._telemetry is None:
            return
        from ..observe import FailureEvent

        self._telemetry.emit(
            FailureEvent(
                kind="comm_fault_cleared", label=kind, rank=self._rank, step=step_index,
                incarnation=self._incarnation,
            )
        )

    def advance(self, step_index: int) -> None:
        """Retire an expiring throttle, flap or partition and pop the comm
        fault scheduled for ``step_index``. Call it before the step."""
        self._step_index = step_index
        t = self._throttle
        if t is not None and t["until_step"] is not None and step_index >= t["until_step"]:
            self._throttle = None
            self._emit_cleared(t["kind"], step_index)
        part = self._partition
        if part is not None and part["until_step"] is not None and step_index >= part["until_step"]:
            self._partition = None
            self._emit_cleared("comm_partition", step_index)
        spec = self._plan.pop(COMM_FAULTS, step_index, self._rank, self._incarnation)
        if spec is None:
            return
        _emit_injected(self._telemetry, spec, step_index, self._rank, self._incarnation)
        p = spec.payload
        if spec.kind == "comm_partition":
            duration = p.get("duration_steps")
            self._partition = {
                "edge": [int(x) for x in p["edge"]] if p.get("edge") else None,
                # the block of a launch: long enough to blow any sane outer
                # deadline, short enough that a run without a watchdog ends
                "max_sleep_s": float(p.get("max_sleep_s", 0.5)),
                "until_step": step_index + int(duration) if duration is not None else None,
            }
        elif spec.kind == "comm_heal":
            if self._partition is not None:
                self._partition = None
                self._emit_cleared("comm_partition", step_index)
            if self._throttle is not None:
                t = self._throttle
                self._throttle = None
                self._emit_cleared(t["kind"], step_index)
        elif spec.kind in ("comm_throttle", "comm_flap", "comm_slow_edge"):
            clears = p.get("clears_after", 3 if spec.kind == "comm_flap" else None)
            if clears is None:
                clears = p.get("duration_steps")
            edge = p.get("edge")
            if spec.kind == "comm_slow_edge":
                # a link's throttle, paid by its source rank only; a spec
                # that another rank pops keeps the edge for the blame
                edge = [int(x) for x in (edge or (self._rank, self._rank + 1))]
            self._throttle = {
                "kind": spec.kind,
                "edge": edge,
                "bytes_per_s": float(p.get("bytes_per_s", 1.25e9)),
                "max_sleep_s": float(p.get("max_sleep_s", 0.25)),
                "until_step": step_index + int(clears) if clears is not None else None,
            }
        elif spec.kind == "comm_stall":
            self._stall = {"stall_seconds": float(p.get("stall_seconds", 1.0)), "chunk": int(p.get("chunk", 0))}

    # -- the fence hook ------------------------------------------------------------
    def __call__(self, info: Dict[str, Any]) -> None:
        if info.get("device_index") != self._rank or info.get("phase") != "launch":
            return
        part = self._partition
        if part is not None:
            # the edge is DOWN, not slow: block each launch for the clamp, so
            # that a deadline derived from the healthy fabric expires, then
            # let the collective through
            time.sleep(part["max_sleep_s"])
            return
        st = self._stall
        if st is not None and info.get("chunk") == st["chunk"]:
            self._stall = None  # one collective hangs, once
            time.sleep(st["stall_seconds"])
            return
        t = self._throttle
        if t is not None:
            sleep_s = min(float(info.get("payload_bytes", 0)) / t["bytes_per_s"], t["max_sleep_s"])
            if sleep_s > 0:
                time.sleep(sleep_s)


def apply_checkpoint_fault(
    plan: ChaosPlan,
    checkpoint_root: str,
    epoch: int,
    rank: int = 0,
    incarnation: int = 0,
    telemetry: Any = None,
    world_size: int = 1,
) -> Optional[str]:
    """After a ``step_<epoch>`` checkpoint lands, apply any scheduled
    checkpoint fault to it. ``ckpt_torn`` recreates the on-disk state of a
    crash mid-save (commit marker gone, payload truncated); ``ckpt_bitflip``
    flips one byte of the largest payload file while leaving the commit
    marker intact — only the checksum manifest can catch it;
    ``ckpt_unwritable`` revokes write permission on the checkpoint root so
    the NEXT commit fails mid-write — the restart-storm scenario the
    fail-fast path exists for. Returns the fault kind applied, if any."""
    spec = plan.pop(CHECKPOINT_FAULTS, epoch, rank, incarnation)
    if spec is None:
        return None
    root = os.path.abspath(checkpoint_root)
    path = os.path.join(root, f"step_{epoch}")
    if spec.kind == "ckpt_torn":
        tear_checkpoint(path)
    elif spec.kind == "ckpt_unwritable":
        make_checkpoint_unwritable(root)
        path = root
    else:
        bitflip_checkpoint(path, seed=plan.seed)
    _emit_injected(telemetry, spec, epoch, rank, incarnation, detail=path)
    return spec.kind


def _largest_payload_file(path: str) -> Optional[str]:
    """The largest payload file of a step directory (``replicated.pt`` or a
    ``rank_RRRRR.pt``), the protocol files left out."""
    from ..utils.checkpoint import _payload_files

    files = _payload_files(path)
    if not files:
        return None
    return max(files, key=lambda rel: os.path.getsize(os.path.join(path, rel)))


def tear_checkpoint(path: str) -> None:
    """Turn a committed checkpoint into what a mid-save crash leaves: no
    ``_COMMITTED`` marker, and a truncated payload file."""
    from ..utils.checkpoint import COMMITTED_MARKER

    marker = os.path.join(path, COMMITTED_MARKER)
    if os.path.isfile(marker):
        os.remove(marker)
    victim = _largest_payload_file(path)
    if victim is not None:
        full = os.path.join(path, victim)
        size = os.path.getsize(full)
        with open(full, "r+b") as f:
            f.truncate(size // 2)


def bitflip_checkpoint(path: str, seed: int = 0) -> None:
    """Flip one seeded byte of the largest payload file, leaving the commit
    marker and manifest untouched (silent corruption)."""
    victim = _largest_payload_file(path)
    if victim is None:
        return
    full = os.path.join(path, victim)
    size = os.path.getsize(full)
    if size == 0:
        return
    offset = np.random.RandomState(seed).randint(0, size)
    with open(full, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0xFF]))


def make_checkpoint_unwritable(root: str) -> None:
    """Revoke write+search-create permission on the checkpoint root
    (``r-x`` for the owner): existing checkpoints stay readable, but the
    next commit's staging mkdir fails with ``EACCES`` — the exact shape of
    a filer going read-only mid-run. Caveat: processes running as root
    bypass permission bits, so tests exercising the fail-fast path under
    root should break writability structurally (e.g. occupy the staging
    path with a file) instead."""
    os.chmod(root, 0o500)


def restore_checkpoint_writable(root: str) -> None:
    """Undo :func:`make_checkpoint_unwritable` (test cleanup)."""
    os.chmod(root, 0o700)
