"""Simulated client frontend + the elastic file-spool request queue,
copied from the JAX package's ``serving/frontend.py``. Two pieces:

- **Workload**: :func:`poisson_workload` draws a deterministic open-loop
  workload — Poisson arrivals at ``rate_rps``, uniform prompt/decode
  length distributions — and :func:`replay` feeds it to an engine on the
  wall clock (requests are submitted when their arrival offset passes, so
  queue latency is real scheduling delay, not an artifact).

- **Fail-over spool**: :class:`FileSpool` is the fleet's shared request
  queue as a directory — ``queue/`` (JSON request files), ``claimed/``
  (per-``rank.incarnation`` claim dirs; a claim is one atomic
  ``os.rename``, so exactly one rank wins each request), ``done/``
  (idempotent completion records). A rank that dies mid-decode simply
  leaves claims without completions; :meth:`FileSpool.requeue_orphans`
  moves provably-dead identities' claims back to ``queue/`` — own-rank
  claims from EARLIER incarnations (my predecessor crashed) and claims by
  ranks outside the current world (the world shrank past them) — so a
  supervised degraded restart re-queues the dead rank's in-flight
  requests on the survivors instead of aborting them. Liveness is decided
  by identity, not heartbeats: no live worker ever matches either rule,
  so a requeue can never steal an in-progress claim.

:func:`serve_from_spool` is the worker loop gluing the two halves: claim
up to the engine's appetite, step, complete what finishes, and exit only
when the whole workload manifest is done — a worker whose peers died
keeps polling until orphan re-queueing (its own on restart, or anyone's
after a world shrink) lets it finish the stragglers.

The spool's claim protocol is deliberately entry-agnostic: the typed
``Request`` methods (:meth:`FileSpool.claim` / ``ensure`` / ``complete``)
are thin wrappers over doc-level primitives (``claim_doc`` /
``ensure_docs`` / ``complete_doc`` / ``release_doc``) that move opaque
JSON documents through the same ``queue/ -> claimed/ -> done/`` rename
dance, which a job scheduler can reuse for its manifests (the JAX
package's ``resilience/scheduler.py`` does; the port has none yet).

:class:`BurnEscalator` is the serving side's hook into a control plane: a
stateful filter over alert records that turns a sustained ``slo_burn``
into a single rate-limited scale-up escalation.

:func:`replay` steps the engine whenever it has work (each tick already
waits for the card to read its tokens) and sleeps ``poll_s`` only while
the engine is idle, so it does not spin a core against the card's queue.
"""

from __future__ import annotations

import json
import os
import random
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .request import Request

MANIFEST = "workload.json"


@dataclass(frozen=True)
class WorkloadConfig:
    """A deterministic simulated workload (same seed -> same requests,
    which is what makes spool enqueueing idempotent across restarts)."""

    n_requests: int = 16
    rate_rps: float = 64.0  # Poisson arrival rate
    prompt_len: Tuple[int, int] = (4, 12)  # uniform inclusive range
    max_new_tokens: Tuple[int, int] = (4, 16)  # uniform inclusive range
    vocab: int = 64
    eos_token_id: Optional[int] = None
    seed: int = 714


def poisson_workload(cfg: WorkloadConfig) -> List[Request]:
    """Draw the workload: exponential inter-arrival gaps (Poisson process)
    and uniform prompt/decode lengths, with zero-padded deterministic ids
    so lexicographic spool order == arrival order."""
    rng = random.Random(cfg.seed)
    width = max(4, len(str(max(0, cfg.n_requests - 1))))
    out: List[Request] = []
    t = 0.0
    for i in range(cfg.n_requests):
        t += rng.expovariate(cfg.rate_rps) if cfg.rate_rps > 0 else 0.0
        p_lo, p_hi = cfg.prompt_len
        d_lo, d_hi = cfg.max_new_tokens
        prompt_len = rng.randint(p_lo, p_hi)
        out.append(
            Request(
                request_id=f"req-{i:0{width}d}",
                prompt=[rng.randrange(cfg.vocab) for _ in range(prompt_len)],
                max_new_tokens=rng.randint(d_lo, d_hi),
                eos_token_id=cfg.eos_token_id,
                arrival_s=t,
            )
        )
    return out


def replay(
    engine,
    requests: Sequence[Request],
    poll_s: float = 0.002,
    max_wall_s: Optional[float] = None,
) -> List[Request]:
    """Open-loop replay against a live engine: each request is submitted
    once its arrival offset passes on the wall clock, the engine steps
    whenever it has work, and the call returns every finished request once
    the workload drains."""
    pending = sorted(requests, key=lambda r: (r.arrival_s, r.request_id))
    finished: List[Request] = []
    t0 = time.monotonic()
    while pending or not engine.idle:
        if max_wall_s is not None and time.monotonic() - t0 > max_wall_s:
            raise TimeoutError(
                f"replay exceeded {max_wall_s}s with {len(pending)} pending"
            )
        now = time.monotonic() - t0
        while pending and pending[0].arrival_s <= now:
            engine.submit(pending.pop(0))
        if engine.idle:
            # nothing in flight: sleep up to the next arrival
            if pending:
                time.sleep(min(poll_s, max(0.0, pending[0].arrival_s - now)))
            continue
        engine.step()
        finished.extend(engine.take_finished())
    return finished


# --- the elastic file-spool queue ----------------------------------------


def _atomic_write(path: str, doc: Dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


class FileSpool:
    """Filesystem request queue with crash-safe claim/complete semantics.

    Construct workers with their supervisor identity (``rank``,
    ``incarnation`` — the env contract ``resilience.supervisor`` exports);
    a producer/inspector needs neither. All mutations are single atomic
    renames/replaces, so any number of workers race safely on a shared
    (local or NFS-like) directory.
    """

    def __init__(
        self, root: str, rank: Optional[int] = None, incarnation: int = 0
    ):
        self.root = root
        self.rank = rank
        self.incarnation = incarnation
        self.queue_dir = os.path.join(root, "queue")
        self.claimed_root = os.path.join(root, "claimed")
        self.done_dir = os.path.join(root, "done")
        for d in (self.queue_dir, self.claimed_root, self.done_dir):
            os.makedirs(d, exist_ok=True)
        self.claim_dir = None
        if rank is not None:
            self.claim_dir = os.path.join(
                self.claimed_root, f"r{rank}.i{incarnation}"
            )
            os.makedirs(self.claim_dir, exist_ok=True)

    # --- producer side ----------------------------------------------------

    def _exists_anywhere(self, request_id: str) -> bool:
        name = f"{request_id}.json"
        if os.path.exists(os.path.join(self.queue_dir, name)):
            return True
        if os.path.exists(os.path.join(self.done_dir, name)):
            return True
        for d in self._claim_dirs():
            if os.path.exists(os.path.join(self.claimed_root, d, name)):
                return True
        return False

    def ensure_docs(self, docs: Dict[str, Dict]) -> int:
        """Doc-level idempotent enqueue: entries already queued, claimed,
        or done are skipped, and the workload manifest — the id set
        :meth:`drained` checks completion against — is (re)written as the
        union of everything ever manifested. The generic primitive behind
        :meth:`ensure`; the job spool enqueues manifests through it."""
        ids = sorted(docs)
        known = set()
        manifest_path = os.path.join(self.root, MANIFEST)
        try:
            with open(manifest_path) as f:
                known = set(json.load(f).get("request_ids", []))
        except (OSError, ValueError):
            pass
        _atomic_write(
            manifest_path, {"request_ids": sorted(known | set(ids))}
        )
        added = 0
        for entry_id in ids:
            if self._exists_anywhere(entry_id):
                continue
            _atomic_write(
                os.path.join(self.queue_dir, f"{entry_id}.json"),
                docs[entry_id],
            )
            added += 1
        return added

    def ensure(self, requests: Iterable[Request]) -> int:
        """Idempotently enqueue a workload: requests already queued,
        claimed, or done are skipped (a restarted rank re-running the
        deterministic workload generator enqueues nothing twice). Stamps
        the producer wall clock so the eventual claimer charges the
        spool-sitting time to the request's queue phase."""
        now = time.time()
        docs = {}
        for r in requests:
            doc = r.to_wire()
            if doc.get("spooled_unix") is None:
                doc["spooled_unix"] = now
            docs[r.request_id] = doc
        return self.ensure_docs(docs)

    def manifest_ids(self) -> List[str]:
        try:
            with open(os.path.join(self.root, MANIFEST)) as f:
                return sorted(json.load(f).get("request_ids", []))
        except (OSError, ValueError):
            return []

    # --- worker side ------------------------------------------------------

    def _claim_dirs(self) -> List[str]:
        try:
            return sorted(
                d for d in os.listdir(self.claimed_root)
                if os.path.isdir(os.path.join(self.claimed_root, d))
            )
        except OSError:
            return []

    def _is_done(self, request_id: str) -> bool:
        return os.path.exists(
            os.path.join(self.done_dir, f"{request_id}.json")
        )

    def claim_doc(self) -> Optional[Tuple[str, Dict]]:
        """Claim the oldest queued entry via atomic rename into this
        worker's claim dir and return ``(entry_id, doc)``; None when the
        queue is empty (or every race was lost — the caller just polls
        again). The generic primitive behind :meth:`claim`."""
        if self.claim_dir is None:
            raise ValueError("claim() needs a worker FileSpool (rank=...)")
        try:
            names = sorted(os.listdir(self.queue_dir))
        except OSError:
            return None
        for name in names:
            if not name.endswith(".json"):
                continue
            entry_id = name[: -len(".json")]
            src = os.path.join(self.queue_dir, name)
            if self._is_done(entry_id):
                # post-crash duplicate (requeued after completion landed):
                # drop it rather than serve the same entry twice
                try:
                    os.unlink(src)
                except OSError:
                    pass
                continue
            dst = os.path.join(self.claim_dir, name)
            try:
                os.rename(src, dst)
            except OSError:
                continue  # lost the race; try the next file
            try:
                with open(dst) as f:
                    return entry_id, json.load(f)
            except (OSError, ValueError):
                continue  # torn claim file — leave it for requeue
        return None

    def claim(self) -> Optional[Request]:
        """Claim the oldest queued request; None when the queue is empty
        (or every race was lost — the caller just polls again)."""
        got = self.claim_doc()
        return None if got is None else Request.from_wire(got[1])

    def complete_doc(self, entry_id: str, doc: Dict) -> None:
        """Record a completion document (idempotent: last writer wins with
        identical semantics) and release this worker's claim, if any."""
        _atomic_write(
            os.path.join(self.done_dir, f"{entry_id}.json"), doc
        )
        if self.claim_dir is not None:
            try:
                os.unlink(os.path.join(self.claim_dir, f"{entry_id}.json"))
            except OSError:
                pass

    def release_doc(self, entry_id: str, doc: Dict) -> None:
        """Voluntarily park a LIVE claim back onto the queue with an
        updated document — the claim holder's own act, never a peer's
        (peers only take provably-dead claims via
        :meth:`requeue_orphans`). The fleet scheduler parks a preempted
        job's manifest through this so the job re-enters queue order with
        its resume state attached.

        Ownership is proven BEFORE parking: the claim file is atomically
        renamed to a private ``.releasing`` name (invisible to every
        ``*.json`` scan), and only a successful rename parks the doc. A
        worker that was stalled (SIGSTOP, GC pause, NFS hiccup) long
        enough for the world to shrink past it loses its claim to a
        peer's :meth:`requeue_orphans`; when it resumes, the rename fails
        and the release no-ops — re-parking a stolen claim would put a
        second live copy of the entry in circulation."""
        if self.claim_dir is None:
            raise ValueError("release_doc() needs a worker FileSpool")
        claim = os.path.join(self.claim_dir, f"{entry_id}.json")
        proof = f"{claim}.releasing"
        try:
            os.rename(claim, proof)
        except OSError:
            return  # claim already stolen (or completed) — nothing to park
        _atomic_write(
            os.path.join(self.queue_dir, f"{entry_id}.json"), doc
        )
        try:
            os.unlink(proof)
        except OSError:
            pass

    def complete(self, request: Request, extra: Optional[Dict] = None) -> None:
        """Record completion (idempotent: last writer wins with identical
        semantics) and release the claim."""
        doc = {
            "request_id": request.request_id,
            "state": request.state,
            "tokens": list(request.tokens),
            "tokens_generated": len(request.tokens),
            "requeues": request.requeues,
            "rank": self.rank,
            "incarnation": self.incarnation,
        }
        if extra:
            doc.update(extra)
        self.complete_doc(request.request_id, doc)

    def requeue_orphans(self, world: int) -> int:
        """Move provably-dead identities' claims back to the queue.

        An identity ``r{R}.i{I}`` is provably dead when ``R >= world``
        (the world shrank past it — after a degraded restart every
        survivor was relaunched under a new incarnation, so any claim by a
        now-out-of-range rank is orphaned) or when ``R == self.rank and
        I < self.incarnation`` (my own crashed predecessor). No live
        worker matches either rule, so this never steals an in-progress
        claim. Requeued requests carry an incremented ``requeues`` count
        into their eventual RequestEvent."""
        if self.rank is None:
            raise ValueError("requeue_orphans() needs a worker FileSpool")
        moved = 0
        for d in self._claim_dirs():
            try:
                r_part, i_part = d.split(".", 1)
                r, i = int(r_part[1:]), int(i_part[1:])
            except (ValueError, IndexError):
                continue
            dead = r >= world or (r == self.rank and i < self.incarnation)
            if not dead:
                continue
            dpath = os.path.join(self.claimed_root, d)
            try:
                names = sorted(os.listdir(dpath))
            except OSError:
                continue
            for name in names:
                if not name.endswith(".json"):
                    continue
                src = os.path.join(dpath, name)
                request_id = name[: -len(".json")]
                try:
                    with open(src) as f:
                        doc = json.load(f)
                except (OSError, ValueError):
                    continue
                if not self._is_done(request_id):
                    doc["requeues"] = int(doc.get("requeues", 0)) + 1
                    _atomic_write(
                        os.path.join(self.queue_dir, name), doc
                    )
                    moved += 1
                try:
                    os.unlink(src)
                except OSError:
                    pass
        return moved

    # --- inspection -------------------------------------------------------

    def queue_depth(self) -> int:
        """Entries sitting UNCLAIMED in ``queue/`` right now — the
        backlog gauge the serving autoscaler scales on (claimed-in-flight
        work is a worker's problem; queued work is a capacity problem)."""
        try:
            return sum(
                1 for n in os.listdir(self.queue_dir) if n.endswith(".json")
            )
        except OSError:
            return 0

    def done_ids(self) -> List[str]:
        try:
            return sorted(
                n[: -len(".json")] for n in os.listdir(self.done_dir)
                if n.endswith(".json")
            )
        except OSError:
            return []

    def done_records(self) -> Dict[str, Dict]:
        out: Dict[str, Dict] = {}
        for rid in self.done_ids():
            try:
                with open(
                    os.path.join(self.done_dir, f"{rid}.json")
                ) as f:
                    out[rid] = json.load(f)
            except (OSError, ValueError):
                pass
        return out

    def drained(self) -> bool:
        """The whole manifested workload has completion records. False
        while the manifest is missing (the producer has not enqueued
        yet) — workers poll rather than exit on an empty spool."""
        ids = self.manifest_ids()
        if not ids:
            return False
        return all(self._is_done(rid) for rid in ids)


def serve_from_spool(
    engine,
    spool: FileSpool,
    world: int,
    poll_s: float = 0.02,
    max_wall_s: Optional[float] = None,
) -> Dict:
    """The elastic worker loop: requeue provably-dead orphans, then claim /
    step / complete until the whole workload manifest is drained. ``engine``
    is duck-typed (``submit / step / take_finished / idle / n_slots /
    queue_len``), so :class:`serving.engine.SlotEngine`,
    :class:`serving.engine.PagedEngine` and a toy engine share this loop."""
    requeued = spool.requeue_orphans(world)
    completed = 0
    finished: List[Request] = []
    t0 = time.monotonic()
    while True:
        if max_wall_s is not None and time.monotonic() - t0 > max_wall_s:
            raise TimeoutError(
                f"serve_from_spool exceeded {max_wall_s}s"
                f" ({completed} completed locally)"
            )
        # keep the local backlog at one slot-fill's worth; the rest stays
        # in the spool where other ranks can claim it (load balancing)
        while engine.queue_len < engine.n_slots:
            req = spool.claim()
            if req is None:
                break
            engine.submit(req)
            if req.spooled_unix is not None and req.enqueued_t is not None:
                # backdate the queue phase to the producer's enqueue: the
                # spool-sitting wait is the latency an overloaded pool
                # inflates, and hiding it would blind the SLO burn gauge
                # the autoscaler scales on
                req.enqueued_t -= max(0.0, time.time() - req.spooled_unix)
        if engine.idle:
            if spool.drained():
                break
            # queue empty but peers still hold claims: poll (their death
            # will surface as orphans after the supervisor restarts us)
            time.sleep(poll_s)
            continue
        engine.step()
        for req in engine.take_finished():
            spool.complete(req)
            completed += 1
            finished.append(req)
    return {
        "completed": completed,
        "requeued_orphans": requeued,
        "rank": spool.rank,
        "incarnation": spool.incarnation,
        "requests": finished,
    }


def slo_summary(requests: Sequence[Request]) -> Dict:
    """Host-side SLO aggregate over terminal requests (the in-process
    twin of the report's per-run SLO table): p50/p99 of each latency
    phase plus decode ms/token and throughput."""

    def pct(values: List[float], p: float) -> Optional[float]:
        if not values:
            return None
        vs = sorted(values)
        k = max(0, min(len(vs) - 1, int(round(p / 100.0 * len(vs) + 0.5)) - 1))
        return vs[k]

    finished = [r for r in requests if r.state == "finished"]
    out: Dict = {
        "n_requests": len(requests),
        "n_finished": len(finished),
        "n_evicted": sum(1 for r in requests if r.state == "evicted"),
        "n_failed": sum(1 for r in requests if r.state == "failed"),
    }
    for phase in ("queue_s", "prefill_s", "decode_s", "total_s"):
        vals = [
            getattr(r, phase) for r in finished
            if getattr(r, phase) is not None
        ]
        out[f"p50_{phase}"] = pct(vals, 50)
        out[f"p99_{phase}"] = pct(vals, 99)
    per_tok = [
        1e3 * r.decode_s / (len(r.tokens) - 1)
        for r in finished
        if r.decode_s is not None and len(r.tokens) > 1
    ]
    out["p50_decode_ms_per_token"] = pct(per_tok, 50)
    out["p99_decode_ms_per_token"] = pct(per_tok, 99)
    total_tokens = sum(len(r.tokens) for r in finished)
    span = [
        (r.enqueued_t, r.terminal_t) for r in finished
        if r.enqueued_t is not None and r.terminal_t is not None
    ]
    if span and total_tokens:
        t0 = min(s for s, _ in span)
        t1 = max(e for _, e in span)
        out["tokens_per_s"] = total_tokens / (t1 - t0) if t1 > t0 else None
    else:
        out["tokens_per_s"] = None
    out["total_tokens"] = total_tokens
    return out


class BurnEscalator:
    """Turns a stream of live-plane alert records into rate-limited
    scale-up escalations.

    The serving pool's supervisor already appends every fired detector
    verdict to ``alerts.jsonl`` (tailed with ``observe.live.AlertFeed``);
    this filter watches that stream for the SLO-burn detector and decides
    when the pool should ask the fleet scheduler for more chips. A single
    transient burn alert is noise — the detector itself requires a
    sustained breach, and this adds a second sustain window at the
    escalation layer plus a cooldown so a continuously-burning pool asks
    once per ``cooldown_s``, not once per alert. Jax-free and clock-
    injectable for tests.
    """

    def __init__(
        self,
        alert: str = "slo_burn",
        sustain: int = 1,
        cooldown_s: float = 30.0,
        clock=time.monotonic,
    ):
        self.alert = alert
        self.sustain = max(1, sustain)
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._streak = 0
        self._last_escalation: Optional[float] = None
        self.escalations = 0

    def observe(self, record: Dict) -> Optional[Dict]:
        """Feed one alert record; returns an escalation decision dict when
        the sustained-burn + cooldown conditions are met, else None."""
        if record.get("alert") != self.alert:
            return None
        self._streak += 1
        if self._streak < self.sustain:
            return None
        now = self._clock()
        if (
            self._last_escalation is not None
            and now - self._last_escalation < self.cooldown_s
        ):
            return None
        self._last_escalation = now
        self._streak = 0
        self.escalations += 1
        return {
            "action": "scale_up",
            "alert": self.alert,
            "severity": record.get("severity", "warn"),
            "value": record.get("value"),
            "threshold": record.get("threshold"),
            "escalation": self.escalations,
        }
