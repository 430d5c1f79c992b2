"""A toy serving worker for the fleet's tests (run as a subprocess), the
port's counterpart of ``toy_serving_worker.py``: one rank of a
spool-serving pool with no model and no jax.

A :class:`ToyEngine` implements the duck-typed engine protocol that the
port's ``serving.frontend.serve_from_spool`` drives (``submit / step /
take_finished / idle / n_slots / queue_len``) with a deterministic token
function in place of the GPT decoder: each token depends only on the
request itself, so a request that dies mid-decode on one rank and is
re-queued decodes the same tokens on another. The spool protocol, the
request lifecycle, the terminal ``observe.RequestEvent`` telemetry and the
orphan re-queue rules are the port's own ``serving/`` code; only the model
is a toy. It imports the port's ``observe`` and ``serving`` (and so torch)
but never touches a card.

With a supervisor-exported run directory the worker writes its telemetry
to its rank's shard there (``observe.runlog.shard_event_log_from_env``),
where the live plane's detectors read the requests' latencies.
``--die-after-claims N`` makes the worker SIGKILL itself (incarnation 0
only) right after a decode tick once it has admitted at least N requests
and still holds some in flight: a mid-decode death with unreleased claims.

Usage::

    python torch_toy_serving_worker.py --rank R --world W --spool-dir D \\
        --result-dir D [--slots 2] [--step-seconds S] [--paged] \\
        [--block-len L] [--pool-blocks N] [--die-after-claims N] [--max-wall-s S]
"""

import argparse
import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from network_distributed_pytorch_tpu_torch.observe import telemetry_for_run  # noqa: E402
from network_distributed_pytorch_tpu_torch.observe.runlog import shard_event_log_from_env  # noqa: E402
from network_distributed_pytorch_tpu_torch.resilience.supervisor import incarnation_from_env  # noqa: E402
from network_distributed_pytorch_tpu_torch.serving import FileSpool, Request, serve_from_spool  # noqa: E402

TOY_VOCAB = 64


def toy_token(request: Request) -> int:
    """Deterministic next token: a pure function of the request's own
    prompt and progress, never of batch-mates or the serving rank — so
    fail-over to another rank reproduces identical completions."""
    return (sum(request.prompt) + 7 * len(request.tokens)) % TOY_VOCAB


class ToyEngine:
    """The SlotEngine's host-side scheduling, with :func:`toy_token` in
    place of the compiled decode step (same backfill-then-tick order, same
    lifecycle transitions, same terminal RequestEvents).

    With ``pool`` set (a real ``serving.blocks.BlockPool``), admission is
    gated by the PAGED allocator: a request only enters a slot when its
    whole decode horizon's KV blocks can be granted, admission stops at
    the first out-of-blocks request (strict FIFO backpressure, same rule
    as ``PagedEngine``), blocks are returned exactly once on finish, and
    the refcount-leak invariant is asserted after every tick — the paged
    bookkeeping under storm load, minus the model."""

    def __init__(self, n_slots, telemetry=None, rank=None,
                 step_seconds=0.0, label="toy_serving",
                 pool=None, block_len=4):
        self.n_slots = n_slots
        self.telemetry = telemetry
        self.rank = rank
        self.step_seconds = step_seconds
        self.label = label
        self.slots = [None] * n_slots
        self.chains = [None] * n_slots  # paged mode: per-slot block chain
        self.pool = pool
        self.block_len = block_len
        self.queue = []
        self._finished = []
        self.submits = 0
        self.decode_steps = 0
        self.prefills = 0
        self.admissions_deferred = 0

    def submit(self, request):
        request.mark_enqueued(time.monotonic())
        self.queue.append(request)
        self.submits += 1

    @property
    def n_active(self):
        return sum(1 for s in self.slots if s is not None)

    @property
    def queue_len(self):
        return len(self.queue)

    @property
    def idle(self):
        return not self.queue and self.n_active == 0

    def take_finished(self):
        out, self._finished = self._finished, []
        return out

    def _terminal(self, request):
        if self.telemetry is not None:
            self.telemetry.emit(
                request.event(label=self.label, rank=self.rank)
            )
        self._finished.append(request)

    def _admit_blocks(self, r):
        """Paged admission gate: all-or-nothing alloc for the request's
        whole horizon. Returns the chain, or None on out-of-blocks."""
        if self.pool is None:
            return []
        from network_distributed_pytorch_tpu_torch.serving.blocks import OutOfBlocks, blocks_needed

        need = blocks_needed(
            len(r.prompt) + r.max_new_tokens, self.block_len
        )
        try:
            return self.pool.alloc(need)
        except OutOfBlocks:
            return None

    def _release_blocks(self, s):
        if self.pool is not None and self.chains[s]:
            self.pool.release(self.chains[s])
        self.chains[s] = None

    def _check_leaks(self):
        if self.pool is not None:
            self.pool.check_owners([c for c in self.chains if c])

    def step(self):
        before = self.prefills
        now = time.monotonic()
        for s in range(self.n_slots):
            if not self.queue:
                break
            if self.slots[s] is None:
                chain = self._admit_blocks(self.queue[0])
                if chain is None:
                    # out of KV blocks: the request stays at the queue
                    # head (strict FIFO) until a finisher frees its chain
                    self.admissions_deferred += 1
                    break
                r = self.queue.pop(0)
                r.mark_prefilling(now)
                self.prefills += 1
                r.mark_decoding(time.monotonic())
                r.add_token(toy_token(r))
                if r.done:
                    if self.pool is not None and chain:
                        self.pool.release(chain)
                    r.finish(time.monotonic())
                    self._terminal(r)
                else:
                    self.slots[s] = r
                    self.chains[s] = chain
        occupied = [s for s in range(self.n_slots) if self.slots[s] is not None]
        if not occupied:
            self._check_leaks()
            return self.prefills != before
        if self.step_seconds:
            time.sleep(self.step_seconds)
        self.decode_steps += 1
        now = time.monotonic()
        for s in occupied:
            r = self.slots[s]
            r.add_token(toy_token(r))
            if r.done:
                self._release_blocks(s)
                r.finish(now)
                self._terminal(r)
                self.slots[s] = None
        self._check_leaks()
        return True


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--spool-dir", required=True)
    p.add_argument("--result-dir", required=True)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--step-seconds", type=float, default=0.005)
    p.add_argument("--max-wall-s", type=float, default=60.0)
    p.add_argument(
        "--paged", action="store_true",
        help="gate admission with a real serving.blocks.BlockPool"
             " (paged-allocator backpressure + leak checks)",
    )
    p.add_argument("--block-len", type=int, default=4)
    p.add_argument("--pool-blocks", type=int, default=None,
                   help="pool size; default sizes for slots*horizon")
    p.add_argument(
        "--die-after-claims", type=int, default=None, metavar="N",
        help="incarnation 0 only: SIGKILL self mid-decode once N requests"
             " have been admitted and some are still in flight",
    )
    args = p.parse_args()

    incarnation = incarnation_from_env()
    os.makedirs(args.result_dir, exist_ok=True)

    event_log = shard_event_log_from_env()
    telemetry = (
        telemetry_for_run(event_log=event_log, stdout=False)
        if event_log else None
    )

    spool = FileSpool(args.spool_dir, rank=args.rank, incarnation=incarnation)
    pool = None
    if args.paged:
        from network_distributed_pytorch_tpu_torch.serving.blocks import BlockPool

        # default: room for all slots at a 32-token horizon, + garbage
        n_blocks = args.pool_blocks or (
            args.slots * (32 // args.block_len + 1) + 1
        )
        pool = BlockPool(n_blocks, args.block_len)
    engine = ToyEngine(
        args.slots, telemetry=telemetry, rank=args.rank,
        step_seconds=args.step_seconds,
        pool=pool, block_len=args.block_len,
    )

    if args.die_after_claims is not None and incarnation == 0:
        # mid-decode death: strike AFTER a tick, with claims unreleased —
        # this step's finished-but-uncompleted requests are orphaned too
        # (re-queue must recover them, idempotently)
        plain_step = engine.step

        def step_then_maybe_die():
            worked = plain_step()
            if engine.submits >= args.die_after_claims and engine.n_active:
                os.kill(os.getpid(), signal.SIGKILL)
            return worked

        engine.step = step_then_maybe_die

    served = serve_from_spool(
        engine, spool, world=args.world, max_wall_s=args.max_wall_s
    )
    served.pop("requests", None)  # Request objects aren't JSON

    if telemetry is not None:
        telemetry.close()
    with open(
        os.path.join(args.result_dir, f"rank{args.rank}.json"), "w"
    ) as f:
        json.dump(
            {"rank": args.rank, "world": args.world,
             "incarnation": incarnation,
             "decode_steps": engine.decode_steps,
             "prefills": engine.prefills,
             "paged": bool(args.paged),
             "admissions_deferred": engine.admissions_deferred,
             **served},
            f,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
