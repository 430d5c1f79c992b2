"""The host half of the port's serving (``serving/{request,blocks,frontend}
.py``, ``observe/events.py``, ``resilience/supervisor.py`` and the
engine's ``spec_accept`` and ``padded_static_decode_steps``), mirroring the
JAX package's ``tests/test_serving.py:79-202`` and
``tests/test_paged_serving.py:73-144``, and held to the JAX package's
functions where they compute something: the workload drawn from a seed,
the SLO summary, the event records, the accept rule and the step count.
"""

import importlib
import json
import os

import pytest

from network_distributed_pytorch_tpu_torch.observe import KVPoolEvent, RequestEvent, tree_bytes
from network_distributed_pytorch_tpu_torch.resilience import ENV_INCARNATION, incarnation_from_env
from network_distributed_pytorch_tpu_torch.serving import (
    FINISHED,
    BurnEscalator,
    FileSpool,
    LifecycleError,
    Request,
    WorkloadConfig,
    poisson_workload,
    serve_from_spool,
    slo_summary,
)
from network_distributed_pytorch_tpu_torch.serving.blocks import (
    GARBAGE_BLOCK,
    BlockLeakError,
    BlockPool,
    OutOfBlocks,
    PrefixIndex,
    blocks_needed,
    prefix_key,
)
from network_distributed_pytorch_tpu_torch.serving.engine import padded_static_decode_steps, spec_accept

jax_serving = importlib.import_module("network_distributed_pytorch_tpu.serving")
jax_blocks = importlib.import_module("network_distributed_pytorch_tpu.serving.blocks")
jax_engine = importlib.import_module("network_distributed_pytorch_tpu.serving.engine")
jax_events = importlib.import_module("network_distributed_pytorch_tpu.observe.events")


def _finish(r, tokens=(1,), t=(0.0, 0.0, 0.0, 1.0)):
    r.mark_enqueued(t[0])
    r.mark_prefilling(t[1])
    r.mark_decoding(t[2])
    for tok in tokens:
        r.add_token(tok)
    r.finish(t[3])
    return r


# --- request lifecycle -----------------------------------------------------


def test_request_lifecycle_latency_split_and_event():
    r = Request(request_id="a", prompt=[1, 2, 3], max_new_tokens=2)
    with pytest.raises(LifecycleError):
        r.mark_decoding(0.0)  # queued -> decoding skips prefill
    with pytest.raises(LifecycleError):
        r.event()  # non-terminal
    r.mark_enqueued(1.0)
    r.mark_prefilling(2.5)
    r.mark_decoding(3.0)
    r.add_token(5)
    assert not r.done
    r.add_token(6)
    assert r.done  # budget exhausted
    r.finish(4.0)
    assert r.state == FINISHED
    assert r.queue_s == 1.5 and r.prefill_s == 0.5
    assert r.decode_s == 1.0 and r.total_s == 3.0
    rec = r.event(label="t", rank=3).record()
    assert rec["event"] == "request" and rec["state"] == "finished"
    assert rec["tokens_generated"] == 2 and rec["rank"] == 3
    with pytest.raises(LifecycleError):
        r.add_token(7)  # terminal


def test_request_event_record_equals_the_jax_record():
    """The same lifecycle through both packages' ``Request`` gives the same
    ``RequestEvent.record()``."""
    recs = []
    for mod in (importlib.import_module("network_distributed_pytorch_tpu_torch.serving"), jax_serving):
        r = mod.Request(request_id="x", prompt=[4, 5], max_new_tokens=3, eos_token_id=9)
        _finish(r, tokens=(2, 9), t=(0.5, 1.0, 1.25, 2.0))
        recs.append(r.event(label="serve_gpt", rank=1).record())
    assert recs[0] == recs[1]
    assert recs[0]["queue_s"] == 0.5 and recs[0]["decode_s"] == 0.75


def test_kv_pool_event_record_equals_the_jax_record():
    fields = dict(
        label="t", rank=0, n_blocks=33, block_len=8, blocks_free=10, blocks_used=22, blocks_shared=6,
        pool_bytes=1 << 20, prefix_hits_total=7, prefill_tokens_saved_total=56, cow_copies_total=2,
        admissions_deferred_total=3,
    )
    assert KVPoolEvent(**fields).record() == jax_events.KVPoolEvent(**fields).record()
    assert RequestEvent(request_id="r", state="evicted").record() == jax_events.RequestEvent(
        request_id="r", state="evicted"
    ).record()


def test_request_eos_stop_and_requeue_reset():
    r = Request(request_id="b", prompt=[1], max_new_tokens=8, eos_token_id=9)
    r.mark_enqueued(0.0)
    r.mark_prefilling(0.0)
    r.mark_decoding(0.0)
    r.add_token(4)
    r.add_token(9)
    assert r.done  # EOS, budget unspent
    fresh = r.reset_for_requeue()
    assert fresh.state == "queued" and fresh.tokens == []
    assert fresh.requeues == 1 and fresh.prompt == [1]
    # the wire round trip carries the description and requeues, not progress
    back = Request.loads(fresh.dumps())
    assert back.requeues == 1 and back.eos_token_id == 9
    assert back.tokens == [] and back.max_new_tokens == 8
    assert back.to_wire() == jax_serving.Request.loads(fresh.dumps()).to_wire()


# --- the workload and the SLO summary against the JAX package -------------

WORKLOADS = {
    "default": {},
    "serve_small": {"n_requests": 16, "rate_rps": 64.0, "prompt_len": (4, 12), "max_new_tokens": (2, 16), "seed": 714},
    "serve_full": {"n_requests": 32, "rate_rps": 64.0, "prompt_len": (8, 32), "max_new_tokens": (2, 64),
                   "vocab": 1024, "seed": 714},
    "burst": {"n_requests": 1000, "rate_rps": 0.0, "eos_token_id": 3, "seed": 5},
}


@pytest.mark.parametrize("case", list(WORKLOADS))
def test_poisson_workload_equals_jax(case):
    got = poisson_workload(WorkloadConfig(**WORKLOADS[case]))
    want = jax_serving.poisson_workload(jax_serving.WorkloadConfig(**WORKLOADS[case]))
    assert [r.to_wire() for r in got] == [r.to_wire() for r in want]


def test_slo_summary_equals_jax():
    """The same finished, evicted and one-token requests, timed alike,
    through both summaries."""
    out = []
    for mod in (importlib.import_module("network_distributed_pytorch_tpu_torch.serving"), jax_serving):
        reqs = []
        for i, n in enumerate((1, 3, 5, 8, 2, 13)):
            r = mod.Request(request_id=f"r{i}", prompt=[1, 2], max_new_tokens=n)
            _finish(r, tokens=range(n), t=(0.1 * i, 0.1 * i + 0.01 * n, 0.1 * i + 0.02 * n, 0.1 * i + 0.05 * n))
            reqs.append(r)
        ev = mod.Request(request_id="e", prompt=[1], max_new_tokens=4)
        ev.mark_enqueued(0.0)
        ev.evict(0.5, reason="shutdown")
        out.append(mod.slo_summary(reqs + [ev]))
    assert out[0] == out[1]
    assert out[0]["n_finished"] == 6 and out[0]["n_evicted"] == 1 and out[0]["total_tokens"] == 32


def test_slo_summary_of_nothing():
    assert slo_summary([]) == jax_serving.slo_summary([])


# --- the file spool --------------------------------------------------------


def test_spool_ensure_claim_complete_idempotent(tmp_path):
    root = str(tmp_path / "spool")
    reqs = poisson_workload(WorkloadConfig(n_requests=3, rate_rps=0.0))
    producer = FileSpool(root)
    assert producer.ensure(reqs) == 3
    assert producer.ensure(reqs) == 0  # idempotent
    worker = FileSpool(root, rank=0, incarnation=0)
    got = worker.claim()
    assert got.request_id == reqs[0].request_id  # FIFO by id
    _finish(got)
    worker.complete(got)
    assert producer.ensure(reqs) == 0  # done requests never re-enqueue
    assert got.request_id in worker.done_ids()
    assert not worker.drained()  # two still queued
    # a duplicate queue file for a done id is dropped, not served twice
    with open(os.path.join(root, "queue", f"{got.request_id}.json"), "w") as f:
        json.dump(got.to_wire(), f)
    ids = {worker.claim().request_id, worker.claim().request_id}
    assert got.request_id not in ids and worker.claim() is None


def test_spool_requeue_orphans_never_steals_live_claims(tmp_path):
    root = str(tmp_path / "spool")
    reqs = poisson_workload(WorkloadConfig(n_requests=4, rate_rps=0.0))
    FileSpool(root).ensure(reqs)
    live = FileSpool(root, rank=0, incarnation=0)
    dead_peer = FileSpool(root, rank=1, incarnation=0)
    a = live.claim()
    b = dead_peer.claim()
    assert a is not None and b is not None
    # same world, everyone at their current incarnation: nothing is dead
    assert live.requeue_orphans(world=2) == 0
    # the world shrank past rank 1 and rank 0 restarted: both claims orphaned
    survivor = FileSpool(root, rank=0, incarnation=1)
    assert survivor.requeue_orphans(world=1) == 2
    ids = {survivor.claim().request_id for _ in range(4)}
    assert {a.request_id, b.request_id} <= ids
    assert survivor.claim() is None


def test_spool_requeue_skips_completed_orphans(tmp_path):
    root = str(tmp_path / "spool")
    FileSpool(root).ensure(poisson_workload(WorkloadConfig(n_requests=1, rate_rps=0.0)))
    dying = FileSpool(root, rank=1, incarnation=0)
    r = _finish(dying.claim())
    # the completion record landed but the claim's release did not
    doc = {"request_id": r.request_id, "state": r.state, "tokens": list(r.tokens),
           "tokens_generated": len(r.tokens), "requeues": 0, "rank": 1, "incarnation": 0}
    with open(os.path.join(root, "done", f"{r.request_id}.json"), "w") as f:
        json.dump(doc, f)
    survivor = FileSpool(root, rank=0, incarnation=0)
    assert survivor.requeue_orphans(world=1) == 0
    assert survivor.claim() is None and survivor.drained()


def test_spool_doc_release_reclaim_roundtrip(tmp_path):
    root = str(tmp_path / "spool")
    FileSpool(root).ensure_docs({"only": {"doc_id": "only", "steps_done": 0}})
    first = FileSpool(root, rank=0, incarnation=0)
    entry_id, doc = first.claim_doc()
    first.release_doc(entry_id, dict(doc, steps_done=7))
    assert not first.drained() and first.requeue_orphans(world=1) == 0
    second = FileSpool(root, rank=0, incarnation=1)
    entry_id2, doc2 = second.claim_doc()
    assert entry_id2 == "only" and doc2["steps_done"] == 7
    second.complete_doc(entry_id2, dict(doc2, state="done"))
    assert second.drained() and second.queue_depth() == 0


class _ToyEngine:
    """The duck-typed engine ``serve_from_spool`` drives, with a token that
    depends on the request alone, so a re-queued request decodes the same
    tokens on the survivor."""

    def __init__(self, n_slots):
        self.n_slots, self.queue, self.active, self._done = n_slots, [], [], []

    @property
    def queue_len(self):
        return len(self.queue)

    @property
    def idle(self):
        return not self.queue and not self.active

    def submit(self, r):
        r.mark_enqueued(0.0)
        self.queue.append(r)

    def step(self):
        while self.queue and len(self.active) < self.n_slots:
            r = self.queue.pop(0)
            r.mark_prefilling(0.0)
            r.mark_decoding(0.0)
            self.active.append(r)
        for r in list(self.active):
            r.add_token((sum(r.prompt) + len(r.tokens)) % 7)
            if r.done:
                r.finish(1.0)
                self.active.remove(r)
                self._done.append(r)
        return True

    def take_finished(self):
        out, self._done = self._done, []
        return out


def test_serve_from_spool_requeues_a_dead_ranks_claims(tmp_path):
    root = str(tmp_path / "spool")
    reqs = poisson_workload(WorkloadConfig(n_requests=6, rate_rps=0.0, max_new_tokens=(3, 6)))
    FileSpool(root).ensure(reqs)
    dying = FileSpool(root, rank=1, incarnation=0)
    for _ in range(2):
        dying.claim()  # claimed, never completed: the rank died mid-decode
    served = serve_from_spool(_ToyEngine(2), FileSpool(root, rank=0, incarnation=1), world=1, max_wall_s=30.0)
    assert served["completed"] == 6 and served["requeued_orphans"] == 2
    records = FileSpool(root).done_records()
    assert set(records) == {r.request_id for r in reqs}
    assert sum(rec["requeues"] for rec in records.values()) == 2
    assert slo_summary(served["requests"])["n_finished"] == 6


def test_incarnation_from_env(monkeypatch):
    monkeypatch.delenv(ENV_INCARNATION, raising=False)
    assert incarnation_from_env() == 0
    monkeypatch.setenv(ENV_INCARNATION, "3")
    assert incarnation_from_env() == 3
    monkeypatch.setenv(ENV_INCARNATION, "x")
    assert incarnation_from_env(default=5) == 5


def test_burn_escalator_sustains_and_cools_down():
    clock = iter([0.0, 1.0, 40.0]).__next__
    esc = BurnEscalator(sustain=2, cooldown_s=30.0, clock=clock)
    assert esc.observe({"alert": "other"}) is None
    assert esc.observe({"alert": "slo_burn"}) is None  # streak 1 of 2
    first = esc.observe({"alert": "slo_burn", "value": 2.0})
    assert first["action"] == "scale_up" and first["escalation"] == 1
    assert esc.observe({"alert": "slo_burn"}) is None  # streak 1 of 2 again
    assert esc.observe({"alert": "slo_burn"}) is None  # sustained, but inside the cooldown
    assert esc.observe({"alert": "slo_burn"})["escalation"] == 2  # 40 s on


def test_tree_bytes_counts_tensors():
    import torch

    cache = [{"k": torch.zeros(2, 3, dtype=torch.bfloat16), "v": torch.zeros(2, 3)}, (torch.zeros(4, dtype=torch.long),)]
    assert tree_bytes(cache) == 12 + 24 + 32 and tree_bytes(None) == 0 and tree_bytes([]) == 0


# --- the block allocator and the prefix index -----------------------------


def test_blocks_needed_and_prefix_key():
    for n, want in ((0, 0), (1, 1), (4, 1), (5, 2)):
        assert blocks_needed(n, 4) == jax_blocks.blocks_needed(n, 4) == want
    assert prefix_key([1, 2, 3]) == prefix_key((1, 2, 3)) == jax_blocks.prefix_key([1, 2, 3])
    assert prefix_key([1, 2, 3]) != prefix_key([1, 2])


def test_block_pool_alloc_link_release_refcounts():
    pool = BlockPool(6, 4)  # 5 usable, block 0 is garbage
    assert pool.n_usable == 5 and pool.n_free == 5
    a = pool.alloc(2)
    assert a == [1, 2]  # deterministic ascending order
    assert all(pool.refcount(b) == 1 for b in a)
    with pytest.raises(OutOfBlocks):
        pool.alloc(4)  # all-or-nothing
    assert pool.n_free == 3
    pool.link(a)
    assert all(pool.refcount(b) == 2 for b in a)
    assert pool.release(a) == []
    assert pool.release(a) == a
    assert pool.n_free == 5
    with pytest.raises(BlockLeakError):
        pool.release([1])  # double free
    with pytest.raises(BlockLeakError):
        pool.link([1])  # linking an unallocated block
    assert pool.release([GARBAGE_BLOCK]) == []
    with pytest.raises(ValueError):
        BlockPool(1, 4)


def test_block_pool_check_owners_catches_discrepancies():
    pool = BlockPool(5, 4)
    chain = pool.alloc(2)
    pool.check_owners([chain])
    with pytest.raises(BlockLeakError):
        pool.check_owners([])  # allocated but unowned
    with pytest.raises(BlockLeakError):
        pool.check_owners([chain, chain])  # multiplicity != refcount
    pool.link(chain)
    pool.check_owners([chain, chain])
    pool.release(chain)
    pool.release(chain)
    pool.check_owners([])


def test_prefix_index_register_lookup_evict_lru():
    pool = BlockPool(10, 4)
    prompt = [1, 2, 3, 4, 5, 6]  # one full block + a partial
    chain = pool.alloc(blocks_needed(len(prompt), 4))
    idx = PrefixIndex(pool)
    assert idx.register(prompt, chain, first_token=42) == 2
    hit = idx.lookup(prompt)
    assert hit["n_tokens"] == 6 and hit["first_token"] == 42
    assert pool.refcount(chain[0]) == 3  # slot + 2 index entries
    hit = idx.lookup([1, 2, 3, 4, 9, 9, 9])
    assert hit["n_tokens"] == 4 and hit["first_token"] is None
    assert idx.lookup([7, 7, 7]) is None
    assert (idx.hits, idx.misses) == (2, 1)
    pool.check_owners([chain] + idx.chains())
    pool.release(chain)
    idx.evict_lru(pool.n_usable)
    assert len(idx) == 0 and pool.n_free == pool.n_usable
    pool.check_owners([])


def test_prefix_index_matches_jax_on_the_same_history():
    """Register, look up and evict the same prompts in both packages'
    indexes: the same hits, allocations and refcounts."""
    ops = [("reg", [1, 2, 3, 4, 5, 6, 7, 8, 9]), ("reg", [1, 2, 3, 4, 7]), ("look", [1, 2, 3, 4, 5, 6, 7, 8, 0]),
           ("look", [1, 2, 3, 4, 7]), ("look", [5, 5]), ("evict", 9), ("look", [1, 2, 3, 4])]
    seen = []
    for mod in (importlib.import_module("network_distributed_pytorch_tpu_torch.serving.blocks"), jax_blocks):
        pool = mod.BlockPool(12, 4)
        idx = mod.PrefixIndex(pool)
        trace = []
        for op, arg in ops:
            if op == "reg":
                chain = pool.alloc(mod.blocks_needed(len(arg), 4))
                trace.append(("reg", chain, idx.register(arg, chain, first_token=len(arg))))
                pool.release(chain)
            elif op == "look":
                trace.append(("look", idx.lookup(arg)))
            else:
                trace.append(("evict", idx.evict_lru(arg), pool.n_free))
        trace.append([pool.refcount(b) for b in range(12)])
        seen.append(trace)
    assert seen[0] == seen[1]


# --- the speculative accept rule and the static-batching foil -------------

SPEC_CASES = {
    # self-draft: every proposal is the target's own greedy token
    "self_draft": ([5, 7, 8, 9], [7, 8, 9, 4], 10, None, [7, 8, 9, 4]),
    # fed[2] contradicts outs[1]: the corrected token lands, nothing after
    "adversarial": ([5, 7, 6, 9], [7, 8, 9, 4], 10, None, [7, 8]),
    "first_miss": ([5, 1, 1, 1], [7, 8, 9, 4], 10, None, [7]),
    "budget": ([5, 7, 8, 9], [7, 8, 9, 4], 2, None, [7, 8]),
    "eos": ([5, 7, 8, 9], [7, 8, 9, 4], 10, 8, [7, 8]),
    "budget_one": ([5, 7, 8, 9], [7, 8, 9, 4], 1, None, [7]),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_accept_matches_jax(case):
    fed, outs, budget, eos, want = SPEC_CASES[case]
    assert spec_accept(fed, outs, budget, eos) == want
    assert jax_engine.spec_accept(fed, outs, budget, eos) == want


STATIC_CASES = [([], 4, 0), ([1, 1, 1], 2, 0), ([5], 1, 4), ([8, 2, 2, 2], 2, 8), ([3, 9, 4, 4, 7], 3, 14)]


@pytest.mark.parametrize("lengths,batch,want", STATIC_CASES)
def test_padded_static_decode_steps_matches_jax(lengths, batch, want):
    assert padded_static_decode_steps(lengths, batch) == want
    assert jax_engine.padded_static_decode_steps(lengths, batch) == want


def test_padded_static_decode_steps_refuses_batch_zero():
    with pytest.raises(ValueError):
        padded_static_decode_steps([3], 0)
