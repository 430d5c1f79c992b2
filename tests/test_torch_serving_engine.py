"""The port's serving engines against the JAX package's, on the CPU: the
tiny GPT with its weights drawn with numpy and carried across by
``gpt_state_dict_from_flax``.

- The three serving steps (``gpt_decode_step_slots`` with a position per
  row, ``gpt_decode_step_paged`` through block tables, and
  ``gpt_prefill_shared`` over a prefix's K/V) against the JAX functions:
  logits and caches at ``TOL`` (as ``tests/test_torch_gpt.py``), positions
  past the cache included (JAX clamps them).
- The engines' tokens exactly: ``SlotEngine`` against the port's
  ``generate(cache_len=max_len)`` and the JAX ``SlotEngine`` on the same
  requests and schedule; ``PagedEngine`` against the dense engine and the
  JAX ``PagedEngine``;
  speculative decoding under a self-draft and an adversarial draft;
  prefix sharing (eight requests on one prompt prefilled once, and
  block-aligned prefixes with distinct suffixes) against the same
  requests unshared; copy-on-write leaving the shared blocks' K/V intact.
- Eviction exactly once and the leak assertion, FIFO backpressure, the
  continuous-batching step count.
- ``serve_gpt`` at preset small, its counts against the JAX entry's, the
  spool mode, and the launcher's serve flags.

Same shapes give the same bits within the port (the slot and the paged
step, the draft and the target), so those are held bitwise.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu_torch import launch
from network_distributed_pytorch_tpu_torch.experiments import serve_gpt
from network_distributed_pytorch_tpu_torch.models import gpt
from network_distributed_pytorch_tpu_torch.models.import_weights import gpt_state_dict_from_flax
from network_distributed_pytorch_tpu_torch.serving import FileSpool, Request
from network_distributed_pytorch_tpu_torch.serving.blocks import BlockLeakError
from network_distributed_pytorch_tpu_torch.serving.cache import (
    init_slot_cache,
    read_chain,
    read_slot,
    serving_state_template,
    write_slot,
)
from network_distributed_pytorch_tpu_torch.serving.engine import (
    PagedEngine,
    SlotEngine,
    padded_static_decode_steps,
)
from network_distributed_pytorch_tpu_torch.utils.checkpoint import save_checkpoint
from torch_parity import random_gpt_params, to_numpy
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

jax_gpt = importlib.import_module("network_distributed_pytorch_tpu.models.gpt")
jax_engine = importlib.import_module("network_distributed_pytorch_tpu.serving.engine")
jax_serving = importlib.import_module("network_distributed_pytorch_tpu.serving")
jax_serve_gpt = importlib.import_module("network_distributed_pytorch_tpu.experiments.serve_gpt")

TOL = 1e-5
MAX_LEN, VOCAB, BLOCK = 32, 64, 4
H, D = 4, 8  # gpt_tiny: dim 32, 4 heads


class _Capture:
    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)


def _jax_config():
    return jax_gpt.gpt_tiny(vocab_size=VOCAB, max_position_embeddings=MAX_LEN).config


def _port_model(params, dtype=torch.float32):
    model = gpt.gpt_tiny(dtype=dtype, device="cpu", vocab_size=VOCAB, max_position_embeddings=MAX_LEN)
    model.load_state_dict(gpt_state_dict_from_flax({"params": to_numpy(params)}))
    return model.eval()


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(
        jnp.asarray, random_gpt_params(jax_gpt.gpt_tiny(vocab_size=VOCAB, max_position_embeddings=MAX_LEN), MAX_LEN, 1)
    )


@pytest.fixture(scope="module")
def model(params):
    return _port_model(params)


def _mixed_requests(seed, n=5):
    rng = np.random.RandomState(seed)
    reqs = []
    for i, budget in enumerate((4, 6, 3, 5, 4, 7, 2, 6)[:n]):
        prompt = [int(t) for t in rng.randint(0, VOCAB, rng.randint(2, 9))]
        reqs.append(Request(request_id=f"req-{i:04d}", prompt=prompt, max_new_tokens=budget))
    return reqs


def _copies(reqs, module=None):
    make = Request if module is None else module.Request
    return [make(request_id=r.request_id, prompt=list(r.prompt), max_new_tokens=r.max_new_tokens) for r in reqs]


def _drive(engine, reqs):
    """Three requests up front, two ticks, the rest admitted mid-flight into
    slots freed by earlier completions; then drain."""
    for r in reqs[:3]:
        engine.submit(r)
    engine.step()
    engine.step()
    for r in reqs[3:]:
        engine.submit(r)
    finished = engine.run(max_steps=500)
    assert len(finished) == len(reqs) and all(r.state == "finished" for r in finished)
    return {r.request_id: list(r.tokens) for r in reqs}


def _generate(model, reqs):
    return {
        r.request_id: gpt.generate(model, torch.tensor([r.prompt]), r.max_new_tokens, cache_len=MAX_LEN)[0].tolist()
        for r in reqs
    }


@pytest.fixture(scope="module")
def jax_slot_tokens(params):
    """One JAX ``SlotEngine`` run, shared by the module."""
    reqs = _copies(_mixed_requests(1), jax_serving)
    return _drive(jax_engine.SlotEngine(_jax_config(), params, n_slots=2, max_len=MAX_LEN), reqs)


# ---- the serving steps against the JAX functions ----------------------------


def _cache(seed, batch, length=MAX_LEN):
    rng = np.random.RandomState(seed)
    return [{n: rng.randn(batch, length, H, D).astype(np.float32) for n in ("k", "v")} for _ in range(2)]


def _torch_cache(cache):
    return [{n: torch.from_numpy(a.copy()) for n, a in layer.items()} for layer in cache]


def _jax_cache(cache):
    return [{n: jnp.asarray(a) for n, a in layer.items()} for layer in cache]


def _assert_caches(got, want):
    for layer, wlayer in zip(got, want):
        for n in ("k", "v"):
            np.testing.assert_allclose(layer[n].numpy(), np.asarray(wlayer[n]), rtol=TOL, atol=TOL)


# positions a row: different depths; the last has rows past the cache (JAX
# clamps the write to the last row and the position table's gather)
SLOT_POS = {"depths": [0, 5, 31, 17], "overrun": [32, 34, 3, 31]}


@pytest.mark.parametrize("case", list(SLOT_POS))
def test_decode_step_slots_matches_jax(params, model, case):
    cache = _cache(2, 4)
    tokens = np.array([3, 60, 7, 21])
    pos = np.array(SLOT_POS[case])
    want, want_cache = jax_gpt.gpt_decode_step_slots(
        _jax_config(), params, _jax_cache(cache), jnp.asarray(tokens, jnp.int32), jnp.asarray(pos, jnp.int32)
    )
    got_cache = _torch_cache(cache)
    got, out_cache = gpt.gpt_decode_step_slots(model, got_cache, torch.from_numpy(tokens), torch.from_numpy(pos))
    assert out_cache is got_cache  # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    _assert_caches(got_cache, want_cache)


def test_decode_step_slots_rows_are_the_scalar_steps(model):
    """Each row of the slot step is ``gpt_decode_step`` at that row's
    position, batch 1."""
    cache = _cache(3, 3)
    tokens, pos = torch.tensor([5, 9, 40]), torch.tensor([4, 0, 30])
    got, _ = gpt.gpt_decode_step_slots(model, _torch_cache(cache), tokens, pos)
    for b in range(3):
        row = [{n: torch.from_numpy(a[b : b + 1].copy()) for n, a in layer.items()} for layer in cache]
        want, _ = gpt.gpt_decode_step(model, row, tokens[b : b + 1], int(pos[b]))
        np.testing.assert_allclose(got[b : b + 1].numpy(), want.numpy(), rtol=TOL, atol=TOL)


N_BLOCKS = 12
TABLES = np.array([[1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 0, 0, 0, 0, 0, 0], [11, 0, 0, 0, 0, 0, 0, 0], [0] * 8])
# row 0 deep in its chain, row 1 past its chain (padding: block 0), row 2
# past the table (block 0), row 3 vacant at 0: no two land on one row of block 0
PAGED_POS = np.array([29, 9, 33, 2])


def test_decode_step_paged_matches_jax(params, model):
    rng = np.random.RandomState(4)
    pool = [{n: rng.randn(N_BLOCKS, BLOCK, H, D).astype(np.float32) for n in ("k", "v")} for _ in range(2)]
    tokens = np.array([1, 2, 3, 4])
    want, want_pool = jax_gpt.gpt_decode_step_paged(
        _jax_config(), params, _jax_cache(pool), jnp.asarray(TABLES, jnp.int32), jnp.asarray(tokens, jnp.int32),
        jnp.asarray(PAGED_POS, jnp.int32),
    )
    got_pool = _torch_cache(pool)
    got, _ = gpt.gpt_decode_step_paged(
        model, got_pool, torch.from_numpy(TABLES), torch.from_numpy(tokens), torch.from_numpy(PAGED_POS)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    _assert_caches(got_pool, want_pool)


def test_paged_step_is_the_slot_step_bit_for_bit(model):
    """The same K/V laid out densely and through block tables: the same
    logits and K/V rows, bit for bit (the same shapes on one device)."""
    dense = _torch_cache(_cache(5, 2))
    tables = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16]])
    pool = []
    for layer in dense:
        pool.append({})
        for n, t in layer.items():
            buf = torch.randn(17, BLOCK, H, D)  # block 0 and the rest: finite garbage
            buf[tables.reshape(-1)] = t.reshape(16, BLOCK, H, D)
            pool[-1][n] = buf
    tokens, pos = torch.tensor([8, 30]), torch.tensor([13, 2])
    want, _ = gpt.gpt_decode_step_slots(model, dense, tokens, pos)
    got, _ = gpt.gpt_decode_step_paged(model, pool, tables, tokens, pos)
    assert torch.equal(got, want)
    for layer, player in zip(dense, pool):
        for n in ("k", "v"):
            assert torch.equal(player[n][tables[0, 13 // BLOCK], 13 % BLOCK], layer[n][0, 13])


def test_prefill_shared_matches_jax_and_the_full_prefill(params, model):
    prefix = _cache(6, 1, length=8)
    suffix = np.array([[4, 8, 15, 16, 23]])
    want, want_cache = jax_gpt.gpt_prefill_shared(
        _jax_config(), params, jnp.asarray(suffix, jnp.int32), _jax_cache(prefix)
    )
    got, got_cache = gpt.gpt_prefill_shared(model, torch.from_numpy(suffix), _torch_cache(prefix))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    _assert_caches(got_cache, want_cache)
    # over a real prefix's K/V it is the full prefill's last logits
    prompt = torch.tensor([[9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]])
    full, cache = gpt.gpt_prefill(model, prompt, MAX_LEN)
    shared, suffix_cache = gpt.gpt_prefill_shared(model, prompt[:, 8:], [{n: t[:, :8] for n, t in l.items()} for l in cache])
    np.testing.assert_allclose(shared.numpy(), full.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(suffix_cache[1]["v"].numpy(), cache[1]["v"][:, 8:11].numpy(), rtol=TOL, atol=TOL)


def test_init_gpt_cache_takes_its_device_explicitly(model):
    with pytest.raises(TypeError):
        gpt.init_gpt_cache(model.config, 1, 4)
    cache = gpt.init_gpt_cache(model.config, 2, 4, device="cpu")
    assert cache[0]["k"].shape == (2, 4, H, D) and not cache[0]["k"].any()


def test_read_slot_is_a_view_and_write_slot_copies(model):
    cache = init_slot_cache(model.config, 3, 8, device="cpu")
    view = read_slot(cache, 1)
    row = [{n: torch.full((1, 8, H, D), 2.0) for n in ("k", "v")} for _ in range(2)]
    write_slot(cache, row, 1)
    assert torch.equal(view[0]["k"], row[0]["k"])  # the view shows the write
    row[0]["k"].zero_()
    assert (cache[0]["k"][1] == 2.0).all() and not cache[0]["k"][0].any()  # the cache holds a copy


# ---- the engines' tokens -------------------------------------------------------


def test_slot_engine_equals_generate_and_the_jax_engine(model, jax_slot_tokens):
    reqs = _mixed_requests(1)
    got = _drive(SlotEngine(model, n_slots=2, max_len=MAX_LEN, device="cpu"), reqs)
    assert got == _generate(model, reqs) == jax_slot_tokens


def test_continuous_batching_beats_padded_static(model):
    budgets = [8, 2, 2, 2]
    cap = _Capture()
    engine = SlotEngine(model, n_slots=2, max_len=MAX_LEN, device="cpu", telemetry=cap, rank=0)
    for i, n in enumerate(budgets):
        engine.submit(Request(request_id=f"r{i}", prompt=[1 + i, 2, 3], max_new_tokens=n))
    assert len(engine.run(max_steps=100)) == 4
    assert padded_static_decode_steps(budgets, batch=2) == 8
    assert engine.decode_steps == 7 and engine.prefills == 4
    assert [e.record()["state"] for e in cap.events] == ["finished"] * 4
    assert engine.stats()["kv_cache_bytes"] == 2 * 2 * 2 * MAX_LEN * H * D * 4


def test_slot_engine_evict_all_emits_and_requeues(model):
    cap = _Capture()
    engine = SlotEngine(model, n_slots=1, max_len=MAX_LEN, device="cpu", telemetry=cap)
    for i in range(2):
        engine.submit(Request(request_id=f"e{i}", prompt=[1, 2], max_new_tokens=6))
    engine.step()  # one admitted and ticked, one queued
    evicted = engine.evict_all(reason="shutdown")
    assert len(evicted) == 2 and engine.idle
    assert {e.record()["state"] for e in cap.events} == {"evicted"}
    assert all(r.reset_for_requeue().requeues == 1 for r in evicted)


def test_paged_engine_equals_the_dense_engine_generate_and_the_jax_engine(params, model):
    reqs = _mixed_requests(2, n=8)
    engine = PagedEngine(model, n_slots=2, max_len=MAX_LEN, block_len=BLOCK, device="cpu")
    got = _drive(engine, reqs)
    dense = _drive(SlotEngine(model, n_slots=2, max_len=MAX_LEN, device="cpu"), _copies(reqs))
    jax_paged = _drive(
        jax_engine.PagedEngine(_jax_config(), params, n_slots=2, max_len=MAX_LEN, block_len=BLOCK),
        _copies(reqs, jax_serving),
    )
    assert got == dense == _generate(model, reqs) == jax_paged
    engine.allocator.check_owners(engine._owner_chains())


@pytest.mark.parametrize("draft", ["self", "adversarial"])
def test_spec_decoding_equals_plain_decoding(params, model, draft):
    reqs = _mixed_requests(3, n=6)
    plain = PagedEngine(model, n_slots=2, max_len=MAX_LEN, block_len=BLOCK, device="cpu")
    want = _drive(plain, _copies(reqs))
    if draft == "self":
        draft_model = model
    else:  # independent weights: proposals near noise
        draft_model = _port_model(
            random_gpt_params(jax_gpt.gpt_tiny(vocab_size=VOCAB, max_position_embeddings=MAX_LEN), MAX_LEN, 7)
        )
    spec = PagedEngine(model, n_slots=2, max_len=MAX_LEN, block_len=BLOCK, draft_model=draft_model, spec_k=4, device="cpu")
    assert _drive(spec, reqs) == want
    rate = spec.stats()["spec_accept_rate"]
    if draft == "self":
        # every proposal the budget lets through is accepted
        rounds = sum(-(-(r.max_new_tokens - 1) // 4) for r in reqs)
        assert spec.spec_accepted == sum(r.max_new_tokens - 1 for r in reqs) - rounds
        assert spec.decode_steps < plain.decode_steps and rate > 0.5
    else:
        assert rate < 0.5


def test_shared_prompt_eight_requests_prefill_once(model):
    prompt = [3, 1, 4, 1, 5, 9]  # not block-aligned: copy-on-write territory
    cap = _Capture()
    engine = PagedEngine(
        model, n_slots=4, max_len=MAX_LEN, block_len=BLOCK, device="cpu", telemetry=cap, emit_pool_every=1
    )
    reqs = [Request(request_id=f"s{i}", prompt=list(prompt), max_new_tokens=5) for i in range(8)]
    for r in reqs:
        engine.submit(r)
    assert len(engine.run(max_steps=200)) == 8
    assert engine.prefills == 1 and engine.prefix_hits == 7
    assert engine.prefill_tokens_saved == 7 * len(prompt)
    assert {r.request_id: r.tokens for r in reqs} == _generate(model, reqs)
    assert engine.cow_copies >= 1
    kv = [e.record() for e in cap.events if e.KIND == "kv_pool"]
    assert kv and kv[-1]["prefix_hits_total"] == 7 and kv[-1]["cow_copies_total"] == engine.cow_copies
    # copy-on-write left the shared blocks' K/V as the first prefill wrote them
    entry = engine.index.lookup(prompt)
    _, fresh = gpt.gpt_prefill(model, torch.tensor([prompt]), MAX_LEN)
    for got, want in zip(read_chain(engine.pool, entry["blocks"], len(prompt)), fresh):
        for n in ("k", "v"):
            assert torch.equal(got[n], want[n][:, : len(prompt)])


def test_shared_prefix_distinct_suffixes_equal_unshared(model):
    """Eight prompts on one 8-token prefix (two blocks) with distinct
    3-token suffixes: one full prefill and seven suffix prefills over the
    linked prefix, the tokens those of the same requests unshared."""
    rng = np.random.RandomState(8)
    prefix = [int(t) for t in rng.randint(0, VOCAB, 8)]
    reqs = [
        Request(request_id=f"p{i}", prompt=prefix + [int(t) for t in rng.randint(0, VOCAB, 3)], max_new_tokens=6)
        for i in range(8)
    ]
    shared = PagedEngine(model, n_slots=4, max_len=MAX_LEN, block_len=BLOCK, device="cpu", check_leaks=True)
    for r in reqs:
        shared.submit(r)
    shared.run(max_steps=200)
    assert shared.prefills == 8 and shared.prefix_hits == 7 and shared.prefill_tokens_saved == 7 * 8
    assert shared.stats()["prefill_tokens"] == 11 + 7 * 3
    plain = PagedEngine(model, n_slots=4, max_len=MAX_LEN, block_len=BLOCK, device="cpu", prefix_sharing=False)
    unshared = _copies(reqs)
    for r in unshared:
        plain.submit(r)
    plain.run(max_steps=200)
    assert {r.request_id: r.tokens for r in reqs} == {r.request_id: r.tokens for r in unshared}
    assert plain.prefix_hits == 0 and plain.cow_copies == 0


def test_eviction_exactly_once_and_leak_assertion(model):
    cap = _Capture()
    engine = PagedEngine(
        model, n_slots=2, max_len=MAX_LEN, block_len=BLOCK, device="cpu", telemetry=cap, check_leaks=True
    )
    for i in range(3):
        engine.submit(Request(request_id=f"e{i}", prompt=[1, 2, i + 1], max_new_tokens=8))
    engine.step()
    assert engine.allocator.n_free < engine.allocator.n_usable
    evicted = engine.evict_all(reason="shutdown")
    assert len(evicted) == 3 and engine.idle
    assert engine.allocator.n_free == engine.allocator.n_usable
    assert engine.evict_all() == []
    assert {e.record()["state"] for e in cap.events if e.KIND == "request"} == {"evicted"}
    # a refcount broken behind the engine's back trips the next tick
    engine.submit(Request(request_id="leak", prompt=[9, 9], max_new_tokens=8))
    engine.step()
    victim = next(s for s in engine.slots if s is not None)
    engine.allocator.release(victim.chain)
    with pytest.raises(BlockLeakError):
        engine.step()


def test_backpressure_defers_fifo_and_drains(model):
    # 4 usable blocks; each request needs 3 (horizon 12 of blocks of 4)
    engine = PagedEngine(
        model, n_slots=2, max_len=MAX_LEN, block_len=BLOCK, n_blocks=5, prefix_sharing=False, device="cpu"
    )
    reqs = [Request(request_id=f"b{i}", prompt=[1 + i, 2, 3], max_new_tokens=9) for i in range(4)]
    for r in reqs:
        engine.submit(r)
    finished = engine.run(max_steps=400)
    assert engine.admissions_deferred > 0 and engine.peak_active == 1
    assert [r.request_id for r in finished] == [r.request_id for r in reqs]
    assert {r.request_id: r.tokens for r in reqs} == _generate(model, reqs)
    assert engine.allocator.n_free == engine.allocator.n_usable


def test_bf16_slot_and_paged_engines_agree(params):
    """In bf16 (weights cast once): the slot and paged engines give the same
    tokens, and the tokens of ``generate``."""
    model = _port_model(params, torch.bfloat16)
    reqs = _mixed_requests(4)
    slot = _drive(SlotEngine(model, n_slots=2, max_len=MAX_LEN, device="cpu"), reqs)
    paged = _drive(PagedEngine(model, n_slots=2, max_len=MAX_LEN, block_len=BLOCK, device="cpu"), _copies(reqs))
    assert slot == paged == _generate(model, reqs)


def test_engines_refuse_a_cache_too_long_or_misaligned(model):
    with pytest.raises(ValueError):
        SlotEngine(model, n_slots=1, max_len=MAX_LEN + 1, device="cpu")
    with pytest.raises(ValueError):
        PagedEngine(model, n_slots=1, max_len=30, block_len=BLOCK, device="cpu")
    with pytest.raises(ValueError):
        PagedEngine(model, n_slots=1, max_len=MAX_LEN, block_len=BLOCK, spec_k=4, device="cpu")


# ---- serve_gpt and the launcher --------------------------------------------------

SERVE_CASES = {
    "slot": {},
    "paged_spec": {"engine": "paged", "spec_k": 4, "block_len": 8},
}


@functools.lru_cache(maxsize=None)
def _serve_runs(case):
    """The port's and the JAX package's ``serve_gpt.run`` on one workload
    (all requests at once, so the schedule is the workload's alone)."""
    kw = dict(preset="small", slots=2, requests=5, request_rate=0.0, max_new_tokens=6, **SERVE_CASES[case])
    return serve_gpt.run(device="cpu", **kw), jax_serve_gpt.run(**kw)


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serve_gpt_counts_equal_the_jax_entry(case):
    got, want = _serve_runs(case)
    assert set(want) <= set(got)
    for key in ("experiment", "mode", "max_len", "engine", "decode_steps", "prefills", "padded_static_decode_steps"):
        assert got[key] == want[key], key
    assert got["live_requests_total"] == want["live_requests_total"] == 5
    for key in ("n_requests", "n_finished", "n_evicted", "total_tokens"):
        assert got["slo"][key] == want["slo"][key], key
    if "kv" in want:
        assert got["kv"] == {**want["kv"], "pool_bytes": got["kv"]["pool_bytes"]}
        assert got["spec"] == want["spec"]
    assert got["decode_steps"] <= got["padded_static_decode_steps"]
    assert got["device"] == "cpu" and got["kv_cache_bytes"] > 0


def test_serve_gpt_from_the_spool(tmp_path):
    spool = str(tmp_path / "spool")
    out = serve_gpt.run(
        preset="small", slots=2, requests=5, request_rate=0.0, max_new_tokens=4, spool_dir=spool, device="cpu"
    )
    assert out["mode"] == "spool" and out["completed"] == 5 and out["requeued_orphans"] == 0
    assert out["rank"] == 0 and out["incarnation"] == 0
    assert len(FileSpool(spool).done_ids()) == 5 and FileSpool(spool).drained()
    assert out["slo"]["n_finished"] == 5 == out["live_requests_total"]


def test_launch_serve_gpt_on_the_cpu(capsys):
    out = launch.main(
        ["serve_gpt", "--device", "cpu", "--slots", "2", "--requests", "4", "--request-rate", "0",
         "--max-new-tokens", "5", "--engine", "paged", "--block-len", "8", "--spec-k", "2", "--no-prefix-sharing",
         "--n-blocks", "9", "--max-wall-s", "60", "--json"]
    )
    assert out["engine"] == "paged" and out["slo"]["n_finished"] == 4 and out["kv"]["n_blocks"] == 9
    assert out["kv"]["prefix_hits_total"] == 0 and out["spec"]["spec_k"] == 2
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"experiment": "serve_gpt"')


@pytest.mark.parametrize(
    "args",
    [
        ["gpt_generate", "--slots", "2"],
        ["gpt_lm", "--spool-dir", "x"],
        ["exact_cifar10", "--engine", "paged"],
        ["powersgd_imdb", "--spec-k", "4"],
        ["bare_init", "--no-prefix-sharing"],
        ["diloco_cifar10", "--block-len", "8"],
        ["gpt_generate", "--max-wall-s", "5"],
        ["bandwidth_study", "--n-blocks", "9"],
        ["imdb_baseline", "--requests", "3"],
        ["powersgd_cifar10", "--request-rate", "1"],
        ["gpt_lm", "--checkpoint-dir", "x"],
        ["powersgd_cifar10", "--checkpoint-dir", "x"],
        ["diloco_cifar10", "--checkpoint-dir", "x"],
        ["gpt_generate", "--checkpoint-dir", "x"],
        ["serve_gpt", "--temperature", "1.0"],
    ],
)
def test_launch_refuses_serve_flags_elsewhere(args):
    with pytest.raises(ValueError, match=args[1]):
        launch.main([*args, "--device", "cpu"])


def test_checkpoint_dir_is_not_ported(tmp_path):
    """``checkpoint_dir`` hot-loads: ``serve_gpt.run`` and the launcher
    serve the parameters of the newest committed checkpoint there, other
    weights than the seed's, and report its step."""
    max_len = serve_gpt.serving_max_len("small", 16, "slot", 16)
    trained = serve_gpt.build_model("small", max_len, torch.float32, "cpu", seed=1)
    save_checkpoint(str(tmp_path), serving_state_template(dict(trained.named_parameters())), step=3)
    kw = dict(preset="small", device="cpu", requests=4, request_rate=0.0, max_new_tokens=16)
    loaded, fresh = serve_gpt.serve(checkpoint_dir=str(tmp_path), **kw), serve_gpt.serve(**kw)
    assert loaded[0]["checkpoint_step"] == 3 and fresh[0]["checkpoint_step"] is None
    assert [r.tokens for r in loaded[1]] != [r.tokens for r in fresh[1]]
    out = launch.main(
        ["serve_gpt", "--device", "cpu", "--requests", "2", "--request-rate", "0", "--max-new-tokens", "16",
         "--checkpoint-dir", str(tmp_path)]
    )
    assert out["checkpoint_step"] == 3 and out["slo"]["n_finished"] == 2


def test_serve_gpt_raises_without_a_card_unless_cpu(model):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_gpt.run(preset="small", requests=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlotEngine(model, n_slots=1, max_len=MAX_LEN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedEngine(model, n_slots=1, max_len=MAX_LEN, block_len=BLOCK)


def test_serve_gpt_summary_keys_are_the_jax_entrys():
    """The port's summary holds every key of the JAX entry's, and adds
    ``compute_dtype`` and ``kv_cache_bytes`` only."""
    for case in SERVE_CASES:
        got, want = _serve_runs(case)
        assert set(got) - set(want) == {"compute_dtype", "kv_cache_bytes"}
        assert set(got["slo"]) == set(want["slo"])
    assert dataclasses.asdict(serve_gpt.workload_config("full", 2, 0.0, 64, 714)) == dataclasses.asdict(
        jax_serving.WorkloadConfig(n_requests=2, rate_rps=0.0, prompt_len=(8, 32), max_new_tokens=(2, 64), vocab=1024)
    )
    assert serve_gpt.serving_max_len("full", 64, "slot", 16) == serve_gpt.serving_max_len("full", 64, "paged", 16) == 96
