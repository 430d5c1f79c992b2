"""Continuous-batching GPT serving, the JAX package's
``experiments/serve_gpt.py``: a GPT decoder from the seed, a deterministic
Poisson workload, and the ``serving/`` engines.

``engine="slot"`` serves through ``serving.engine.SlotEngine`` (a dense
slot cache, one decode step a tick); ``engine="paged"`` through
``serving.engine.PagedEngine`` (a block pool, copy-on-write prefix sharing
unless ``prefix_sharing=False``, speculative decoding with ``spec_k >=
2``, drafted by the target itself: a draft from the seed alone would
propose noise, and the accept rule is what runs; a real deployment gives
it a distilled small model).

Presets, as in the reference: ``small`` is ``gpt_tiny`` at vocabulary 64
with prompts of 4 to 12 tokens, ``full`` is GPT-2 small (12 layers, width
768, 12 heads) at vocabulary 1024 with prompts of 8 to 32. Each request
decodes 2 to ``max_new_tokens`` tokens; ``max_len`` is the longest prompt
plus ``max_new_tokens`` (a whole number of blocks for the paged engine),
and every admission prefills at it, so the tokens can be held to a
sequential ``generate(cache_len=max_len)``.

Two modes: in process (the default), an open-loop wall-clock replay of
the workload (``serving.frontend.replay``); and the spool
(``spool_dir``), where every rank enqueues the same workload into a shared
``FileSpool`` and runs the claim, step and complete loop
(``serve_from_spool``). Ranks share only the spool: no process group.

``checkpoint_dir`` hot-loads the parameters of the newest committed
training checkpoint there (``serving.cache.restore_serving_params``, any
training world), and the summary's ``checkpoint_step`` names its step;
with nothing restorable the fresh parameters serve, and a
:class:`..observe.NoteEvent` says so on standard error. The checkpoint must
come from a model of the serving shape: the position table has
``max_len`` rows.

The run's events (each request's ``RequestEvent``, the paged engine's
``KVPoolEvent``s, the checkpoint notes) go through the registry of
``telemetry_from_config`` (``event_log``). The summary holds the JAX
run's keys (``device`` is the card's name), and ``compute_dtype`` and
``kv_cache_bytes``. ``live_requests_total`` counts the terminal request
events in state ``finished`` through one more sink of the registry; the
reference's metric registry is not ported yet (ROADMAP.md §A item 5).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..models.gpt import GPTLM, gpt_small, gpt_tiny
from ..observe.events import NoteEvent, RequestEvent
from ..observe.sinks import Sink
from ..observe.telemetry import telemetry_from_config
from ..parallel.mesh import resolve_device
from ..resilience import incarnation_from_env
from ..serving import FileSpool, Request, WorkloadConfig, poisson_workload, replay, serve_from_spool, slo_summary
from ..serving.cache import restore_serving_params
from ..serving.engine import PagedEngine, SlotEngine, padded_static_decode_steps
from ..utils.config import ExperimentConfig
from .common import compute_dtype

# preset -> (model, vocabulary, prompt lengths)
PRESETS = {"small": (gpt_tiny, 64, (4, 12)), "full": (gpt_small, 1024, (8, 32))}
ENGINES = ("slot", "paged")
SPEC_KEYS = ("spec_k", "spec_rounds", "spec_proposed", "spec_accepted", "spec_accept_rate")


def default_config() -> ExperimentConfig:
    return ExperimentConfig()


def workload_config(preset: str, requests: int, request_rate: float, max_new_tokens: int, seed: int) -> WorkloadConfig:
    _, vocab, prompt_len = PRESETS[preset]
    return WorkloadConfig(
        n_requests=requests, rate_rps=request_rate, prompt_len=prompt_len,
        max_new_tokens=(2, max_new_tokens), vocab=vocab, seed=seed,
    )


def serving_max_len(preset: str, max_new_tokens: int, engine: str, block_len: int) -> int:
    """The cache capacity: the longest request; a whole number of blocks
    for the paged engine."""
    max_len = PRESETS[preset][2][1] + max_new_tokens
    if engine == "paged":
        max_len = -(-max_len // block_len) * block_len
    return max_len


def build_model(preset: str, max_len: int, dtype=torch.float32, device="cuda", seed: int = 0) -> GPTLM:
    make, vocab, _ = PRESETS[preset]
    return make(dtype=dtype, device=device, seed=seed, vocab_size=vocab, max_position_embeddings=max_len).eval()


class _FinishedCount(Sink):
    """A sink of the run's registry: counts the terminal request events in
    state ``finished``."""

    def __init__(self):
        self.count = 0

    def emit(self, event, record=None) -> None:
        if isinstance(event, RequestEvent) and event.state == "finished":
            self.count += 1


def serve(
    config: Optional[ExperimentConfig] = None,
    preset: str = "small",
    slots: int = 4,
    requests: int = 16,
    request_rate: float = 64.0,
    max_new_tokens: int = 16,
    checkpoint_dir: Optional[str] = None,
    spool_dir: Optional[str] = None,
    max_wall_s: float = 120.0,
    engine: str = "slot",
    block_len: int = 16,
    n_blocks: Optional[int] = None,
    prefix_sharing: bool = True,
    spec_k: int = 0,
    device="cuda",
) -> Tuple[Dict, List[Request]]:
    """:func:`run`'s summary and the requests this process finished."""
    config = config or default_config()
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}")
    if engine not in ENGINES:
        raise ValueError(f"engine must be 'slot' or 'paged', got {engine!r}")
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    if requests < 1:
        raise ValueError(f"requests must be >= 1, got {requests}")
    if max_new_tokens < 2:
        raise ValueError(f"max_new_tokens must be >= 2 for serving, got {max_new_tokens}")
    device = resolve_device(device)
    workload = workload_config(preset, requests, request_rate, max_new_tokens, config.seed)
    max_len = serving_max_len(preset, max_new_tokens, engine, block_len)
    model = build_model(preset, max_len, compute_dtype(config), device, config.seed)
    telemetry = telemetry_from_config(config)
    sink = telemetry.add_sink(_FinishedCount())
    try:
        ckpt_step = None
        if checkpoint_dir is not None:
            restored = restore_serving_params(
                checkpoint_dir, dict(model.named_parameters()), telemetry=telemetry, label="serve_gpt"
            )
            if restored is None:
                telemetry.emit(NoteEvent(
                    f"serve_gpt: no restorable checkpoint under {checkpoint_dir}; serving fresh params"
                ))
            else:
                ckpt_step = restored[1]

        common = dict(device=device, telemetry=telemetry, rank=config.process_id, label="serve_gpt")
        if engine == "paged":
            eng = PagedEngine(
                model, n_slots=slots, max_len=max_len, block_len=block_len, n_blocks=n_blocks,
                prefix_sharing=prefix_sharing, draft_model=model if spec_k >= 2 else None, spec_k=spec_k, **common,
            )
        else:
            eng = SlotEngine(model, n_slots=slots, max_len=max_len, **common)

        if spool_dir is not None:
            # every rank (and every restart) enqueues the same deterministic
            # workload; ensure() is idempotent, so exactly one copy lands
            spool = FileSpool(spool_dir, rank=config.process_id, incarnation=incarnation_from_env())
            spool.ensure(poisson_workload(workload))
            served = serve_from_spool(eng, spool, world=config.num_processes, max_wall_s=max_wall_s)
            finished = served.pop("requests")
            mode: Dict = {"mode": "spool", **served}
        else:
            finished = replay(eng, poisson_workload(workload), max_wall_s=max_wall_s)
            mode = {"mode": "in_process"}
    finally:
        telemetry.close()

    # ticks spent against what padded static batching would spend on the
    # same workload (decode lengths in arrival order: ids sort by arrival)
    decode_lengths = [len(r.tokens) for r in sorted(finished, key=lambda r: r.request_id)]
    summary = {
        "experiment": "serve_gpt",
        "preset": preset,
        "slots": slots,
        "requests": requests,
        "request_rate": request_rate,
        "max_len": max_len,
        "checkpoint_step": ckpt_step,
        "engine": engine,
        "compute_dtype": config.compute_dtype,
        "decode_steps": eng.decode_steps,
        "prefills": eng.prefills,
        "padded_static_decode_steps": padded_static_decode_steps(decode_lengths, slots),
        "slo": slo_summary(finished),
        "live_requests_total": sink.count,
        "kv_cache_bytes": eng.cache_bytes,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        **mode,
    }
    if engine == "paged":
        summary["kv"] = eng.kv_stats()
        if spec_k >= 2:
            stats = eng.stats()
            summary["spec"] = {k: stats[k] for k in SPEC_KEYS}
    return summary, finished


def run(config: Optional[ExperimentConfig] = None, **kwargs) -> Dict:
    """Serve the workload and return the summary (keyword arguments as
    :func:`serve`'s)."""
    return serve(config, **kwargs)[0]
