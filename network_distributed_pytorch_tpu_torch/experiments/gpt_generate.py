"""Autoregressive decoding of the GPT decoder, the JAX package's
``experiments/gpt_generate.py``: one batched prefill of the prompt, then
``max_new_tokens - 1`` single-token KV-cache decode steps
(``models.gpt.generate``), greedy by default, ``temperature > 0`` samples
with an explicit ``torch.Generator``.

It reports the JAX run's keys: the end-to-end ``generate_tokens_per_sec``,
and ``prefill_ms`` and ``decode_ms_per_token`` timed apart (a prefill call,
then a decode call of ``models.gpt.decode_tokens`` from its cache), each the
mean of ``reps`` calls after a warm-up call; on the card by CUDA events,
on the CPU by the host clock. Preset ``full`` is GPT-2 small (vocabulary
1024 unless ``vocab`` is given; GPT-2's own is 50257), ``small`` is
``gpt_tiny`` (vocabulary 64); ``max_position_embeddings`` is
``prompt_len + max_new_tokens``. Weights come from the seed (or
``pretrained_state_dict``), the prompt from a generator seeded with
``seed + 1`` (or ``prompt``), the samples from one seeded with ``seed + 2``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from ..models.gpt import decode_tokens, generate, gpt_prefill, gpt_small, gpt_tiny
from ..parallel.mesh import resolve_device
from ..utils.config import ExperimentConfig
from .common import compute_dtype


def default_config() -> ExperimentConfig:
    return ExperimentConfig()


def build_model(preset: str, total_len: int, vocab: Optional[int] = None, dtype=torch.float32, device="cuda", seed=0):
    if preset not in ("small", "full"):
        raise ValueError(f"unknown preset {preset!r}")
    if vocab is None:
        vocab = 64 if preset == "small" else 1024
    make = gpt_tiny if preset == "small" else gpt_small
    return make(dtype=dtype, device=device, seed=seed, vocab_size=vocab, max_position_embeddings=total_len)


def timed_s(fn: Callable[[], object], device: torch.device, reps: int) -> float:
    """Mean seconds of ``fn()`` over ``reps`` calls after one warm-up call:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def run(
    config: Optional[ExperimentConfig] = None,
    preset: str = "small",
    batch: int = 8,
    prompt_len: int = 16,
    max_new_tokens: int = 64,
    temperature: float = 0.0,
    vocab: Optional[int] = None,
    device="cuda",
    pretrained_state_dict=None,
    prompt: Optional[torch.Tensor] = None,
    reps: int = 3,
) -> Dict:
    config = config or default_config()
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    device = resolve_device(device)
    total = prompt_len + max_new_tokens
    model = build_model(preset, total, vocab, compute_dtype(config), device, seed=config.seed)
    if pretrained_state_dict is not None:
        model.load_state_dict(pretrained_state_dict)
    model.eval()
    vocab = model.config.vocab_size
    if prompt is None:
        gen = torch.Generator().manual_seed(config.seed + 1)
        prompt = torch.randint(0, vocab, (batch, prompt_len), generator=gen)
    if tuple(prompt.shape) != (batch, prompt_len):
        raise ValueError(f"prompt {tuple(prompt.shape)}, want ({batch}, {prompt_len})")
    prompt = prompt.to(device=device, dtype=torch.long)

    def sampler(seed):
        return None if temperature == 0.0 else torch.Generator(device).manual_seed(seed)

    out = generate(model, prompt, max_new_tokens, temperature=temperature, generator=sampler(config.seed + 2))
    assert out.shape == (batch, max_new_tokens), out.shape
    gen_s = timed_s(
        lambda: generate(model, prompt, max_new_tokens, temperature=temperature, generator=sampler(config.seed + 2)),
        device, reps,
    )
    # prefill and the decode steps as separate calls, not one minus the other
    prefill_s = timed_s(lambda: gpt_prefill(model, prompt, total), device, reps)
    last_logits, cache = gpt_prefill(model, prompt, total)
    n_decode = max_new_tokens - 1  # generate(): prefill gives token 1
    if n_decode > 0:
        first = last_logits.argmax(dim=-1)
        decode_s = timed_s(
            lambda: decode_tokens(
                model, cache, first, prompt_len, n_decode, temperature=temperature, generator=sampler(config.seed + 3)
            ),
            device, reps,
        )
        decode_ms_per_token = 1e3 * decode_s / n_decode
    else:
        decode_ms_per_token = None  # a 1-token generation has no decode step
    return {
        "experiment": "gpt_generate",
        "preset": preset,
        "batch": batch,
        "prompt_len": prompt_len,
        "max_new_tokens": max_new_tokens,
        "temperature": temperature,
        "vocab": vocab,
        "compute_dtype": config.compute_dtype,
        "generate_tokens_per_sec": batch * max_new_tokens / gen_s,
        "prefill_ms": 1e3 * prefill_s,
        "decode_ms_per_token": decode_ms_per_token,
        "decode_time_unreliable": n_decode == 0,
        "sample_head": [int(t) for t in out[0, :8]],
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
