"""The port's CUDA preflight (``hostenv.backend_preflight``) against the
JAX package's ``hostenv.backend_preflight``: the same verdict keys, a hung
probe reported as ``init_timeout`` within one deadline (not ``attempts``
of them unless asked), a raised error retried with backoff, the verdict
cached once a process and ``force=True`` probing again. The port's probe
asks for the CUDA device count and the first card's name."""

import threading
import time

import pytest

import network_distributed_pytorch_tpu.hostenv as jax_hostenv
from network_distributed_pytorch_tpu_torch import hostenv

KEYS = {"ok", "platform", "n_devices", "cause", "attempts", "elapsed_s"}


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.setattr(hostenv, "_PREFLIGHT", None)
    monkeypatch.setattr(jax_hostenv, "_PREFLIGHT", None)


def test_the_verdict_has_the_jax_packages_keys():
    verdict = hostenv.backend_preflight(timeout_s=30.0, attempts=1)
    jverdict = jax_hostenv.backend_preflight(timeout_s=30.0, attempts=1)
    assert set(verdict) == set(jverdict) == KEYS
    assert jverdict["ok"] and jverdict["platform"] == "cpu"


def test_without_a_card_the_verdict_names_the_cause():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    verdict = hostenv.backend_preflight(timeout_s=30.0, attempts=1)
    assert not verdict["ok"] and verdict["cause"].startswith("RuntimeError: no CUDA device")
    assert verdict["platform"] is None and verdict["n_devices"] is None and verdict["attempts"] == 1


@pytest.mark.parametrize("retry_on_timeout,attempts", [(False, 1), (True, 2)])
def test_a_hung_probe_is_an_init_timeout_within_its_deadline(monkeypatch, retry_on_timeout, attempts):
    release = threading.Event()
    monkeypatch.setattr(hostenv, "_probe", lambda: release.wait(30) and ("gpu", 1))
    t0 = time.monotonic()
    try:
        verdict = hostenv.backend_preflight(
            timeout_s=0.2, attempts=2, backoff_s=0.01, retry_on_timeout=retry_on_timeout
        )
    finally:
        release.set()
    assert time.monotonic() - t0 < 0.2 * attempts + 1.0
    assert not verdict["ok"] and verdict["attempts"] == attempts
    assert verdict["cause"].startswith("init_timeout: torch.cuda.device_count() still hung after 0s")
    assert verdict["cause"].endswith(f"(attempt {attempts}/2)")


def test_a_raised_error_is_retried_with_backoff_then_the_probe_succeeds(monkeypatch):
    calls = []

    def probe():
        calls.append(time.monotonic())
        if len(calls) < 3:
            raise OSError("driver busy")
        return "gpu", 4

    monkeypatch.setattr(hostenv, "_probe", probe)
    verdict = hostenv.backend_preflight(timeout_s=5.0, attempts=3, backoff_s=0.05)
    assert verdict == {**verdict, "ok": True, "platform": "gpu", "n_devices": 4, "cause": None, "attempts": 3}
    assert calls[1] - calls[0] >= 0.05 and calls[2] - calls[1] >= 0.1  # 0.05 x 2 ** attempt


def test_the_last_error_is_the_cause_when_every_attempt_fails(monkeypatch):
    monkeypatch.setattr(hostenv, "_probe", lambda: (_ for _ in ()).throw(OSError("gone")))
    verdict = hostenv.backend_preflight(timeout_s=5.0, attempts=2, backoff_s=0.0)
    assert (verdict["ok"], verdict["attempts"], verdict["cause"]) == (False, 2, "OSError: gone")


def test_the_verdict_is_cached_and_force_probes_again(monkeypatch):
    calls = []
    monkeypatch.setattr(hostenv, "_probe", lambda: calls.append(1) or ("gpu", 1))
    first = hostenv.backend_preflight()
    assert hostenv.backend_preflight() is first and len(calls) == 1
    again = hostenv.backend_preflight(force=True)
    assert again is not first and len(calls) == 2 and again["ok"]
