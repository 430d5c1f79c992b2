"""Metrics: per-step loss, step time and bits on the wire, the JAX
package's ``utils/metrics.py`` for the port. Every step emits a
``StepEvent`` and every epoch the reference's mean-loss banner as an
``EpochEvent``, through the run's telemetry (by default the process's
banner-only registry): the banners and the JSONL run log are two sinks of
the same events. The reference accumulated ``bits_communicated`` and never
reported it; here it is counted exactly, on the host."""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..observe.events import EpochEvent, StepEvent
from ..observe.telemetry import Telemetry, default_telemetry


@dataclass
class StepRecord:
    step: int
    epoch: int
    loss: float
    step_time_s: float  # host clock, from before the step to its loss on the host
    bits_cumulative: int
    # False: end_step without a start_step, so there is no timing origin and
    # step_time_s means nothing; kept so that percentiles can leave it out
    valid: bool = True
    device_time_ms: Optional[float] = None  # CUDA events around the step, where measured


@dataclass
class MetricsLogger:
    """Host-side accumulator. Bits a step are static, so the Python-int
    tally is exact. Events go through ``telemetry`` (by default the
    process's banner registry)."""

    bits_per_step: int = 0
    log_every: int = 0  # 0: no step banner
    records: List[StepRecord] = field(default_factory=list)
    telemetry: Optional[Telemetry] = None
    _epoch_losses: List[float] = field(default_factory=list)
    _step: int = 0
    _bits: int = 0
    _t_last: Optional[float] = None

    def _telemetry(self) -> Telemetry:
        return self.telemetry if self.telemetry is not None else default_telemetry()

    def start_step(self) -> None:
        self._t_last = time.perf_counter()

    def end_step(self, epoch: int, loss: float, device_time_ms: Optional[float] = None) -> StepRecord:
        if self._t_last is None:
            valid, dt = False, 0.0
        else:
            valid, dt = True, time.perf_counter() - self._t_last
        # one timing origin a step: a second end_step must not reuse it
        self._t_last = None
        self._bits += self.bits_per_step
        rec = StepRecord(self._step, epoch, float(loss), dt, self._bits, valid, device_time_ms)
        self.records.append(rec)
        self._epoch_losses.append(float(loss))
        self._step += 1
        self._telemetry().emit(
            StepEvent(
                step=rec.step,
                epoch=rec.epoch,
                loss=rec.loss,
                step_time_s=rec.step_time_s,
                bits_cumulative=rec.bits_cumulative,
                valid=rec.valid,
                verbose=bool(self.log_every) and self._step % self.log_every == 0,
            )
        )
        return rec

    def end_epoch(self, epoch: int, rank: int = 0) -> float:
        """The epoch's mean loss, emitted in the reference's banner style."""
        mean = sum(self._epoch_losses) / max(len(self._epoch_losses), 1)
        self._telemetry().emit(EpochEvent(epoch=epoch, rank=rank, mean_loss=mean, bits_cumulative=self._bits))
        self._epoch_losses = []
        return mean

    @property
    def bits_communicated(self) -> int:
        return self._bits

    def summary(self) -> Dict:
        # steady state: leave out the first (warm-up) step and untimed records
        times = [r.step_time_s for r in self.records[1:] if r.valid]
        return {
            "steps": len(self.records),
            "first_loss": self.records[0].loss if self.records else None,
            "final_loss": self.records[-1].loss if self.records else None,
            "mean_step_time_s": sum(times) / len(times) if times else None,
            "bits_communicated": self._bits,
            "bytes_communicated": self._bits // 8,
        }

    def dump_jsonl(self, path: str, append: bool = False) -> None:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "a" if append else "w") as f:
            for r in self.records:
                f.write(json.dumps(r.__dict__) + "\n")
