"""Metrics: per-step loss, step time and bits on the wire, per step and per
epoch (the reference accumulated ``bits_communicated`` and never reported
it). Banners go through ``logging``."""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_log = logging.getLogger(__name__)


@dataclass
class StepRecord:
    step: int
    epoch: int
    loss: float
    step_time_s: float  # host clock, from before the step to its loss on the host
    bits_cumulative: int
    device_time_ms: Optional[float] = None  # CUDA events around the step, where measured


@dataclass
class MetricsLogger:
    bits_per_step: int = 0
    log_every: int = 0  # 0 = silent per step
    records: List[StepRecord] = field(default_factory=list)
    _epoch_losses: List[float] = field(default_factory=list)
    _step: int = 0
    _bits: int = 0
    _t_last: Optional[float] = None

    def start_step(self) -> None:
        self._t_last = time.perf_counter()

    def end_step(self, epoch: int, loss: float, device_time_ms: Optional[float] = None) -> StepRecord:
        if self._t_last is None:
            raise RuntimeError("end_step without start_step")
        dt = time.perf_counter() - self._t_last
        self._t_last = None
        self._bits += self.bits_per_step
        rec = StepRecord(self._step, epoch, float(loss), dt, self._bits, device_time_ms)
        self.records.append(rec)
        self._epoch_losses.append(float(loss))
        self._step += 1
        if self.log_every and self._step % self.log_every == 0:
            _log.info(
                "step %d epoch %d loss %.6f step_time %.4fs bits %d",
                rec.step, epoch, rec.loss, dt, rec.bits_cumulative,
            )
        return rec

    def end_epoch(self, epoch: int, rank: int = 0) -> float:
        """Per-epoch mean loss, with the bits sent so far."""
        mean = sum(self._epoch_losses) / max(len(self._epoch_losses), 1)
        _log.info("rank %d epoch %d mean loss %.6f bits %d", rank, epoch, mean, self._bits)
        self._epoch_losses = []
        return mean

    def summary(self) -> Dict:
        # steady state: drop the first (warm-up) step
        times = [r.step_time_s for r in self.records[1:]]
        return {
            "steps": len(self.records),
            "first_loss": self.records[0].loss if self.records else None,
            "final_loss": self.records[-1].loss if self.records else None,
            "mean_step_time_s": sum(times) / len(times) if times else None,
            "bits_communicated": self._bits,
            "bytes_communicated": self._bits // 8,
        }
