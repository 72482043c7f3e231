"""Exploration schedules, port of ``refil_tpu/core/schedules.py``."""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class DecayThenFlatSchedule:
    """Linear (or exponential) decay from ``start`` to ``finish`` over
    ``time_length`` steps, then flat."""

    start: float
    finish: float
    time_length: int
    decay: str = "linear"

    @property
    def delta(self) -> float:
        return (self.start - self.finish) / self.time_length

    @property
    def exp_scaling(self) -> float:
        if self.finish > 0:
            return -1.0 * self.time_length / math.log(self.finish)
        return 1.0

    def eval(self, t: float) -> float:
        if self.decay == "linear":
            return max(self.finish, self.start - self.delta * t)
        if self.decay == "exp":
            return min(self.start, max(self.finish, math.exp(-t / self.exp_scaling)))
        raise ValueError(f"Unknown decay {self.decay}")
