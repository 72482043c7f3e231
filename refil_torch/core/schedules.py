"""Exploration schedules, port of ``refil_tpu/core/schedules.py``."""
from __future__ import annotations

import dataclasses
import math

import torch


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

    def eval(self, t: torch.Tensor) -> torch.Tensor:
        """The schedule at a 0-d float32 tensor ``t``, computed on ``t``'s
        device in float32 (no host sync), as the JAX package's ``eval`` on a
        traced ``t``. The fused pipeline takes epsilon from its device
        ``t_env`` with it."""
        if self.decay == "linear":
            return torch.clamp_min(self.start - self.delta * t, self.finish)
        if self.decay == "exp":
            return torch.clamp(torch.exp(-t / self.exp_scaling), self.finish, self.start)
        raise ValueError(f"Unknown decay {self.decay}")

    def eval_host(self, t: float) -> float:
        """The schedule in Python floats, for the host loop."""
        if self.decay == "linear":
            return max(self.finish, self.start - self.delta * t)
        if self.decay == "exp":
            return min(self.start, max(self.finish, math.exp(-t / self.exp_scaling)))
        raise ValueError(f"Unknown decay {self.decay}")
