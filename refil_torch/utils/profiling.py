"""Per-phase wall-clock times, port of ``refil_tpu/utils/profiling.py``
(``PhaseTimer``; its ``device_trace`` calls ``jax.profiler`` and is left out).
The fused loop notes each dispatch's per-block time here and logs the EMAs
as ``time_<phase>_ms``."""
from __future__ import annotations

from typing import Dict


class PhaseTimer:
    """Wall-clock phase times, kept as an EMA per phase."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Dict[str, float] = {}

    def note(self, name: str, dt: float) -> None:
        """Record an externally measured duration (e.g. a multi-block
        dispatch normalized to per-block time)."""
        if name in self.avg:
            self.avg[name] = self.ema * self.avg[name] + (1 - self.ema) * dt
        else:
            self.avg[name] = dt

    def stats(self) -> Dict[str, float]:
        return {f"time_{k}_ms": v * 1000.0 for k, v in self.avg.items()}
