"""Per-phase wall-clock times, port of ``refil_tpu/utils/profiling.py``
(``PhaseTimer``; its ``device_trace`` calls ``jax.profiler`` and is left out).
The classic loop times its ``rollout`` and ``train`` phases with ``phase``;
the fused loop notes each dispatch's per-block time with ``note``. Both log
the EMAs as ``time_<phase>_ms`` on the learner cadence."""
from __future__ import annotations

import contextlib
import time
from typing import Dict


class PhaseTimer:
    """Wall-clock phase times, kept as an EMA per phase;
    ``with timer.phase("rollout"): ...``"""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.note(name, time.perf_counter() - t0)

    def note(self, name: str, dt: float) -> None:
        """Record an externally measured duration (e.g. a multi-block
        dispatch normalized to per-block time)."""
        if name in self.avg:
            self.avg[name] = self.ema * self.avg[name] + (1 - self.ema) * dt
        else:
            self.avg[name] = dt

    def stats(self) -> Dict[str, float]:
        return {f"time_{k}_ms": v * 1000.0 for k, v in self.avg.items()}
