"""Per-phase wall-clock times and spans, port of ``refil_tpu/utils/profiling.py``
(``PhaseTimer``; its ``device_trace`` calls ``jax.profiler`` and is left out).

``PhaseTimer`` is the run's one timing system. It records:

* spans: a name, a start and an end on the host clock ``CLOCK_NS`` (unix
  nanoseconds, the clock ``torch.profiler`` stamps its events in, so a
  profile and the spans share one timeline), and the id of the span open
  around it (``with timer.span("name"):``);
* the fused pipeline's per-block records: the dispatch, the kind of block,
  whether it was a graph replay, the host time of its launch, and the
  device stamps at its stage boundaries (``core/pipeline.py``);
* anchors of the device's stamp clock on the host clock (``anchor``): a
  stamp between two host reads around a synchronisation, at set-up and
  after each dispatch. The two clocks drift apart by a few parts per
  million, so a stamp is converted by the offset interpolated between the
  anchors around it;
* EMAs per phase, logged as ``time_<phase>_ms`` on the learner cadence: the
  classic loop times its ``rollout`` and ``train`` phases with ``phase``,
  the fused loop notes each dispatch's per-block time with ``note``.

Everything is kept in memory, nothing is written: the last ``span_cap``
spans and ``block_cap`` block records, and running totals over the whole
run by span name and by kind of block. ``snapshot`` copies them out, with
the block times on the host clock and the device idle between blocks put
down to the innermost host span open at each gap's midpoint.

Code below the training loop (``run.build_training``, the kernel libraries'
first load) records into the recorder that ``recording`` installs, through
the module's ``span``; outside one it records nothing.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import itertools
import statistics
import time
from typing import Any, Dict, List, Optional, Sequence

CLOCK_NS = time.time_ns  # torch.profiler's events: unix ns (kineto's clock)
SPAN_CAP = 1 << 16
BLOCK_CAP = 4096


@dataclasses.dataclass
class Span:
    id: int
    name: str
    parent: Optional[int]
    start_ns: int
    end_ns: int = 0  # 0 while open

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclasses.dataclass
class BlockRecord:
    dispatch: int  # index of the ``run_blocks`` call that ran it
    kind: str  # "warm" or "train"
    replay: bool  # a graph replay (else run eagerly)
    launch_ns: Optional[int]  # host ns inside ``graph.replay()``; None for an eager block
    stamps: Optional[Sequence[int]]  # device ns at each boundary (None: stamps off)
    names: Sequence[str]  # each boundary's name; the first is the block's start


class PhaseTimer:
    """Spans, block records and phase EMAs of one run; ``with
    timer.phase("rollout"): ...`` records a span and feeds its EMA."""

    def __init__(self, ema: float = 0.9, span_cap: int = SPAN_CAP, block_cap: int = BLOCK_CAP):
        self.ema = ema
        self.avg: Dict[str, float] = {}
        self.spans: collections.deque = collections.deque(maxlen=span_cap)
        self.blocks: collections.deque = collections.deque(maxlen=block_cap)
        self.totals: Dict[str, List[int]] = {}  # span name -> [count, ns]
        self.block_totals: Dict[str, Dict[str, int]] = {}  # kind -> {"blocks", stage: ns}
        # (device ns, host ns), in device order, and each one's uncertainty
        self.anchors: collections.deque = collections.deque(maxlen=block_cap)
        self.uncertainties_ns: collections.deque = collections.deque(maxlen=block_cap)
        self._open: List[int] = []
        self._ids = itertools.count()

    # ------------------------------------------------------------------ spans
    @contextlib.contextmanager
    def span(self, name: str):
        s = Span(next(self._ids), name, self._open[-1] if self._open else None, CLOCK_NS())
        self._open.append(s.id)
        try:
            yield s
        finally:
            s.end_ns = CLOCK_NS()
            self._open.pop()
            self.spans.append(s)
            total = self.totals.setdefault(name, [0, 0])
            total[0] += 1
            total[1] += s.end_ns - s.start_ns

    @contextlib.contextmanager
    def phase(self, name: str):
        with self.span(name) as s:
            yield s
        self.note(name, s.seconds)

    def note(self, name: str, dt: float) -> None:
        """Record an externally measured duration (e.g. a multi-block
        dispatch normalized to per-block time)."""
        if name in self.avg:
            self.avg[name] = self.ema * self.avg[name] + (1 - self.ema) * dt
        else:
            self.avg[name] = dt

    def stats(self) -> Dict[str, float]:
        return {f"time_{k}_ms": v * 1000.0 for k, v in self.avg.items()}

    # ------------------------------------------------------------------ blocks
    def record_block(self, rec: BlockRecord) -> None:
        self.blocks.append(rec)
        total = self.block_totals.setdefault(rec.kind, {"blocks": 0})
        total["blocks"] += 1
        if rec.stamps is not None:
            for name, ns in _stages(rec).items():
                total[name] = total.get(name, 0) + ns

    def anchor(self, device_ns: int, host_ns: int, uncertainty_ns: int) -> None:
        """The stamp ``device_ns`` was taken at ``host_ns`` on the host
        clock, give or take ``uncertainty_ns``."""
        self.anchors.append((device_ns, host_ns))
        self.uncertainties_ns.append(uncertainty_ns)

    def to_host(self, device_ns: int) -> Optional[int]:
        """``device_ns`` on the host clock: the offset (host - device) of the
        anchors on either side, interpolated; the nearest one's beyond them."""
        if not self.anchors:
            return None
        i = bisect.bisect(self.anchors, (device_ns, 1 << 63))
        n = len(self.anchors)
        (t0, h0), (t1, h1) = self.anchors[max(i - 1, 0)], self.anchors[min(i, n - 1)]
        if t1 == t0:
            return device_ns + h0 - t0
        w = min(max((device_ns - t0) / (t1 - t0), 0.0), 1.0)
        return device_ns + round((h0 - t0) * (1 - w) + (h1 - t1) * w)

    def offset(self) -> Dict[str, Any]:
        """The offset (host ns = device ns + offset) at the last anchor, its
        uncertainty (the anchors' median), and the drift between the first
        anchor and the last, in parts per million."""
        if not self.anchors:
            return {"offset_ns": None, "uncertainty_ns": None, "drift_ppm": None, "anchors": 0}
        (t0, h0), (t1, h1) = self.anchors[0], self.anchors[-1]
        return {"offset_ns": h1 - t1, "uncertainty_ns": statistics.median(self.uncertainties_ns),
                "drift_ppm": ((h1 - t1) - (h0 - t0)) / (t1 - t0) * 1e6 if t1 > t0 else None,
                "anchors": len(self.anchors)}

    # ------------------------------------------------------------------ summary
    def snapshot(self) -> Dict[str, Any]:
        """A copy of the store: the block records (each on the host clock,
        its stages in ns), the spans, the totals, the clock offset, and
        ``idle_by_span``, the device idle between consecutive train blocks
        (graph replays; every train block where none was replayed) put down
        to the innermost span open at each gap's midpoint, in seconds."""
        blocks = []
        for rec in self.blocks:
            row = {"dispatch": rec.dispatch, "kind": rec.kind, "replay": rec.replay,
                   "launch_ns": rec.launch_ns, "start_ns": None, "end_ns": None, "stages": {}}
            if rec.stamps is not None:  # its start converted, its span as stamped
                start = self.to_host(rec.stamps[0])
                row.update(start_ns=start, end_ns=start + rec.stamps[len(rec.names) - 1]
                           - rec.stamps[0], stages=_stages(rec))
            blocks.append(row)
        spans = sorted((dataclasses.asdict(s) for s in self.spans), key=lambda s: s["start_ns"])
        return {"blocks": blocks, "spans": spans,
                "totals": {k: {"count": c, "ns": ns} for k, (c, ns) in self.totals.items()},
                "block_totals": {k: dict(v) for k, v in self.block_totals.items()},
                "clock": self.offset(), "idle_by_span": _idle_by_span(blocks, spans),
                "caps": {"spans": self.spans.maxlen, "blocks": self.blocks.maxlen}}


def _stages(rec: BlockRecord) -> Dict[str, int]:
    """Each stage's ns: from the boundary before it to its own."""
    n = len(rec.names)
    return {rec.names[i]: rec.stamps[i] - rec.stamps[i - 1] for i in range(1, n)}


def _idle_by_span(blocks: List[Dict[str, Any]], spans: List[Dict[str, Any]]) -> Dict[str, float]:
    train = [b for b in blocks if b["kind"] == "train" and b["start_ns"] is not None]
    replays = [b for b in train if b["replay"]]
    train = sorted(replays or train, key=lambda b: b["start_ns"])
    out: Dict[str, float] = {}
    nxt, running = 0, []  # spans sorted by start; those open at the midpoint
    for a, b in zip(train, train[1:]):
        gap = b["start_ns"] - a["end_ns"]
        if gap <= 0:
            continue
        mid = a["end_ns"] + gap // 2
        while nxt < len(spans) and spans[nxt]["start_ns"] <= mid:
            running.append(spans[nxt])
            nxt += 1
        running = [s for s in running if s["end_ns"] > mid]
        name = max(running, key=lambda s: s["start_ns"])["name"] if running else "none"
        out[name] = out.get(name, 0.0) + gap / 1e9
    return out


# ------------------------------------------------------------------ the current recorder
_CURRENT: List[PhaseTimer] = []


@contextlib.contextmanager
def recording(timer: PhaseTimer):
    """Makes ``timer`` the recorder of the module's ``span`` inside it."""
    _CURRENT.append(timer)
    try:
        yield timer
    finally:
        _CURRENT.pop()


def span(name: str):
    """A span of the current recorder (``recording``); none outside one."""
    return _CURRENT[-1].span(name) if _CURRENT else contextlib.nullcontext()
