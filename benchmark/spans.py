"""The window's blocks as the program records them: the loop summary's
``spans`` (``refil_torch/utils/profiling.py``, ``PhaseTimer.snapshot``),
which the span metrics (``benchmark/metrics/``) read. Each block record
holds its dispatch, its kind, whether it was a graph replay, the host ns of
its launch, and, with the program's ``trace_blocks``, its start and end on
the host clock and each stage's ns from the device stamps
(``refil_torch/core/pipeline.py``). A program that records none gives
None."""
from typing import Any, Dict, List, Optional, Tuple


def window_blocks(ctx) -> Optional[List[Dict[str, Any]]]:
    """The window's blocks, in the order they ran: the loop's train graph
    replays (on the card the window runs from the train graph's capture to
    the loop's end); where no train block was replayed (the CPU), the train
    blocks after the first train dispatch, as ``harness._window_env_steps``
    counts them. None where the summary has no spans or no such block."""
    spans = ctx["summary"].get("spans")
    if not spans:
        return None
    train = [b for b in spans["blocks"] if b["kind"] == "train"]
    window = [b for b in train if b["replay"]]
    if not window and train:
        window = [b for b in train if b["dispatch"] != train[0]["dispatch"]]
    return window or None


def stamped_blocks(ctx) -> Optional[List[Dict[str, Any]]]:
    """``window_blocks`` where every one carries its stamps, by start;
    else None (the program ran with ``trace_blocks`` off)."""
    blocks = window_blocks(ctx)
    if blocks is None or any(b["start_ns"] is None for b in blocks):
        return None
    return sorted(blocks, key=lambda b: b["start_ns"])


def rollout_ns(block) -> int:
    """Start to the insert's end: the rollout, the ring insert, the counters."""
    return block["stages"]["rollout"] + block["stages"]["insert"]


def end_intervals_ns(blocks) -> List[int]:
    """The intervals between consecutive blocks' end stamps."""
    return [b["end_ns"] - a["end_ns"] for a, b in zip(blocks, blocks[1:])]


def test_intervals_ns(ctx) -> List[Tuple[int, int]]:
    """The (start, end) of the loop's ``test`` spans: a test runs on the
    host between two dispatches, so the device interval that holds one is
    the test's, not the blocks'."""
    return [(s["start_ns"], s["end_ns"]) for s in ctx["summary"]["spans"]["spans"]
            if s["name"] == "test"]


def holds_test(start_ns: int, end_ns: int, tests) -> bool:
    return any(s < end_ns and start_ns < e for s, e in tests)
