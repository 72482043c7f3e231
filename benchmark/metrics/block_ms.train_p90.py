"""block_ms.train_p90 (pipeline, core/pipeline.py): the 90th percentile, in
milliseconds, of the intervals between consecutive end stamps of the
window's blocks (the loop's train replays: a dispatch boundary's host work
falls into one interval in 32), from the program's device stamps
(benchmark/spans.py); the tail beside block_ms.train's mean. An interval
that holds a test rollout (a ``test`` span; cell refil_sz_bf16.b512_test)
is left out. None where the program records no stamps or fewer than two
intervals are left."""
import statistics

from benchmark import spans


def read(ctx):
    blocks = spans.stamped_blocks(ctx)
    if blocks is None or len(blocks) < 3:
        return None
    tests = spans.test_intervals_ns(ctx)
    intervals = [b["end_ns"] - a["end_ns"] for a, b in zip(blocks, blocks[1:])
                 if not spans.holds_test(a["end_ns"], b["end_ns"], tests)]
    if len(intervals) < 2:
        return None
    return statistics.quantiles(intervals, n=10)[-1] / 1e6
