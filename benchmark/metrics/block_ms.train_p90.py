"""block_ms.train_p90 (pipeline, core/pipeline.py): the 90th percentile, in
milliseconds, of the intervals between consecutive end stamps of the
window's blocks (the loop's train replays: a dispatch boundary's host work
falls into one interval in 32), from the program's device stamps
(benchmark/spans.py); the tail beside block_ms.train's mean. None where the
program records no stamps or the window has fewer than three blocks."""
import statistics

from benchmark import spans


def read(ctx):
    blocks = spans.stamped_blocks(ctx)
    if blocks is None or len(blocks) < 3:
        return None
    return statistics.quantiles(spans.end_intervals_ns(blocks), n=10)[-1] / 1e6
