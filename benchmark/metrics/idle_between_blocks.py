"""idle_between_blocks (device): the device's idle between consecutive
blocks of the window (the loop's train replays), the sum of each next
block's start stamp less this block's end stamp, over the last end less the
first start, in percent; read from the program's device stamps inside the
timed window itself, with no profiler running (benchmark/spans.py). None
where the program records no stamps or the window has fewer than two
blocks."""
from benchmark import spans


def read(ctx):
    blocks = spans.stamped_blocks(ctx)
    if blocks is None or len(blocks) < 2:
        return None
    idle = sum(max(0, b["start_ns"] - a["end_ns"]) for a, b in zip(blocks, blocks[1:]))
    return 100.0 * idle / (blocks[-1]["end_ns"] - blocks[0]["start_ns"])
