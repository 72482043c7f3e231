"""idle_between_blocks (device): the device's idle between consecutive
blocks of the window (the loop's train replays), the sum of each next
block's start stamp less this block's end stamp, over the last end less the
first start, in percent; read from the program's device stamps inside the
timed window itself, with no profiler running (benchmark/spans.py). A gap
that holds a test rollout (a ``test`` span; cell refil_sz_bf16.b512_test)
is the test's: it is left out of both sums. None where the program records
no stamps or the window has no two blocks without a test between them."""
from benchmark import spans


def read(ctx):
    blocks = spans.stamped_blocks(ctx)
    if blocks is None or len(blocks) < 2:
        return None
    tests = spans.test_intervals_ns(ctx)
    gaps = [(a["end_ns"], b["start_ns"]) for a, b in zip(blocks, blocks[1:])]
    kept = [(a, b) for a, b in gaps if not spans.holds_test(a, b, tests)]
    if not kept:
        return None
    idle = sum(max(0, b - a) for a, b in kept)
    tested = sum(b - a for a, b in gaps if spans.holds_test(a, b, tests))
    return 100.0 * idle / (blocks[-1]["end_ns"] - blocks[0]["start_ns"] - tested)
