"""launch_ms (pipeline, host: FusedPipeline._next_block): the host's
milliseconds inside a train block's graph.replay() (the launch of the
captured block), the mean over the window's blocks (the loop's train
replays), from the program's block records (benchmark/spans.py). None where
nothing was replayed (the CPU) or the program records no launches."""
from benchmark import spans


def read(ctx):
    blocks = spans.window_blocks(ctx)
    launches = [b["launch_ns"] for b in blocks or () if b["launch_ns"] is not None]
    if not launches:
        return None
    return sum(launches) / len(launches) / 1e6
