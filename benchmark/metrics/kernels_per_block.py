"""kernels_per_block (device): kernels in the traced window (copies and sets
left out) over the train blocks replayed in it."""
from benchmark import trace


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    return len(trace.kernels(tr)) / tr.blocks
