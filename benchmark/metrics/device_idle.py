"""device_idle (device): the share of the traced window's wall time (host
clock between two device syncs) in which no device operation ran, in
percent."""
from benchmark import trace


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(tr) / tr.window_s)
