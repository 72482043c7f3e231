"""Wall-clock / ETA helpers (parity: reference ``src/utils/timehelper.py``)."""
from __future__ import annotations

import time


def time_str(s: float) -> str:
    days, remainder = divmod(s, 60 * 60 * 24)
    hours, remainder = divmod(remainder, 60 * 60)
    minutes, seconds = divmod(remainder, 60)
    out = ""
    if days > 0:
        out += "{:d} days, ".format(int(days))
    if hours > 0:
        out += "{:d} hours, ".format(int(hours))
    if minutes > 0:
        out += "{:d} minutes, ".format(int(minutes))
    out += "{:d} seconds".format(int(seconds))
    return out


def time_left(start_time: float, t_start: int, t_current: int, t_max: int) -> str:
    if t_current >= t_max:
        return "-"
    time_elapsed = time.time() - start_time
    t_current = max(1, t_current)
    time_left_s = time_elapsed * (t_max - t_current) / max(1, (t_current - t_start))
    # less than 100 days
    time_left_s = min(time_left_s, 60 * 60 * 24 * 100)
    return time_str(time_left_s)
