"""stage_ms.mixer (learner, mixers and loss: learners/q_learner.py ``_loss``):
milliseconds a train block spends in its updates' mixers and losses, the sum
over its updates of each ``mix.<i>`` stage (from the ``agents.<i>`` stamp to
the stamp after the live and the target mixers' forward, the TD targets and
the loss, before the backward), the mean over the window's blocks (the
loop's train replays), from the program's device stamps
(benchmark/spans.py). None where the program records no stamps or no such
stage."""
from benchmark import spans

PREFIX = "mix."


def read(ctx):
    blocks = spans.stamped_blocks(ctx)
    if blocks is None or not any(k.startswith(PREFIX) for k in blocks[0]["stages"]):
        return None
    per_block = [sum(ns for k, ns in b["stages"].items() if k.startswith(PREFIX)) for b in blocks]
    return sum(per_block) / len(per_block) / 1e6
