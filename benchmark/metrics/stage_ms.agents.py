"""stage_ms.agents (learner, agents: learners/q_learner.py ``_loss``):
milliseconds a train block spends in its updates' agent forwards, the sum
over its updates of each ``agents.<i>`` stage (from the stamp before it, the
sample's or the previous update's end, to the stamp after the live and the
target agents' forward over the sampled episodes and the double-Q argmax),
the mean over the window's blocks (the loop's train replays), from the
program's device stamps (benchmark/spans.py). None where the program records
no stamps or no such stage."""
from benchmark import spans

PREFIX = "agents."


def read(ctx):
    blocks = spans.stamped_blocks(ctx)
    if blocks is None or not any(k.startswith(PREFIX) for k in blocks[0]["stages"]):
        return None
    per_block = [sum(ns for k, ns in b["stages"].items() if k.startswith(PREFIX)) for b in blocks]
    return sum(per_block) / len(per_block) / 1e6
