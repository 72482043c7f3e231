"""stage_ms.rollout (runner, env, agents: runners/vector_runner.py,
envs/combat/, modules/): milliseconds from a train block's start stamp to its
insert's end stamp (the rollout of the block's envs, the ring insert and the
counters), the mean over the window's blocks (the loop's train replays). The
stamps are the program's own, written on the device inside the captured
block (refil_torch/core/pipeline.py, benchmark/spans.py). None where the
program records no stamps."""
from benchmark import spans


def read(ctx):
    blocks = spans.stamped_blocks(ctx)
    if blocks is None:
        return None
    return sum(spans.rollout_ns(b) for b in blocks) / len(blocks) / 1e6
