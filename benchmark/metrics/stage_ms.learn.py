"""stage_ms.learn (learner: learners/q_learner.py; the sample in
core/pipeline.py): milliseconds from a train block's insert-end stamp to its
end stamp (the sample, gather and cast, the training_iters updates, the gt
diagnostics where they run, the target sync, the block's stats packed), the
mean over the window's blocks (the loop's train replays), from the
program's device stamps (benchmark/spans.py). None where the program
records no stamps."""
from benchmark import spans


def read(ctx):
    blocks = spans.stamped_blocks(ctx)
    if blocks is None:
        return None
    learn = [b["end_ns"] - b["start_ns"] - spans.rollout_ns(b) for b in blocks]
    return sum(learn) / len(learn) / 1e6
