"""block_ms.train (pipeline, core/pipeline.py): milliseconds a replayed train
block takes, summed over the window's train dispatches' replays (each
dispatch timed to a device sync) over the blocks replayed. Episode lengths
do not enter it: every block steps its envs episode_limit times."""


def read(ctx):
    train = [d for d in ctx["summary"]["dispatches"] if d["train"]]
    replays = sum(d["replays"] for d in train)
    if not replays:
        return None
    return 1e3 * sum(d["replay_seconds"] for d in train) / replays
