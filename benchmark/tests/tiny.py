"""A cell of the benchmark cut to a size the CPU runs in seconds: refil_sz's
configuration and the b8 traffic with narrow widths, short episodes, a small
batch and small dispatches, and, in a cell at a test cadence, a test after
every dispatch. For the tests only."""
import copy
import math

from benchmark import harness

TINY = {"attn_embed_dim": 16, "rnn_hidden_dim": 16, "hypernet_embed": 16,
        "mixing_embed_dim": 8, "batch_size": 4, "training_iters": 4, "buffer_size": 16}
TINY_RUN = {"batch_size_run": 4, "buffer_size": 16, "max_blocks_per_dispatch": 2}
EPISODE_LIMIT = 20
TESTS_NEVER = 1e9  # the test_interval of cells whose window holds no test


def tiny_spec(workload="refil_sz.b8"):
    """The cell's spec with its configuration cut down (what the command
    line and the size check both see)."""
    spec = copy.deepcopy(harness.load_cell(workload))
    cfg, traffic = spec["config"], spec["traffic"]
    cfg["sizes"].update(TINY, episode_limit=EPISODE_LIMIT)
    cfg["overrides"].update(TINY, **{"env_args.episode_limit": EPISODE_LIMIT})
    traffic["run"].update(TINY_RUN)
    if traffic["run"].get("test_interval", math.inf) < TESTS_NEVER:
        # a cell at a test cadence: a test of one block after every dispatch
        traffic["run"].update(test_interval=1, test_nepisode=TINY_RUN["batch_size_run"])
    traffic["check_envs"] = 3
    return spec
