"""A cell of the benchmark cut to a size the CPU runs in seconds: refil_sz's
configuration and the b8 traffic with narrow widths, short episodes, a small
batch and small dispatches. For the tests only."""
import copy

from benchmark import harness

TINY = {"attn_embed_dim": 16, "rnn_hidden_dim": 16, "hypernet_embed": 16,
        "mixing_embed_dim": 8, "batch_size": 4, "training_iters": 4, "buffer_size": 16}
TINY_RUN = {"batch_size_run": 4, "max_blocks_per_dispatch": 2}
EPISODE_LIMIT = 20


def tiny_spec(workload="refil_sz.b8"):
    """The cell's spec with its configuration cut down (what the command
    line and the size check both see)."""
    spec = copy.deepcopy(harness.load_cell(workload))
    cfg, traffic = spec["config"], spec["traffic"]
    cfg["sizes"].update(TINY, episode_limit=EPISODE_LIMIT)
    cfg["overrides"].update(TINY, **{"env_args.episode_limit": EPISODE_LIMIT})
    traffic["run"].update(TINY_RUN)
    traffic["check_envs"] = 3
    return spec
