"""The replay ring sharded over several cards: a fused combat run at full
width as ``--world`` NCCL ranks, one card each, against the same run as one
process, both saving a checkpoint with the ring at the end. Prints the
card's name and power limit and one JSON line: rank 0's logged losses
against the one process's (t_env exact, rtol 2e-4 as the gloo gate), each
run's seconds a replayed train block, the train graph's collectives and
their bytes, each rank's ring bytes and episodes, and whether the ranks'
checkpoint ring (gathered in global slot order) equals the one process's
bit for bit (the checkpoints are deleted after).

    python scripts/sharded_ring_cards.py [OUT] [--world 4] [key=value ...]

``key=value`` overrides go to both runs (``use_cuda=False`` runs the ranks
over gloo on the CPU, with narrow widths for a quick check). Exits non-zero
where a run fails or the losses disagree.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from refil_torch.parallel import gate  # noqa: E402

ARGV = ["--config=refil", "--env-config=entity_battle", "with", "scenario=3-8sz_symmetric",
        "test_nepisode=8", "t_max=6000", "learner_log_interval=1", "save_model=True",
        "save_model_interval=60000", "checkpoint_buffer=True"]


def logged(results_dir, key="loss"):
    rows = []
    for fn in glob.glob(os.path.join(results_dir, "metrics", "*.jsonl")):
        with open(fn) as f:
            rows += [json.loads(line) for line in f if line.endswith("\n")]
    return sorted((r["t"], r["value"]) for r in rows if r["key"] == key)


def replayed_seconds_per_block(summary):
    train = [d for d in summary["dispatches"] if d["train"]]
    blocks = sum(d["replays"] for d in train)
    return sum(d["replay_seconds"] for d in train) / blocks if blocks else None


def last_ring(results_dir):
    (token,) = glob.glob(os.path.join(results_dir, "models", "*"))
    step = max(int(s) for s in os.listdir(token))
    blob = torch.load(os.path.join(token, str(step), "state.pt"), map_location="cpu",
                      weights_only=True)
    return step, blob["pipeline"]["ring"]


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=os.path.join(ROOT, "results", "sharded_ring"))
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("overrides", nargs="*", default=[])
    args = ap.parse_args(argv)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()[0]
            if shutil.which("nvidia-smi") else "no nvidia-smi")
    if "use_cuda=False" not in args.overrides:
        from refil_torch.ops import _build

        _build.build_all()  # once, before the ranks load it
    one, multi = os.path.join(args.out, "one"), os.path.join(args.out, "multi")
    for d in (one, multi):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    gate.run_ranks([[*gate.cli_command(os.path.join(one, "rank0.json")), *ARGV,
                     *args.overrides, f"local_results_path={one}"]], timeout=600)
    gate.run_ranks(gate.cli_rank_commands(args.world, [*ARGV, *args.overrides,
                                                       f"local_results_path={multi}"],
                                          summary_dir=multi), timeout=600)
    s_one = json.load(open(os.path.join(one, "rank0.json")))
    s_ranks = [json.load(open(os.path.join(multi, f"rank{r}.json")))
               for r in range(args.world)]
    a, b = logged(one), logged(multi)
    same_t = bool(a) and [t for t, _ in a] == [t for t, _ in b]
    rel = [abs(x - y) / max(abs(x), 1e-6) for (_, x), (_, y) in zip(a, b)]
    close = same_t and bool(np.allclose([v for _, v in b], [v for _, v in a], rtol=2e-4,
                                        atol=1e-6))
    step_one, ring_one = last_ring(one)
    step_multi, ring_multi = last_ring(multi)
    ring_equal = step_one == step_multi and set(ring_one) == set(ring_multi) and all(
        torch.equal(ring_one[k].view(torch.uint8), ring_multi[k].view(torch.uint8))
        for k in ring_one)
    for d in (one, multi):  # the checkpoints hold the whole ring, GBs each
        shutil.rmtree(os.path.join(d, "models"))
    train = s_ranks[0]["graphs"].get("train", {})
    print(card, flush=True)
    print(json.dumps({
        "card": card, "world": args.world, "overrides": args.overrides,
        "losses_compared": len(a), "same_t_env": same_t, "losses_close": close,
        "max_rel_loss_diff": max(rel, default=None), "t_env": [s_one["t_env"],
                                                               s_ranks[0]["t_env"]],
        "replayed_seconds_per_block": replayed_seconds_per_block(s_ranks[0]),
        "one_process_replayed_seconds_per_block": replayed_seconds_per_block(s_one),
        "env_steps_per_s": s_ranks[0]["env_steps_per_s"],
        "one_process_env_steps_per_s": s_one["env_steps_per_s"],
        "train_graph_launches": train.get("launches"),
        "train_graph_collective_bytes": train.get("collective_bytes"),
        "ring_bytes": [s["ring_bytes"] for s in s_ranks],
        "ring_episodes": [s["ring_episodes"] for s in s_ranks],
        "one_process_ring_bytes": s_one["ring_bytes"],
        "checkpoint_step": [step_one, step_multi], "checkpoint_ring_bit_equal": ring_equal,
    }), flush=True)
    if not close:
        raise SystemExit("the ranks' losses disagree with the one process's")


if __name__ == "__main__":
    main(sys.argv[1:])
