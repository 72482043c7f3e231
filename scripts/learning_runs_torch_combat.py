"""REFIL's combat learning curve on the card (ROADMAP A6, stage 2): ``refil``
on ``sc2custom`` 3-8sz_symmetric through ``python -m refil_torch.main`` at
the reference's untouched r5 protocol (``config/algs/refil.yaml`` and
``config/envs/sc2custom.yaml``: epsilon 1 -> 0.05 over 500k, buffer 5,000,
160-episode test blocks every 50k), only ``t_max`` set (1.6M by default).
Then the test win-rate crossings (``test_battle_won_mean``): the first test
point at or above 0.5 and 0.9, beside the JAX reference runs'
(``results/r5_runs/refil_sz``, seed 0, and ``refil_sz_s1``, seed 1). The
random streams differ from the reference's, so the crossings are compared at
test-block granularity, not point by point.

    python scripts/learning_runs_torch_combat.py [OUT]   # default results/combat_curves
    python scripts/learning_runs_torch_combat.py OUT --seed 1 --t-max 1900000

Further ``key=value`` arguments go to the CLI. Prints the card's name and
power limit and one JSON line: the crossings, the curve, the whole run's
env-steps/s (t_env over wall seconds, tests included), the training
env-steps/s and each test rollout's seconds.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCES = {"refil_sz (seed 0)": "results/r5_runs/refil_sz",
              "refil_sz_s1 (seed 1)": "results/r5_runs/refil_sz_s1"}
KEY = "test_battle_won_mean"


def curve(results_dir, key=KEY):
    rows = []
    for fn in glob.glob(os.path.join(results_dir, "metrics", "*.jsonl")):
        with open(fn) as f:
            rows += [json.loads(line) for line in f if line.strip()]
    return sorted({r["t"]: r["value"] for r in rows if r["key"] == key}.items())


def crossings(points):
    """First t at or above 0.5 and 0.9 (None where the curve never gets there)."""
    first = lambda thr: next((t for t, v in points if v >= thr), None)  # noqa: E731
    return {"ge_0.5": first(0.5), "ge_0.9": first(0.9),
            "best": max((v for _, v in points), default=None), "points": len(points)}


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=os.path.join(ROOT, "results", "combat_curves"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--t-max", type=int, default=1_600_000)
    ap.add_argument("overrides", nargs="*", default=[],
                    help="further key=value overrides for the CLI")
    args = ap.parse_args(argv)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip()
            if shutil.which("nvidia-smi") else "no nvidia-smi")
    name = f"refil_sz_s{args.seed}"
    out = os.path.join(args.out, name)
    os.makedirs(out, exist_ok=True)
    cli = ["--config=refil", "--env-config=sc2custom", "with", "scenario=3-8sz_symmetric",
           f"seed={args.seed}", f"t_max={args.t_max}", f"name={name}",
           f"local_results_path={out}", *args.overrides]
    sys.path.insert(0, ROOT)
    from refil_torch.main import main as cli_main

    t0 = time.perf_counter()
    summary = cli_main(cli)
    wall = time.perf_counter() - t0
    print(card, flush=True)
    port = curve(out)
    tests = summary.get("tests") or []
    row = {"run": name, "card": card, "cli": cli, "port": crossings(port),
           "reference": {k: crossings(curve(os.path.join(ROOT, d)))
                         for k, d in REFERENCES.items()},
           "t_env": summary["t_env"], "wall_seconds": wall,
           "whole_run_env_steps_per_s": summary["t_env"] / wall,
           "train_env_steps_per_s": summary["env_steps_per_s"],
           "test_rollout_seconds": [t.get("seconds") for t in tests],
           "test_rollout_seconds_total": sum(t.get("seconds") or 0.0 for t in tests),
           "port_curve": port}
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump({k: v for k, v in summary.items() if k not in ("dispatches",)}, f,
                  default=str)
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
