"""Combat learning curves on the card (ROADMAP A6, stage 2): one shipped
config on one ``sc2custom`` scenario set through ``python -m
refil_torch.main`` at the reference's untouched r5 protocol
(``config/algs/<config>.yaml`` and ``config/envs/sc2custom.yaml``: epsilon
1 -> 0.05 over 500k, buffer 5,000, 160-episode test blocks every 50k), only
``t_max`` set (1.6M by default). Then the test win-rate crossings
(``test_battle_won_mean``): the first test point at or above 0.5 and 0.9,
beside the JAX reference runs' of the same config and set
(``REFERENCES``: ``results/r5_runs/<run>``, every seed there is). The random
streams differ from the reference's, so the crossings are compared at
test-block granularity, not point by point.

    python scripts/learning_runs_torch_combat.py [OUT]   # refil, 3-8sz_symmetric, seed 0
    python scripts/learning_runs_torch_combat.py OUT --config qmix_atten --t-max 3800000
    python scripts/learning_runs_torch_combat.py OUT --scenario 3-8MMM_symmetric --seed 1

A run is named ``<config>_<set>_s<seed>`` (``SETS``: sz, mmm, csz, as
``results/r5_runs`` names them) and writes under ``OUT/<name>``; the default
OUT is ``results/combat_curves``. Further ``key=value`` arguments go to the
CLI. Prints the card's name and power limit and one JSON line: the
crossings, the curve, the whole run's env-steps/s (t_env over wall seconds,
tests included), the training env-steps/s and each test rollout's seconds.
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
# the scenario sets' short names in run names, as results/r5_runs has them
SETS = {"3-8sz_symmetric": "sz", "3-8MMM_symmetric": "mmm", "3-8csz_symmetric": "csz"}
# (config, scenario set) -> {seed: the JAX reference run of results/r5_runs}
REFERENCES = {
    ("refil", "3-8sz_symmetric"): {0: "refil_sz", 1: "refil_sz_s1"},
    ("qmix_atten", "3-8sz_symmetric"): {0: "qmix_atten_sz", 1: "qmix_atten_sz_s1"},
    ("refil", "3-8MMM_symmetric"): {0: "refil_mmm"},
    ("qmix_atten", "3-8MMM_symmetric"): {0: "qmix_atten_mmm"},
    ("refil", "3-8csz_symmetric"): {0: "refil_csz"},
    ("qmix_atten", "3-8csz_symmetric"): {0: "qmix_atten_csz"},
}
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


def run_name(config, scenario, seed):
    return f"{config}_{SETS.get(scenario, scenario)}_s{seed}"


def references(config, scenario):
    """{label: directory under the repo} of the reference runs of
    (config, scenario), one a seed; empty where the reference has none."""
    return {f"{run} (seed {seed})": os.path.join("results", "r5_runs", run)
            for seed, run in sorted(REFERENCES.get((config, scenario), {}).items())}


def plan(args):
    """(run name, CLI argv, references) of the parsed arguments."""
    name = run_name(args.config, args.scenario, args.seed)
    cli = [f"--config={args.config}", "--env-config=sc2custom", "with",
           f"scenario={args.scenario}", f"seed={args.seed}", f"t_max={args.t_max}",
           f"name={name}", f"local_results_path={os.path.join(args.out, name)}",
           *args.overrides]
    return name, cli, references(args.config, args.scenario)


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=os.path.join(ROOT, "results", "combat_curves"))
    ap.add_argument("--config", default="refil")
    ap.add_argument("--scenario", default="3-8sz_symmetric")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--t-max", type=int, default=1_600_000)
    ap.add_argument("overrides", nargs="*", default=[],
                    help="further key=value overrides for the CLI")
    return ap.parse_args(argv)


def main(argv):
    args = parse(argv)
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip()
            if shutil.which("nvidia-smi") else "no nvidia-smi")
    name, cli, refs = plan(args)
    out = os.path.join(args.out, name)
    os.makedirs(out, exist_ok=True)
    sys.path.insert(0, ROOT)
    from refil_torch.main import main as cli_main

    t0 = time.perf_counter()
    summary = cli_main(cli)
    wall = time.perf_counter() - t0
    print(card, flush=True)
    port = curve(out)
    tests = summary.get("tests") or []
    row = {"run": name, "card": card, "cli": cli, "port": crossings(port),
           "reference": {k: crossings(curve(os.path.join(ROOT, d))) for k, d in refs.items()},
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
