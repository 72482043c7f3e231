"""The flat path's learning curve on the card: ``qmix`` on the flat env
(``--env-config=sc2``, map 3m) through ``python -m refil_torch.main``, at the
protocol of the JAX reference run ``results/r3_runs/qmix_flat_3m``: 32 test
episodes every 25,000 env steps to t_max 500,000, epsilon annealed over
100,000 steps (that run's logged epsilon: 0.78 at 23k, 0.05 from 100k on;
``qmix.yaml`` ships 50,000), everything else as ``config/algs/qmix.yaml``
and ``config/envs/sc2.yaml`` ship. One process a seed, all at once. Then
the test win rate's crossings (``test_battle_won_mean``: the first test
point at or above 0.5 and 0.9, and the point from which every later one is
1.0) beside the reference's. The random streams differ from the
reference's, so the crossings are compared at test-block granularity.

    python scripts/learning_runs_torch_flat.py [OUT] [--seeds 0 1]

OUT defaults to results/flat_curves. Prints the card's name and power limit
and one JSON line a seed (the crossings, the curve and the run's summary).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from learning_runs_torch_gm import crossings, curve  # noqa: E402

REFERENCE = "results/r3_runs/qmix_flat_3m"
PROTOCOL = ["test_interval=25000", "t_max=500000", "epsilon_anneal_time=100000",
            "test_nepisode=32"]
KEY = "test_battle_won_mean"


def worker(seed, out):
    from refil_torch.main import main as tmain

    t0 = time.perf_counter()
    summary = tmain(["--config=qmix", "--env-config=sc2", "with", *PROTOCOL, f"seed={seed}",
                     f"name=qmix_flat_3m_s{seed}", f"local_results_path={out}"])
    summary = {k: v for k, v in summary.items() if k not in ("dispatches", "last_logged")}
    summary["wall_seconds"] = time.perf_counter() - t0
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f)


def main(argv):
    if argv[:1] == ["--worker"]:
        worker(int(argv[1]), argv[2])
        return
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=os.path.join(ROOT, "results", "flat_curves"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    procs = {}
    for seed in args.seeds:
        out = os.path.join(args.out, f"qmix_flat_3m_s{seed}")
        os.makedirs(out, exist_ok=True)
        log = open(os.path.join(out, "run.log"), "w")
        procs[seed] = (subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
                                         str(seed), out], cwd=ROOT,
                                        stdout=log, stderr=subprocess.STDOUT), log)
    failed = []
    try:
        for seed, (proc, log) in procs.items():
            if proc.wait() != 0:
                failed.append(seed)
            log.close()
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
    print(card, flush=True)
    ref = crossings(curve(os.path.join(ROOT, REFERENCE), KEY))
    for seed in args.seeds:
        out = os.path.join(args.out, f"qmix_flat_3m_s{seed}")
        port = curve(out, KEY)
        summary = None
        if os.path.exists(os.path.join(out, "summary.json")):
            with open(os.path.join(out, "summary.json")) as f:
                summary = json.load(f)
        print(json.dumps({"run": f"qmix_flat_3m_s{seed}", "card": card,
                          "overrides": PROTOCOL, "port": crossings(port),
                          "reference": ref, "port_curve": port, "summary": summary}),
              flush=True)
    if failed:
        raise SystemExit(f"runs failed: seeds {failed} (see their run.log)")


if __name__ == "__main__":
    main(sys.argv[1:])
