"""Group Matching learning-curve parity of the PyTorch port (ROADMAP A6,
stage 1): ``refil_group_matching`` (with ``test_gt_factors=True``) and
``qmix_atten_group_matching`` at the untouched paper configuration
(``config/envs/group_matching.yaml``: t_max 1M, 80 test episodes every 10k
env steps), seed 0, through ``python -m refil_torch.main`` on the card, the
two runs in two processes at once. Then the solved-rate crossings of each
run's test curve (``test_solved_mean``) beside the JAX reference runs'
(``results/r3_runs/{refil_gm,qmix_atten_gm}``): the first test point at or
above 0.5 and 0.9, and the point from which every later one is 1.0. The
random streams differ from the reference's, so the crossings are compared
at test-block granularity, not point by point.

    python scripts/learning_runs_torch_gm.py [OUT]   # default results/gm_curves

Prints one JSON line per run (crossings, the curve, the run's summary) and
the card's name and power limit.
"""
from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {
    "refil_gm": ("refil_group_matching", ["test_gt_factors=True"],
                 "results/r3_runs/refil_gm"),
    "qmix_atten_gm": ("qmix_atten_group_matching", [], "results/r3_runs/qmix_atten_gm"),
}


def curve(results_dir, key="test_solved_mean"):
    rows = []
    for fn in glob.glob(os.path.join(results_dir, "metrics", "*.jsonl")):
        with open(fn) as f:
            rows += [json.loads(line) for line in f if line.strip()]
    return sorted((r["t"], r["value"]) for r in rows if r["key"] == key)


def crossings(points):
    """First t at or above 0.5 and 0.9; the first t from which every point
    is 1.0 (None where the curve never gets there)."""
    first = lambda thr: next((t for t, v in points if v >= thr), None)  # noqa: E731
    solved_from = None
    for t, v in reversed(points):
        if v < 1.0:
            break
        solved_from = t
    return {"ge_0.5": first(0.5), "ge_0.9": first(0.9), "solved_from": solved_from}


def worker(tag, out):
    """One run, in this process; writes its summary next to its metrics."""
    sys.path.insert(0, ROOT)
    from refil_torch.main import main

    alg, extra, _ = RUNS[tag]
    t0 = time.perf_counter()
    summary = main([f"--config={alg}", "--env-config=group_matching", "with", "seed=0",
                    "t_max=1000000", f"name={tag}", f"local_results_path={out}", *extra])
    summary = {k: v for k, v in summary.items() if k not in ("dispatches", "last_logged")}
    summary["wall_seconds"] = time.perf_counter() - t0
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f)


def main(argv):
    if argv[:1] == ["--run"]:
        worker(argv[1], argv[2])
        return
    out_root = argv[0] if argv else os.path.join(ROOT, "results", "gm_curves")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    procs = {}
    for tag in RUNS:
        out = os.path.join(out_root, tag)
        os.makedirs(out, exist_ok=True)
        log = open(os.path.join(out, "run.log"), "w")
        procs[tag] = (subprocess.Popen([sys.executable, os.path.abspath(__file__), "--run", tag,
                                        out], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT),
                      log)
    failed = []
    try:
        for tag, (proc, log) in procs.items():
            if proc.wait() != 0:
                failed.append(tag)
            log.close()
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
    print(card, flush=True)
    for tag, (_, _, ref_dir) in RUNS.items():
        out = os.path.join(out_root, tag)
        port = curve(out)
        ref = curve(os.path.join(ROOT, ref_dir))
        summary = None
        if os.path.exists(os.path.join(out, "summary.json")):
            with open(os.path.join(out, "summary.json")) as f:
                summary = json.load(f)
        print(json.dumps({"run": tag, "card": card, "port": crossings(port),
                          "reference": crossings(ref), "port_curve": port,
                          "summary": summary}), flush=True)
    if failed:
        raise SystemExit(f"runs failed: {failed} (see their run.log)")


if __name__ == "__main__":
    main(sys.argv[1:])
