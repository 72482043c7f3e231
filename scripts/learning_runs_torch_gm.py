"""Group Matching learning-curve parity of the PyTorch port (ROADMAP A6,
stage 1; fault C3): ``refil_group_matching`` (with ``test_gt_factors=True``)
and ``qmix_atten_group_matching`` at the untouched paper configuration
(``config/envs/group_matching.yaml``: t_max 1M, 80 test episodes every 10k
env steps) through ``python -m refil_torch.main`` on the card, at most
``--parallel`` runs in processes of their own at once. Then the solved-rate
crossings of each run's test curve (``test_solved_mean``) beside the JAX
reference runs' (``results/r3_runs/{refil_gm,qmix_atten_gm}``): the first
test point at or above 0.5 and 0.9, and the point from which every later one
is 1.0; and, for REFIL, ``gt_ingroup_prop`` at 300k (the mean of the last 5
logged values at or before it). The random streams differ from the
reference's, so the crossings are compared at test-block granularity, not
point by point.

    python scripts/learning_runs_torch_gm.py [OUT]   # default results/gm_curves
    python scripts/learning_runs_torch_gm.py OUT --parallel 2 \\
        --run refil_s1=refil_gm:seed=1 \\
        --run refil_plain=refil_gm:seed=0,use_pallas_attention=False

With no ``--run`` it runs both configs at seed 0. A ``--run`` is
``NAME=CONFIG:OVERRIDES``, CONFIG one of ``refil_gm``/``qmix_atten_gm`` and
OVERRIDES comma-separated ``key=value`` pairs for the CLI (``seed`` among
them; seed 0 when absent). Prints the card's name and power limit and one
JSON line per run (crossings, the curve, the run's summary).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
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


def mean_last_before(points, t_at, n=5):
    """Mean of the last ``n`` values logged at or before ``t_at`` (None if none)."""
    vals = [v for t, v in points if t <= t_at][-n:]
    return sum(vals) / len(vals) if vals else None


def parse_run(spec):
    name, rest = spec.split("=", 1)
    config, _, overrides = rest.partition(":")
    if config not in CONFIGS:
        raise SystemExit(f"unknown config {config!r} in --run {spec!r}")
    overrides = [o for o in overrides.split(",") if o]
    if not any(o.startswith("seed=") for o in overrides):
        overrides.append("seed=0")
    return name, config, overrides


def worker(name, config, out, overrides):
    """One run, in this process; writes its summary next to its metrics."""
    sys.path.insert(0, ROOT)
    from refil_torch.main import main

    alg, extra, _ = CONFIGS[config]
    t0 = time.perf_counter()
    summary = main([f"--config={alg}", "--env-config=group_matching", "with",
                    "t_max=1000000", f"name={name}", f"local_results_path={out}", *extra,
                    *overrides])
    summary = {k: v for k, v in summary.items() if k not in ("dispatches", "last_logged")}
    summary["wall_seconds"] = time.perf_counter() - t0
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f)


def main(argv):
    if argv[:1] == ["--worker"]:
        worker(argv[1], argv[2], argv[3], argv[4:])
        return
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default=os.path.join(ROOT, "results", "gm_curves"))
    ap.add_argument("--run", action="append", default=[])
    ap.add_argument("--parallel", type=int, default=2)
    args = ap.parse_args(argv)
    runs = [parse_run(s) for s in args.run] or [parse_run(f"{c}={c}:") for c in CONFIGS]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    pending, running, failed = list(runs), {}, []
    try:
        while pending or running:
            while pending and len(running) < args.parallel:
                name, config, overrides = pending.pop(0)
                out = os.path.join(args.out, name)
                os.makedirs(out, exist_ok=True)
                log = open(os.path.join(out, "run.log"), "w")
                running[name] = (subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--worker", name, config, out,
                     *overrides], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log)
            time.sleep(2)
            for name in [n for n, (p, _) in running.items() if p.poll() is not None]:
                proc, log = running.pop(name)
                log.close()
                if proc.returncode != 0:
                    failed.append(name)
    finally:
        for proc, _ in running.values():
            proc.kill()
    print(card, flush=True)
    for name, config, overrides in runs:
        out = os.path.join(args.out, name)
        port = curve(out)
        ref_dir = os.path.join(ROOT, CONFIGS[config][2])
        row = {"run": name, "config": config, "overrides": overrides, "card": card,
               "port": crossings(port), "reference": crossings(curve(ref_dir))}
        if config == "refil_gm":
            row["gt_ingroup_prop_300k"] = {
                "port": mean_last_before(curve(out, "gt_ingroup_prop"), 300_000),
                "reference": mean_last_before(curve(ref_dir, "gt_ingroup_prop"), 300_000)}
        summary = None
        if os.path.exists(os.path.join(out, "summary.json")):
            with open(os.path.join(out, "summary.json")) as f:
                summary = json.load(f)
        row.update(port_curve=port, summary=summary)
        print(json.dumps(row), flush=True)
    if failed:
        raise SystemExit(f"runs failed: {failed} (see their run.log)")


if __name__ == "__main__":
    main(sys.argv[1:])
