"""The r5 rule over the port's committed combat learning runs: for each
scenario set, REFIL's seeds on the card (``results/torch_runs/refil_<set>_s<N>``)
against the JAX reference's (``results/r5_runs``, ``REFERENCES``), and the
REFIL : QMIX-atten ratio at 0.5.

    python scripts/combat_curves_verdict.py [RUNS]   # default results/torch_runs

A set's REFIL gap is **variance** if (a) every port seed's first test point
>= 0.5 lies within twice the reference's (the median over its seeds), and
(b) the median over the port's seeds of the first >= 0.9 (a seed that never
gets there counts as its t_env at its end) is at most 1.5x the median of the
reference's seeds, or the reference's crossing (each seed's) lies inside
the port seeds' range widened by one 50k test block; otherwise a **fault**.
The ratio at 0.5 is QMIX-atten's first >= 0.5 over REFIL's, seed by seed
where both ran, beside the reference's. Prints one JSON line a set.
"""
from __future__ import annotations

import glob
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from learning_runs_torch_combat import REFERENCES, ROOT, SETS, crossings, curve  # noqa: E402

BLOCK = 50_000  # one test block of sc2custom's test_interval


def last_t(results_dir):
    """The run's t_env at its end (its summary's), else its last logged t."""
    summary = os.path.join(results_dir, "summary.json")
    if os.path.exists(summary):
        with open(summary) as f:
            return json.load(f)["t_env"]
    t = 0
    for fn in glob.glob(os.path.join(results_dir, "metrics", "*.jsonl")):
        with open(fn) as f:
            t = max([t, *(json.loads(line)["t"] for line in f if line.strip())])
    return t


def port_runs(runs, config, short):
    """{seed: (crossings, last t_env)} of the committed port runs."""
    out = {}
    for d in sorted(glob.glob(os.path.join(runs, f"{config}_{short}_s*"))):
        seed = int(d.rsplit("_s", 1)[1])
        out[seed] = (crossings(curve(d)), last_t(d))
    return out


def reference_runs(config, scenario):
    return {seed: crossings(curve(os.path.join(ROOT, "results", "r5_runs", run)))
            for seed, run in sorted(REFERENCES.get((config, scenario), {}).items())}


def verdict(port, ref):
    """The rule on {seed: (crossings, last t)} and {seed: crossings}."""
    ref05 = statistics.median(r["ge_0.5"] for r in ref.values())
    ref09 = [r["ge_0.9"] for r in ref.values()]
    port05 = {s: c["ge_0.5"] for s, (c, _) in port.items()}
    port09 = {s: c["ge_0.9"] if c["ge_0.9"] is not None else t for s, (c, t) in port.items()}
    a = all(v is not None and v <= 2 * ref05 for v in port05.values())
    median09, ref_median09 = statistics.median(port09.values()), statistics.median(ref09)
    lo, hi = min(port09.values()) - BLOCK, max(port09.values()) + BLOCK
    b_ratio = median09 <= 1.5 * ref_median09
    b_range = all(lo <= r <= hi for r in ref09)
    return {"a_every_0.5_within_2x": a, "port_0.5": port05, "reference_0.5_median": ref05,
            "port_0.9_or_last_t": port09, "port_0.9_median": median09,
            "reference_0.9": ref09, "reference_0.9_median": ref_median09,
            "b_median_within_1.5x": b_ratio, "b_reference_in_port_range": b_range,
            "port_0.9_range_widened": [lo, hi],
            "verdict": "variance" if a and (b_ratio or b_range) else "fault"}


def ratios(refil, qmix):
    """{seed: QMIX-atten's first >= 0.5 over REFIL's} where both crossed."""
    return {s: qmix[s]["ge_0.5"] / refil[s]["ge_0.5"] for s in sorted(set(refil) & set(qmix))
            if refil[s]["ge_0.5"] and qmix[s]["ge_0.5"]}


def main(argv):
    runs = argv[0] if argv else os.path.join(ROOT, "results", "torch_runs")
    for scenario, short in SETS.items():
        port = port_runs(runs, "refil", short)
        ref = reference_runs("refil", scenario)
        if not port or not ref:
            continue
        qmix = {s: c for s, (c, _) in port_runs(runs, "qmix_atten", short).items()}
        row = {"set": scenario, "refil_seeds": {s: c for s, (c, _) in port.items()},
               "qmix_atten_seeds": qmix, **verdict(port, ref),
               "ratio_0.5": ratios({s: c for s, (c, _) in port.items()}, qmix),
               "reference_ratio_0.5": ratios(ref, reference_runs("qmix_atten", scenario))}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
