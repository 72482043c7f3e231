"""The readings that the limits of ``correct`` are set from, for one cell,
on the card, in one process (the benchmark's own runs never run this).

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13,... [--seconds S]

For every seed, one run of the cell exactly as the benchmark runs it, with
its window cut to the first train dispatch after ``--seconds`` (default 0:
most numbers compared come from set-up's first train block; a cell whose
window holds tests needs seconds enough for one), then, from what it
recorded: the program's numbers (``check.calibration``); the control's
(the reference in the program's place with its products one precision
below the configuration's, ``benchmark/precision.py``); and the faults:
half of each batch left out and one rollout Q-value altered, planted in
the reference put in the program's place; a graph replay that redraws the
first train block's numbers, and one that flips a bit of the ring outside
the insert's slots (an infinite reading); bipartitions not drawn from their
probabilities; in the window's first test, one Q-value and one action
altered. Prints one JSON line a seed, then the readings by the rule
of ``limits``: the lower reading (the largest of the program's; for
replay_gap, whose sound runs may read 0, at least float32's machine
epsilon, the least gap that rounding leaves), the upper (the smallest of
the control's where that is at least 3 times the lower, and of each
fault's where that is at least 10 times it, or 3 times for change_gap's
state left unchanged, which reads 1) and the limit between them,
lower^(1/3) * upper^(2/3). The exact numbers (``check.EXACT``) have the
limit 0 and are only read.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def limits(per_seed):
    """{number: {lower, upper, limit, upper_from}} from the seeds' readings."""
    from benchmark import check

    out = {}
    for k in (k for k in check.NUMBERS if k in per_seed[0]["program"]):
        lower = max(r["program"][k] for r in per_seed)
        if k in check.EXACT:
            out[k] = {"lower": lower, "limit": 0}
            continue
        if k == "replay_gap":
            lower = max(lower, float(np.finfo(np.float32).eps))
        candidates = [(min(r[kind][k] for r in per_seed), kind,
                       3.0 if kind == "control" else 10.0)
                      for kind, numbers in per_seed[0].items()
                      if kind != "program" and isinstance(numbers, dict) and k in numbers]
        if k == "change_gap":
            candidates.append((1.0, "state_unchanged", 3.0))
        held = [(v, name) for v, name, times in candidates if v >= times * lower and v > lower]
        if not held:
            out[k] = {"lower": lower, "upper": None, "limit": None}
            continue
        upper, source = min(held)
        out[k] = {"lower": lower, "upper": upper, "upper_from": source,
                  "limit": lower ** (1 / 3) * upper ** (2 / 3)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import check, harness

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = harness.load_cell(args.workload)
    per_seed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec, ctx = harness.drive(args.workload, seed, args.seconds, False, t0, spec=spec)
        readings = check.calibration(ctx["ref_mod"], rec, ctx["sizes"], ctx["dtype"],
                                     ctx["replay"], seed, ctx["test_faults"], ctx["test"])
        per_seed.append(readings)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0, **readings}),
              flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(per_seed),
                      "limits": limits(per_seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
