"""One run of one cell of the benchmark of refil_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout. Prints, as the last line of standard
output, one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared with its limit), and the same checks as the last lines of standard
error. With ``--trace 0`` the metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics. Exits non-zero, printing no
result, without a CUDA card (or with fewer than the cell asks for), or if
the process has loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(ROOT, "benchmark", "_run", "cache", sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    spec = harness.load_cell(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, ctx = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                 T_START, spec=spec)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}", file=sys.stderr)
        return 3
    print(f"window {ctx['window_blocks']} blocks, {ctx['window_env_steps']} env steps, "
          f"{ctx['window_tests']} tests in {ctx['window_seconds']!r} s; check took "
          f"{ctx['check_seconds']!r} s and {ctx['check_bytes']} device bytes", file=sys.stderr)
    print("setup " + " ".join(f"{k} {v!r}" for k, v in ctx["setup"].items()), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
