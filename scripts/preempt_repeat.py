"""Runs ``chip_smoke.py``'s preempt phase N times in one checkout, after
building the kernels, and counts the passes: whether a SIGTERM to a fused
combat run at full width gives exit 0, a checkpoint with the ring and a
resume that trains past it every time. Each run prints the phase's JSON
line (the subprocess's log tail where it fails). Needs one CUDA card.

    python3 scripts/preempt_repeat.py 3
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(argv) -> int:
    n = int(argv[0]) if argv else 3
    name_power = chip_smoke.phase_device()
    chip_smoke.phase_build(chip_smoke.attn_shapes(), chip_smoke.gru_shapes())
    fails = 0
    for i in range(n):
        try:
            chip_smoke.phase_preempt(name_power)
            print(f"preempt run {i}: ok", flush=True)
        except Exception as e:  # counted and reported: the tally is the result
            fails += 1
            print(f"preempt run {i}: FAILED: {e!r}", flush=True)
    print(f"preempt: {n - fails}/{n} passed", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
