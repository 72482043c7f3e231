"""Where the time of a PyTorch port slice goes, on one GPU.

    python scripts/profile_torch_slice.py [--config=ALG] [--env-config=ENV] [T_MAX] [k=v ...]
    python scripts/profile_torch_slice.py 4000      # Group Matching (the default slice)
    python scripts/profile_torch_slice.py --config=refil --env-config=entity_battle 7200 \\
        scenario=3-8sz_symmetric                    # the combat slice

Trains the slice through ``refil_torch.main`` (default
``--config=refil_group_matching --env-config=group_matching``, ``t_max`` 4000)
under ``torch.profiler`` and prints JSON lines:
  * ``device``: the card's name and power limit (nvidia-smi);
  * ``profile``: wall seconds of the run, summed device-kernel seconds, the
    device's idle share of the wall time, the share of device time in the
    port's own kernels (entity attention, GRU), and the number of kernels
    launched;
  * ``top``: the device kernels with the most time (name, calls, seconds).
The ``k=v`` arguments are config overrides, as after ``with`` on the CLI.
Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse(argv):
    alg, env, t_max, overrides = "refil_group_matching", "group_matching", 4000, []
    for tok in argv:
        if tok.startswith("--config="):
            alg = tok.split("=", 1)[1]
        elif tok.startswith("--env-config="):
            env = tok.split("=", 1)[1]
        elif tok.isdigit():
            t_max = int(tok)
        elif "=" in tok:
            overrides.append(tok)
        else:
            raise SystemExit(f"profile_torch_slice: unrecognised argument {tok!r}")
    return alg, env, t_max, overrides


def main(argv) -> None:
    alg, env, t_max, overrides = parse(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)

    from refil_torch import main as tmain
    from refil_torch.ops import _build

    _build.build_all()  # the build is set-up, outside the profiled window
    out_dir = os.path.join("results", "torch_profile")
    cli = [f"--config={alg}", f"--env-config={env}", "with", f"t_max={t_max}",
           f"local_results_path={out_dir}", *overrides]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        summary = tmain.main(cli)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device kernels only: user annotations (e.g. "Optimizer.step#...") also
    # carry the CUDA device type and overlap the kernels they span
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        calls, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())

    def share(tag):
        us = sum(us for name, (_, us) in by_name.items() if tag in name)
        return us / dev_us if dev_us else None

    print(json.dumps({"profile": {
        "card": smi, "command": "python -m refil_torch.main " + " ".join(cli),
        "wall_seconds": wall, "env_steps_per_s_train_blocks": summary["env_steps_per_s"],
        "updates": summary["updates"], "iterations": summary["iterations"],
        "blocks": summary["blocks"], "test_blocks": summary["test_blocks"],
        "device_kernel_seconds": dev_us / 1e6,
        "device_idle_share": 1.0 - dev_us / 1e6 / wall,
        "entity_attn_share_of_device_time": share("entity_attn"),
        "gru_share_of_device_time": share("gru_"),
        "kernel_launches": len(kernels),
    }}), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    print(json.dumps({"top": [{"name": n[:120], "calls": c, "seconds": us / 1e6}
                              for n, (c, us) in top]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
    # freeing the profiler's event tree (~1M events for the combat slice)
    # takes minutes at interpreter exit; everything is printed by now
    sys.stdout.flush()
    os._exit(0)
