"""Where the time of a PyTorch port slice goes, on one GPU.

    python scripts/profile_torch_slice.py [--config=ALG] [--env-config=ENV] [T_MAX] [k=v ...]
    python scripts/profile_torch_slice.py 4000      # Group Matching (the default slice)
    python scripts/profile_torch_slice.py --config=refil --env-config=entity_battle 7200 \\
        scenario=3-8sz_symmetric                    # the combat slice

Trains the slice through ``refil_torch.main`` (default
``--config=refil_group_matching --env-config=group_matching``, ``t_max`` 4000)
and profiles a window of its training blocks with ``torch.profiler``'s
schedule: the blocks of the first WAIT learner updates run unprofiled, the
next WARMUP are traced and dropped, and the next ACTIVE are kept (a block
ends where its updates end; the run needs WAIT + WARMUP + ACTIVE updates). A
window keeps the trace small: the whole combat run is ~1.1M kernel launches,
whose trace took longer to parse than the run. Prints JSON lines:
  * ``device``: the card's name and power limit (nvidia-smi);
  * ``profile``: the window's wall seconds (host clock between device syncs
    at its ends), summed device-kernel seconds, the device's idle share of
    the wall time, the share of device time in the port's own kernels
    (entity attention with its backward's matrix product, GRU), and the
    number of kernels launched (the run's env-steps/s are not printed: the
    trace is parsed inside a training block; ``chip_smoke.py`` measures
    them unprofiled);
  * ``bwd_stages``: the device seconds of each stage of the entity-attention
    backward in the window (its kernels run in a fixed order on one stream,
    so the n-th kernel of each call is stage n);
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

WAIT, WARMUP, ACTIVE = 1, 1, 3  # learner updates (training blocks)
# the entity-attention backward's kernels in launch order (csrc/entity_attn.cu,
# launch_bwd), each with a piece of its kernel's name
BWD_STAGES = (("i_proj_kv", "gemm_kernel"), ("i_proj_q", "gemm_kernel"),
              ("i_dattn", "gemm_kernel"), ("ii_per_sample", "entity_attn_bwd_sample"),
              ("iii_dents_kv", "gemm_kernel"), ("iii_dents_q", "gemm_kernel"),
              ("iii_dw_kv", "gemm_kernel"), ("iii_dw_q", "gemm_kernel"),
              ("iii_dw_o", "gemm_kernel"), ("iii_db_o", "entity_attn_colsum"),
              ("iii_chunk_sum", "entity_attn_reduce"))


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


def bwd_stage_seconds(kernels):
    """Device seconds per backward stage from (start_us, name, us) in time
    order; None where the backward's kernels do not fall into whole calls of
    the expected sequence."""
    names = tuple(tag for _, tag in BWD_STAGES)
    seq = [(n, us) for _, n, us in kernels if any(tag in n for tag in names)]
    if not seq or len(seq) % len(BWD_STAGES):
        return None
    out = {stage: 0.0 for stage, _ in BWD_STAGES}
    for i, (name, us) in enumerate(seq):
        stage, tag = BWD_STAGES[i % len(BWD_STAGES)]
        if tag not in name:
            return None
        out[stage] += us / 1e6
    out["calls"] = len(seq) // len(BWD_STAGES)
    return out


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
    from refil_torch.learners.q_learner import QLearner
    from refil_torch.ops import _build

    _build.build_all()  # the build is set-up, outside the profiled window
    out_dir = os.path.join("results", "torch_profile")
    cli = [f"--config={alg}", f"--env-config={env}", "with", f"t_max={t_max}",
           f"local_results_path={out_dir}", *overrides]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    window = {}

    def keep(prof):  # called once, when the ACTIVE updates have been traced
        window["kernels"] = sorted(
            (e.time_range.start, e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))

    prof = torch.profiler.profile(
        activities=acts, on_trace_ready=keep,
        schedule=torch.profiler.schedule(wait=WAIT, warmup=WARMUP, active=ACTIVE, repeat=1))
    marks = []  # host clock after each update's device work
    train_iters = QLearner.train_iters

    def traced_train_iters(self, *args, **kwargs):
        metrics = train_iters(self, *args, **kwargs)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        prof.step()
        return metrics

    QLearner.train_iters = traced_train_iters
    with prof:
        summary = tmain.main(cli)
        torch.cuda.synchronize()
    if "kernels" not in window:
        raise SystemExit(f"profile_torch_slice: {summary['updates']} learner updates ran; the "
                         f"window needs {WAIT + WARMUP + ACTIVE} (raise t_max)")
    first = WAIT + WARMUP
    wall = marks[first + ACTIVE - 1] - marks[first - 1]
    kernels = window["kernels"]
    dev_us = sum(us for _, _, us in kernels)
    by_name = {}
    for _, name, us in kernels:
        calls, total = by_name.get(name, (0, 0.0))
        by_name[name] = (calls + 1, total + us)

    def share(*tags):
        us = sum(t for name, (_, t) in by_name.items() if any(tag in name for tag in tags))
        return us / dev_us if dev_us else None

    print(json.dumps({"profile": {
        "card": smi, "command": "python -m refil_torch.main " + " ".join(cli),
        "window_updates": ACTIVE, "window_wall_seconds": wall,
        "device_kernel_seconds": dev_us / 1e6,
        "device_idle_share": 1.0 - dev_us / 1e6 / wall,
        "entity_attn_share_of_device_time": share("entity_attn", "gemm_kernel"),
        "gru_share_of_device_time": share("gru_"),
        "kernel_launches": len(kernels),
        "run_updates": summary["updates"], "run_blocks": summary["blocks"],
    }}), flush=True)
    print(json.dumps({"bwd_stages": bwd_stage_seconds(kernels)}), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    print(json.dumps({"top": [{"name": n[:120], "calls": c, "seconds": us / 1e6}
                              for n, (c, us) in top]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
    # freeing the profiler's event tree takes long at interpreter exit;
    # everything is printed by now
    sys.stdout.flush()
    os._exit(0)
