"""Where the time of a PyTorch port slice goes, on one GPU, in both loops.

    python scripts/profile_torch_slice.py [--loop=fused|classic] [--config=ALG]
        [--env-config=ENV] [T_MAX] [k=v ...]
    python scripts/profile_torch_slice.py 4000      # Group Matching (the default slice)
    python scripts/profile_torch_slice.py --config=refil --env-config=entity_battle 7200 \\
        scenario=3-8sz_symmetric                    # the combat slice

Trains the slice through ``refil_torch.main`` (default
``--config=refil_group_matching --env-config=group_matching``, ``t_max`` 4000)
and profiles a window of its training with ``torch.profiler``'s schedule.
Without ``--loop`` it runs both loops, each in a process of its own (once
the profiler has run in a process, that process's later launches are
slower), and prints both windows:
  * classic (``use_fused_pipeline=False``): the blocks of the first WAIT
    learner updates run unprofiled, the next WARMUP are traced and dropped,
    and the next ACTIVE are kept (the run needs WAIT + WARMUP + ACTIVE
    updates);
  * fused (the default loop; on the card its blocks are CUDA graph
    replays), with ``max_blocks_per_dispatch=2`` unless the overrides set
    it: the first train dispatch (the eager first train block and the
    capture) runs unprofiled, the next is traced and dropped, and the next
    2 are kept (the run needs 4 train dispatches).
A window keeps the trace small: the whole combat run is ~1.1M kernel
launches, whose trace took longer to parse than the run. Prints JSON lines:
  * ``device``: the card's name and power limit (nvidia-smi);
  * ``profile``: the loop, the window's blocks, wall seconds (host clock
    between device syncs at its ends), summed device-kernel seconds, the
    device's idle share of the wall time, the share of device time in the
    port's own kernels (the entity attention's and the GRU's, their stages'
    products included) and of the products (``csrc/gemm.cuh``) alone, and
    the number of kernels launched (the run's
    env-steps/s are not printed: the trace is parsed inside the run;
    ``chip_smoke.py`` measures them unprofiled);
  * ``stages``: the device seconds of each stage of the entity-attention
    forward and backward and of the GRU forward and backward in the window
    (a call's kernels run in a fixed order on one stream; the stages are
    ``benchmark/trace.py``'s ``STAGES``);
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

# the kernels of one call of each hand-written kernel in launch order, and
# the index of the call's own kernel in it
from benchmark.trace import ANCHOR, STAGES  # noqa: E402

# the window (wait, warmup, active), in steps of the profiler's schedule:
# the classic loop steps once a learner update (a training block), the fused
# loop once a train dispatch, which holds FUSED_DISPATCH blocks here so that
# a short run has dispatches enough for a window of whole dispatches
WINDOW = {"classic": (1, 1, 3), "fused": (1, 1, 2)}
FUSED_DISPATCH = 2


def parse(argv):
    alg, env, t_max, overrides, loop = "refil_group_matching", "group_matching", 4000, [], None
    for tok in argv:
        if tok.startswith("--loop="):
            loop = tok.split("=", 1)[1]
            if loop not in WINDOW:
                raise SystemExit(f"profile_torch_slice: --loop is fused or classic, not {loop!r}")
        elif tok.startswith("--config="):
            alg = tok.split("=", 1)[1]
        elif tok.startswith("--env-config="):
            env = tok.split("=", 1)[1]
        elif tok.isdigit():
            t_max = int(tok)
        elif "=" in tok:
            overrides.append(tok)
        else:
            raise SystemExit(f"profile_torch_slice: unrecognised argument {tok!r}")
    return alg, env, t_max, overrides, loop


def stage_seconds(kernels):
    """Device seconds per stage of each hand-written kernel's calls
    (``STAGES``, in launch order) from (start_us, name, us) in time order:
    one stream runs a call's kernels one after another, so each call is the
    window of its stages around its anchor. A call whose window does not
    hold the expected kernels makes that kernel's entry None."""
    out = {}
    for call, stages in STAGES.items():
        anchor = ANCHOR[call]
        sums, calls = [0.0] * len(stages), 0
        for i, (_, name, _) in enumerate(kernels):
            if stages[anchor] not in name:
                continue
            window = kernels[i - anchor:i - anchor + len(stages)]
            if i < anchor or len(window) < len(stages) or any(
                    t not in n for t, (_, n, _) in zip(stages, window)):
                sums = None
                break
            for j, (_, _, us) in enumerate(window):
                sums[j] += us / 1e6
            calls += 1
        out[call] = None if sums is None else {"kernels": list(stages), "seconds": sums,
                                               "calls": calls, "total": sum(sums)}
    return out


def main(argv) -> None:
    alg, env, t_max, overrides, loop = parse(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: needs a CUDA device")
    if loop is None:  # each loop in a process of its own
        for lp in WINDOW:
            subprocess.run([sys.executable, os.path.abspath(__file__), f"--loop={lp}", *argv],
                           check=True)
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)

    from refil_torch import main as tmain
    from refil_torch import run as trun
    from refil_torch.learners.q_learner import QLearner
    from refil_torch.ops import _build

    _build.build_all()  # the build is set-up, outside the profiled window
    out_dir = os.path.join("results", "torch_profile")
    cli = [f"--config={alg}", f"--env-config={env}", "with", f"t_max={t_max}",
           f"local_results_path={out_dir}", f"use_fused_pipeline={loop == 'fused'}"]
    if loop == "fused" and not any(o.startswith("max_blocks_per_dispatch=") for o in overrides):
        cli.append(f"max_blocks_per_dispatch={FUSED_DISPATCH}")
    cli += overrides
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    window = {}

    def keep(prof):  # called once, when the ACTIVE steps have been traced
        window["kernels"] = sorted(
            (e.time_range.start, e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))

    wait, warmup, active = WINDOW[loop]
    prof = torch.profiler.profile(
        activities=acts, on_trace_ready=keep,
        schedule=torch.profiler.schedule(wait=wait, warmup=warmup, active=active, repeat=1))
    marks = []  # (host clock after a step's device work, training blocks in the step)

    def step(blocks):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), blocks))
        prof.step()

    if loop == "classic":
        train_iters = QLearner.train_iters

        def traced_train_iters(self, *args, **kwargs):
            metrics = train_iters(self, *args, **kwargs)
            step(1)
            return metrics

        QLearner.train_iters = traced_train_iters
    else:
        class TracedPipeline(trun.FusedPipeline):
            def run_blocks(self, ps, n_blocks, train=True):
                stats = super().run_blocks(ps, n_blocks, train=train)
                if train:
                    step(n_blocks)
                return stats

        trun.FusedPipeline = TracedPipeline
    with prof:
        summary = tmain.main(cli)
        torch.cuda.synchronize()
    if "kernels" not in window:
        raise SystemExit(f"profile_torch_slice: {len(marks)} profiler steps ran; the window "
                         f"needs {wait + warmup + active} (raise t_max)")
    first = wait + warmup
    wall = marks[first + active - 1][0] - marks[first - 1][0]
    blocks = sum(n for _, n in marks[first:first + active])
    kernels = window["kernels"]
    dev_us = sum(us for _, _, us in kernels)
    by_name = {}
    for _, name, us in kernels:
        calls, total = by_name.get(name, (0, 0.0))
        by_name[name] = (calls + 1, total + us)

    stages = stage_seconds(kernels)
    # csrc/gemm.cuh's products, inside the attention's and the GRU's calls:
    # both instances (gemm::gemm_kernel, f32 FMA; gemm::tc::gemm_kernel_tc,
    # the bf16 tensor cores)
    gemm = sum(t for name, (_, t) in by_name.items() if "gemm_kernel" in name) / 1e6

    def share(seconds):
        return seconds / (dev_us / 1e6) if dev_us else None

    print(json.dumps({"profile": {
        "card": smi, "loop": summary["loop"],
        "command": "python -m refil_torch.main " + " ".join(cli),
        "window_blocks": blocks, "window_wall_seconds": wall,
        "device_kernel_seconds": dev_us / 1e6,
        "device_idle_share": 1.0 - dev_us / 1e6 / wall,
        "entity_attn_share_of_device_time": share(sum(
            (stages[c] or {}).get("total", 0.0) for c in ("attn_fwd", "attn_bwd"))),
        "gru_share_of_device_time": share(sum(
            (stages[c] or {}).get("total", 0.0) for c in ("gru_fwd", "gru_bwd"))),
        "gemm_share_of_device_time": share(gemm),
        "kernel_launches": len(kernels), "kernel_launches_per_block": len(kernels) / blocks,
        "run_updates": summary["updates"], "run_blocks": summary["blocks"],
        "graphs": summary.get("graphs"),
    }}), flush=True)
    print(json.dumps({"stages": stages}), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    print(json.dumps({"top": [{"name": n[:120], "calls": c, "seconds": us / 1e6}
                              for n, (c, us) in top]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
    # freeing the profiler's event tree takes long at interpreter exit;
    # everything is printed by now
    sys.stdout.flush()
    os._exit(0)
