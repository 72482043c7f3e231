"""Checks refil_torch's spans and device stamps on the card, and what they cost.

    python scripts/span_check_torch.py check [CELL] [SECONDS] [DRIFT_SECONDS]
    python scripts/span_check_torch.py cost CELL SEED[,SEED...] SECONDS
    python scripts/span_check_torch.py one CELL SEED SECONDS on|off

``check`` (default cell ``refil_sz.b8``, 20 s window, 20 s of drift):
  * ``device``: the card's name and power limit (nvidia-smi);
  * ``stamp``: the stamp kernel (``csrc/stamp.cu``) built and run, its
    stamps in order, and the bounds of its clock's offset from the host
    clock read every half second for DRIFT_SECONDS (their drift);
  * ``run``: one ``--trace 1`` run of the cell through the benchmark's
    harness (``benchmark/harness.py``), its per-layer metrics (a reader's
    error is printed, not raised), kernels and anchor kernels a traced
    block, and the
    checks of the spans against each other and the profiler: the stamp
    kernels' starts in the profiler's trace against the program's stamps of
    the same blocks on the host clock (median and largest |difference|),
    stamp kernels a traced block, each window block's stages against its
    span, and the mean interval between the window's end stamps against
    ``block_ms.train``;
  * ``profiler_clock``: whether ``torch.profiler``'s host events fall
    between two reads of ``utils/profiling.CLOCK_NS`` around them.
``cost`` runs ``one`` in a process of its own for each seed, stamps on then
off (alternating which goes first), and prints each run's line and the
medians; ``one`` prints one run's ``env_steps_per_s``, ``block_ms.train``,
``setup_s`` and ``build_s`` with the program's ``trace_blocks`` on or off.
Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def emit(key, value):
    print(json.dumps({key: value}), flush=True)


def device_line():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit("device", {"smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})


def profiler_clock():
    from refil_torch.utils.profiling import CLOCK_NS

    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        before = CLOCK_NS()
        y = x * 2
        torch.cuda.synchronize()
        after = CLOCK_NS()
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mul"]
    host = events[0].start_ns() if events else None
    emit("profiler_clock", {"host_event_between_reads": bool(host and before <= host <= after),
                            "before": before, "event": host, "after": after,
                            "checksum": float(y.sum())})


def stamp_check(drift_seconds: float):
    from refil_torch.ops import stamp as stamp_op
    from refil_torch.utils.profiling import CLOCK_NS

    buf = torch.zeros(4, dtype=torch.int64, device="cuda")
    for slot in range(4):
        stamp_op.stamp(buf, slot)
    torch.cuda.synchronize()
    values = buf.tolist()
    ordered = all(b >= a for a, b in zip(values, values[1:])) and values[0] > 0
    bounds, t0 = [], time.perf_counter()
    while True:
        torch.cuda.synchronize()
        before = CLOCK_NS()
        stamp_op.stamp(buf, 0)
        torch.cuda.synchronize()
        after = CLOCK_NS()
        t = int(buf[0])
        bounds.append((round(time.perf_counter() - t0, 3), before - t, after - t))
        if time.perf_counter() - t0 >= drift_seconds:
            break
        time.sleep(0.5)
    lo = max(b[1] for b in bounds)
    hi = min(b[2] for b in bounds)
    emit("stamp", {"stamps": values, "ordered": ordered, "rounds": len(bounds),
                   "first": bounds[0], "last": bounds[-1], "lo": lo, "hi": hi,
                   "crossed": lo > hi, "widest_round_ns": max(b[2] - b[1] for b in bounds[1:])})


def run_check(cell: str, seconds: float, seed: int):
    from benchmark import harness, spans, trace
    from benchmark.trace import ANCHOR, STAGES
    from refil_torch.core.pipeline import FusedPipeline

    kept = []
    init = FusedPipeline.__init__

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        kept.append(self)

    FusedPipeline.__init__ = keep
    try:
        rec, ctx = harness.drive(cell, seed, seconds, True, time.perf_counter())
    finally:
        FusedPipeline.__init__ = init
    metrics, errors = {}, {}
    for m in harness.load_cell(cell)["per_layer"]:
        try:
            metrics[m["name"]] = harness.load_reader(m["name"])(ctx)
        except RuntimeError as err:  # a reader that finds the trace wrong
            errors[m["name"]] = str(err)
    kept[-1].anchor_clock()  # an anchor after the traced blocks, as the loop takes one
    timer = kept[-1].timer
    tr = ctx["trace"]
    kernels = trace.kernels(tr)
    anchors = {call: sum(STAGES[call][ANCHOR[call]] in k.name for k in kernels) / tr.blocks
               for call in STAGES}
    traced = list(timer.blocks)[-tr.blocks:]
    ops = [op for op in tr.device if "stamp_kernel" in op.name]
    program = [timer.to_host(t) for rec in traced for t in rec.stamps]
    diffs = [p - op.start_ns for p, op in zip(program, ops)]
    # the profiler against itself: its last device operation should end
    # before the host's closing cudaStreamSynchronize returns (both are on
    # its timeline); and the program's last stamp against that same return
    syncs = [op for op in tr.host if op.name == "cudaStreamSynchronize"]
    sync_end = max(op.end_ns for op in syncs) if syncs else None
    alignment = None if sync_end is None else {
        "profiler_last_device_end_minus_sync_end_ns": max(op.end_ns for op in tr.device) - sync_end,
        "program_last_stamp_minus_sync_end_ns": program[-1] - sync_end if program else None}
    blocks = spans.stamped_blocks(ctx)
    intervals = spans.end_intervals_ns(blocks)
    stage_gap = max(abs(sum(b["stages"].values()) - (b["end_ns"] - b["start_ns"]))
                    / (b["end_ns"] - b["start_ns"]) for b in blocks)
    block_ms = metrics.get("block_ms.train")
    mean_interval_ms = statistics.mean(intervals) / 1e6
    emit("run", {
        "cell": cell, "seed": seed, "metrics": metrics, "reader_errors": errors,
        "replay": ctx["replay"], "kernels_per_traced_block": len(kernels) / tr.blocks,
        "anchor_kernels_per_block": anchors,
        "clock": timer.offset(), "idle_by_span": ctx["summary"]["spans"]["idle_by_span"],
        "stamp_ops": len(ops), "program_stamps": len(program),
        "stamp_kernels_per_block": len(ops) / tr.blocks,
        "profiler_vs_program_ns": {"median_abs": statistics.median(abs(d) for d in diffs),
                                   "max_abs": max(abs(d) for d in diffs),
                                   "median": statistics.median(diffs),
                                   "each": diffs} if diffs else None,
        "alignment": alignment,
        "stages_vs_span_worst": stage_gap, "window_blocks": len(blocks),
        "mean_end_interval_ms": mean_interval_ms, "block_ms.train": block_ms,
        "interval_vs_block_ms": mean_interval_ms / block_ms - 1 if block_ms else None,
        "setup": ctx["setup"], "setup_s": ctx["setup_s"],
        "set_up_spans": set_up_spans(ctx),
        "breakdown_idle": trace.breakdown(tr)["idle_gaps"]})


def one(cell: str, seed: int, seconds: float, on: bool):
    from benchmark import harness

    spec = harness.load_cell(cell)
    spec["config"]["overrides"]["trace_blocks"] = on
    result, ctx = harness.run_cell(cell, seed, seconds, False, time.perf_counter(), spec=spec)
    emit("one", {"cell": cell, "seed": seed, "trace_blocks": on, "correct": result["correct"],
                 "env_steps_per_s": ctx["window_env_steps"] / ctx["window_seconds"],
                 "block_ms.train": harness.load_reader("block_ms.train")(ctx),
                 "setup_s": ctx["setup_s"], "build_s": harness.load_reader("build_s")(ctx),
                 "window_blocks": ctx["window_blocks"], "setup": ctx["setup"],
                 "set_up_spans": set_up_spans(ctx),
                 "idle_by_span": ctx["summary"]["spans"]["idle_by_span"],
                 "idle_between_blocks": harness.load_reader("idle_between_blocks")(ctx),
                 "launch_ms": harness.load_reader("launch_ms")(ctx),
                 "stage_ms": {k: harness.load_reader("stage_ms." + k)(ctx)
                              for k in ("rollout", "learn")}})


def set_up_spans(ctx):
    """Seconds in each of set-up's spans (summed where one name recurs)."""
    steps = ("build", "library", "setup", "eager", "capture", "instantiate", "test")
    return {k: v["ns"] / 1e9 for k, v in ctx["summary"]["spans"]["totals"].items()
            if k.split(".")[0] in steps}


def cost(cell: str, seeds, seconds: float):
    rows = []
    for i, seed in enumerate(seeds):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "one", cell,
                                  str(seed), str(seconds), "on" if on else "off"],
                                 capture_output=True, text=True, timeout=900)
            line = [ln for ln in out.stdout.splitlines() if ln.startswith('{"one"')]
            if out.returncode or not line:
                emit("failed", {"seed": seed, "on": on, "rc": out.returncode,
                                "stderr": out.stderr[-3000:]})
                continue
            row = json.loads(line[-1])["one"]
            rows.append(row)
            emit("cost_run", row)
    for key in ("env_steps_per_s", "block_ms.train", "setup_s", "build_s"):
        emit("cost_median", {key: {side: statistics.median(r[key] for r in rows
                                                           if r["trace_blocks"] == on)
                                   for side, on in (("on", True), ("off", False))
                                   if any(r["trace_blocks"] == on for r in rows)}})


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("span_check_torch: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode = argv[0] if argv else "check"
    if mode == "check":
        cell = argv[1] if len(argv) > 1 else "refil_sz.b8"
        seconds = float(argv[2]) if len(argv) > 2 else 20.0
        drift = float(argv[3]) if len(argv) > 3 else 20.0
        device_line()
        stamp_check(drift)
        run_check(cell, seconds, 2718281828)
        # last: profiling before the run could change what the
        # run's own traced window records
        profiler_clock()
    elif mode == "cost":
        device_line()
        cost(argv[1], [int(s) for s in argv[2].split(",")], float(argv[3]))
    elif mode == "one":
        one(argv[1], int(argv[2]), float(argv[3]), argv[4] == "on")
    else:
        raise SystemExit(f"span_check_torch: unknown mode {mode!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.stdout.flush()
    os._exit(0)  # the profiler's event tree is slow to free at exit; all is printed
