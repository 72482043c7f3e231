"""The traced window: a few train blocks replayed under ``torch.profiler``
after the timed window has closed, read from the profiler's events.

``trace_blocks`` runs the program's own ``FusedPipeline.run_blocks`` on the
training state the window left: one block traced and dropped (the
profiler's warm-up), then ``blocks`` blocks kept, between two device syncs
whose host times bound the traced window. ``Trace`` holds the device
operations in time order and the host events beside them.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Tuple

import torch

# the kernels of one call of each hand-written kernel, in launch order
# (refil_torch/csrc/), each stage by a piece of its kernel's name; a call is
# found by its own kernel at index ANCHOR. Copied from
# scripts/profile_torch_slice.py (STAGES, ANCHOR), with the GRU forward.
STAGES = {
    "attn_fwd": ("gemm_kernel", "gemm_kernel", "entity_attn_fwd_sample", "gemm_kernel"),
    "attn_bwd": ("entity_attn_transpose", "entity_attn_transpose", "gemm_kernel", "gemm_kernel",
                 "gemm_kernel", "entity_attn_bwd_sample", "gemm_kernel", "gemm_kernel",
                 "gemm_kernel", "gemm_kernel", "gemm_kernel", "entity_attn_colsum",
                 "entity_attn_reduce"),
    "gru_fwd": ("gru_fwd_kernel",),
    "gru_bwd": ("gemm_kernel", "gemm_kernel", "gru_bwd_kernel", "gemm_kernel", "gemm_kernel",
                "gru_colsum", "gru_reduce"),
}
ANCHOR = {"attn_fwd": 2, "attn_bwd": 5, "gru_fwd": 0, "gru_bwd": 2}
NOT_KERNELS = ("Memcpy", "Memset")


class Op(NamedTuple):
    start_ns: int
    end_ns: int
    name: str


class Trace(NamedTuple):
    blocks: int
    window_s: float  # host clock between the syncs around the kept blocks
    device: List[Op]  # device operations, in start order
    host: List[Op]  # host events (operators and runtime calls)


def trace_blocks(pipeline, state, blocks: int) -> Trace:
    kept: Dict[str, list] = {}

    def keep(prof):
        kept["events"] = prof.profiler.kineto_results.events()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(
        activities=acts, on_trace_ready=keep,
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.start()
    pipeline.run_blocks(state, 1, train=True)  # traced and dropped; ends in a sync
    prof.step()
    t0 = time.perf_counter()
    pipeline.run_blocks(state, blocks, train=True)  # ends in a sync
    window_s = time.perf_counter() - t0
    prof.step()
    prof.stop()
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in kept.get("events", ()):
        if e.is_user_annotation() or e.name().startswith("ProfilerStep"):
            continue  # the profiler's own step marks, on both sides
        op = Op(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        (device if e.device_type() == cuda else host).append(op)
    device.sort()
    host.sort()
    return Trace(blocks, window_s, device, host)


def kernels(trace: Trace) -> List[Op]:
    return [op for op in trace.device if not op.name.startswith(NOT_KERNELS)]


def busy_seconds(trace: Trace) -> float:
    """Seconds in which at least one device operation ran (their union)."""
    total, end = 0, None
    for op in trace.device:
        if end is None or op.start_ns > end:
            total += op.end_ns - op.start_ns
            end = op.end_ns
        elif op.end_ns > end:
            total += op.end_ns - end
            end = op.end_ns
    return total / 1e9


def call_seconds(trace: Trace, call: str) -> Tuple[float, int]:
    """(device seconds, calls) of one hand-written kernel's calls: each
    call's stage kernels, found around its anchor in time order. Raises if
    a call's neighbours are not its stages."""
    ks = kernels(trace)
    stages, anchor = STAGES[call], ANCHOR[call]
    total, calls = 0, 0
    for i, op in enumerate(ks):
        if stages[anchor] not in op.name:
            continue
        window = ks[i - anchor:i - anchor + len(stages)]
        if i < anchor or len(window) < len(stages) or any(
                tag not in k.name for tag, k in zip(stages, window)):
            raise RuntimeError(f"{call}: the kernels around a call are "
                               f"{[k.name for k in window]}, not its stages {stages}")
        total += sum(k.end_ns - k.start_ns for k in window)
        calls += 1
    return total / 1e9, calls


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations with the most time, by name; and the idle
    gaps between device operations, by the innermost host event running at
    each gap's midpoint ("host idle" where none is)."""
    by_name: Dict[str, float] = {}
    for op in trace.device:
        by_name[op.name] = by_name.get(op.name, 0.0) + (op.end_ns - op.start_ns) / 1e9
    gaps: Dict[str, float] = {}
    host, nxt, running = trace.host, 0, []  # host events sorted by start
    end = None
    for op in trace.device:
        if end is not None and op.start_ns > end:
            mid = (end + op.start_ns) // 2
            while nxt < len(host) and host[nxt].start_ns <= mid:
                running.append(host[nxt])
                nxt += 1
            running = [h for h in running if h.end_ns > mid]
            name = max(running).name if running else "host idle"
            gaps[name] = gaps.get(name, 0.0) + (op.start_ns - end) / 1e9
        end = op.end_ns if end is None else max(end, op.end_ns)

    def ranked(d):
        return [[k[:200], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(by_name), "idle_gaps": ranked(gaps)}
