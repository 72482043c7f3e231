"""Times the port's kernels for variants of their CUDA sources, on one GPU,
in one process.

    python scripts/kernel_variants.py VARIANTS.json

VARIANTS.json maps a variant's name to a list of substitutions ``[file, old,
new]``, ``file`` being one of ``refil_torch/csrc/`` (``entity_attn.cu``,
``gemm.cuh``, ``gru.cu``); ``{"base": []}`` is the sources as they are.
Every ``.cu`` of each variant is built by nvcc (all at once) into the
variant's own directory under ``refil_torch/_build/`` (git-ignored). Then,
twice over, each variant in turn: the entity-attention forward and backward
in float32 at the combat slice's Bp 14,496, 4,832 and 8 (Ne 16, Nq 8, widths
128) and Group Matching's 4,896 and 1,632 (Ne = Nq = 8, widths 64), and at
14,496 and 4,832 in bfloat16 too (the products on the tensor cores), and the GRU
forward and backward at (T, R) = (151, 768) and (151, 256), H 64, timed by
CUDA events (``chip_smoke.cuda_time_ms``); a profile of one call each of the
attention forward at 8, 1,632 and 4,832, the backward at 4,832 (both also in
bfloat16) and the GRU backward at (151, 768) gives each stage kernel's device
time; and the largest error of the attention forward at 4,832 (float32 and
bfloat16, the bfloat16 backward's too) and of the GRU backward at (151, 768)
against the plain versions of their stages (a spot check: a variant worth keeping
goes into the sources and through ``chip_smoke.py``). Prints JSON lines;
needs a CUDA device and nvcc.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ATTN_SHAPES = [(14496, 16, 8, 128), (4832, 16, 8, 128), (8, 16, 8, 128),
               (4896, 8, 8, 64), (1632, 8, 8, 64)]  # Bp, Ne, Nq, width
GRU_SHAPES = [(151, 768), (151, 256)]  # T, R


def build(variants, out_dir):
    from refil_torch.ops import _build

    files = sorted(f for f in os.listdir(_build.CSRC_DIR) if f.endswith((".cu", ".cuh")))
    procs = []
    for name, subs in variants.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d)
        text = {f: open(os.path.join(_build.CSRC_DIR, f)).read() for f in files}
        for f, old, new in subs:
            if old not in text.get(f, ""):
                raise SystemExit(f"variant {name}: {old[:60]!r} is not in {f}")
            text[f] = text[f].replace(old, new)
        for f in files:
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text[f])
        for f in files:
            if f.endswith(".cu"):
                cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                       os.path.join(d, f"lib{f[:-3]}.so"), os.path.join(d, f)]
                procs.append((name, f, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, f, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name}: {f} does not build:\n{out}")
        print(json.dumps({"variant": name, "source": f, "ptxas": [
            ln.strip() for ln in out.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]}), flush=True)


def stage_us(call):
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    return [(e.name[:60], e.time_range.elapsed_us()) for e in sorted(
        (e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.time_range.start)]


def main(argv) -> None:
    if len(argv) != 1 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from refil_torch.ops import _build, entity_attn, gru_kernel
    from refil_torch.ops.attention import (entity_attention_backward_staged,
                                           entity_attention_forward_staged)
    from refil_torch.ops.gru import gru_backward_staged

    variants = json.load(open(argv[0]))
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="kernel_variants_", dir=_build.BUILD_DIR)
    build(variants, out_dir)
    print(json.dumps({"device": cs.smi_name_power()}), flush=True)
    attn = {s: cs.make_inputs(s[0], s[1], s[2], s[3], s[3], s[3], torch.float32, 3,
                              mask_rows=s[1]) for s in ATTN_SHAPES}
    attn_bf16 = {s: cs.make_inputs(s[0], s[1], s[2], s[3], s[3], s[3], torch.bfloat16, 3,
                                   mask_rows=s[1]) for s in ATTN_SHAPES[:2]}
    gru = {}
    for T, R in GRU_SHAPES:
        xs, wx, bx, wh, bhn, h0, g = cs.make_gru_inputs(T, R, cs.GRU_HIDDEN, torch.float32, 4)
        gru[T, R] = ((torch.matmul(xs, wx) + bx).transpose(0, 1).contiguous(), wh, bhn, h0, g)
    for rep in range(2):
        for name in variants:
            # point the wrappers at this variant's libraries
            for lib in ("entity_attn", "gru"):
                _build._BUILT[lib] = _build.Built(os.path.join(out_dir, name, f"lib{lib}.so"),
                                                  0.0, "")
            entity_attn._LIB = gru_kernel._LIB = None
            gru_kernel.launch_plan.cache_clear()
            ms = {}
            for s in ATTN_SHAPES[:2]:  # and the combat learner's in bfloat16
                ents, wi, wo, bo, pm, qm, g = attn_bf16[s]
                ms[f"attn_fwd_{s[0]}_bf16"] = cs.cuda_time_ms(
                    lambda: entity_attn.kernel_forward(ents, wi, wo, bo, pm, qm, cs.HEADS))
                ms[f"attn_bwd_{s[0]}_bf16"] = cs.cuda_time_ms(
                    lambda: entity_attn.kernel_backward(ents, wi, wo, pm, qm, g, cs.HEADS))
            for s in ATTN_SHAPES:
                ents, wi, wo, bo, pm, qm, g = attn[s]
                ms[f"attn_fwd_{s[0]}"] = cs.cuda_time_ms(
                    lambda: entity_attn.kernel_forward(ents, wi, wo, bo, pm, qm, cs.HEADS))
                ms[f"attn_bwd_{s[0]}"] = cs.cuda_time_ms(
                    lambda: entity_attn.kernel_backward(ents, wi, wo, pm, qm, g, cs.HEADS))
            for (T, R), (xw, wh, bhn, h0, g) in gru.items():
                hs = gru_kernel.kernel_forward(xw, wh, bhn, h0)
                ms[f"gru_fwd_{T}x{R}"] = cs.cuda_time_ms(
                    lambda: gru_kernel.kernel_forward(xw, wh, bhn, h0))
                ms[f"gru_bwd_{T}x{R}"] = cs.cuda_time_ms(
                    lambda: gru_kernel.kernel_backward(xw, hs, h0, wh, bhn, g))
            ents, wi, wo, bo, pm, qm, g = attn[ATTN_SHAPES[1]]
            xw, wh, bhn, h0, gg = gru[GRU_SHAPES[0]]
            hs = gru_kernel.kernel_forward(xw, wh, bhn, h0)
            err = {
                "attn_fwd": cs.max_err(
                    entity_attn.kernel_forward(ents, wi, wo, bo, pm, qm, cs.HEADS),
                    entity_attention_forward_staged(ents, wi, wo, bo, pm, qm, cs.HEADS).out),
                "gru_bwd": max(cs.scaled_err(a, b) for a, b in zip(
                    gru_kernel.kernel_backward(xw, hs, h0, wh, bhn, gg),
                    gru_backward_staged(xw, hs, h0, wh, bhn, gg))),
            }
            eb, wib, wob, bob, pmb, qmb, gb = attn_bf16[ATTN_SHAPES[1]]
            err["attn_fwd_bf16"] = cs.max_err(
                entity_attn.kernel_forward(eb, wib, wob, bob, pmb, qmb, cs.HEADS),
                entity_attention_forward_staged(eb, wib, wob, bob, pmb, qmb, cs.HEADS).out)
            err["attn_bwd_bf16"] = max(cs.scaled_err(a, b) for a, b in zip(
                entity_attn.kernel_backward(eb, wib, wob, pmb, qmb, gb, cs.HEADS),
                entity_attention_backward_staged(eb, wib, wob, pmb, qmb, gb, cs.HEADS)))
            e8, w8, o8, b8, p8, q8, _ = attn[ATTN_SHAPES[2]]
            eg, wg, og, bg, pg, qg, _ = attn[ATTN_SHAPES[4]]
            stages = {
                "attn_fwd_8": stage_us(
                    lambda: entity_attn.kernel_forward(e8, w8, o8, b8, p8, q8, cs.HEADS)),
                "attn_fwd_1632": stage_us(
                    lambda: entity_attn.kernel_forward(eg, wg, og, bg, pg, qg, cs.HEADS)),
                "attn_fwd_4832": stage_us(
                    lambda: entity_attn.kernel_forward(ents, wi, wo, bo, pm, qm, cs.HEADS)),
                "attn_bwd_4832": stage_us(
                    lambda: entity_attn.kernel_backward(ents, wi, wo, pm, qm, g, cs.HEADS)),
                "attn_fwd_4832_bf16": stage_us(
                    lambda: entity_attn.kernel_forward(eb, wib, wob, bob, pmb, qmb, cs.HEADS)),
                "attn_bwd_4832_bf16": stage_us(
                    lambda: entity_attn.kernel_backward(eb, wib, wob, pmb, qmb, gb, cs.HEADS)),
                "gru_bwd_151x768": stage_us(
                    lambda: gru_kernel.kernel_backward(xw, hs, h0, wh, bhn, gg)),
            }
            print(json.dumps({"variant": name, "round": rep, "ms": ms, "err": err,
                              "gru_bwd_plan": gru_kernel.launch_plan(
                                  True, *GRU_SHAPES[0], cs.GRU_HIDDEN, torch.float32,
                                  torch.cuda.current_device())._asdict(),
                              "stages_us": stages}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
