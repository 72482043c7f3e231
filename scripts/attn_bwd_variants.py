"""Times the entity-attention backward for variants of its CUDA sources, on
one GPU, in one process.

    python scripts/attn_bwd_variants.py VARIANTS.json

VARIANTS.json maps a variant's name to a list of substitutions
``[file, old, new]``, ``file`` being ``"cu"`` (``csrc/entity_attn.cu``) or
``"cuh"`` (``csrc/gemm.cuh``); ``{"base": []}`` is the sources as they are.
Each variant is built by nvcc (all at once) into its own directory under
``refil_torch/_build/`` (git-ignored), then
``ops.entity_attn.kernel_backward`` runs on each in turn, twice over, in
float32 at the combat slice's Bp 14,496 and 4,832 (Ne 16, Nq 8, widths 128)
and Group Matching's 4,896 (Ne = Nq = 8, widths 64), timed by CUDA events
(``chip_smoke.cuda_time_ms``); a profile of one call at 4,832 gives each
stage kernel's device time. The variants' results are not checked: a
variant worth keeping goes into the sources and through ``chip_smoke.py``.
Prints JSON lines; needs a CUDA device and nvcc.
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

SHAPES = [(14496, 16, 8, 128), (4832, 16, 8, 128), (4896, 8, 8, 64)]  # Bp, Ne, Nq, width


def build(variants, out_dir):
    from refil_torch.ops import _build

    csrc = {"cu": "entity_attn.cu", "cuh": "gemm.cuh"}
    procs = {}
    for name, subs in variants.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d)
        text = {k: open(os.path.join(_build.CSRC_DIR, f)).read() for k, f in csrc.items()}
        for f, old, new in subs:
            if old not in text[f]:
                raise SystemExit(f"variant {name}: {old[:60]!r} is not in {csrc[f]}")
            text[f] = text[f].replace(old, new)
        for k, f in csrc.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text[k])
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
               os.path.join(d, "entity_attn.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} does not build:\n{out}")


def main(argv) -> None:
    if len(argv) != 1 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from refil_torch.ops import _build, entity_attn

    variants = json.load(open(argv[0]))
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="attn_bwd_variants_", dir=_build.BUILD_DIR)
    build(variants, out_dir)
    print(json.dumps({"device": cs.smi_name_power()}), flush=True)
    inputs = {s: cs.make_inputs(s[0], s[1], s[2], s[3], s[3], s[3], torch.float32, 3,
                                mask_rows=s[1]) for s in SHAPES}
    for rep in range(2):
        for name in variants:
            # point the wrapper at this variant's library
            _build._BUILT["entity_attn"] = _build.Built(os.path.join(out_dir, name, "lib.so"),
                                                        0.0, "")
            entity_attn._LIB = None
            ms = {}
            for s in SHAPES:
                ents, wi, wo, _, pm, qm, g = inputs[s]
                ms[s[0]] = cs.cuda_time_ms(
                    lambda: entity_attn.kernel_backward(ents, wi, wo, pm, qm, g, cs.HEADS))
            ents, wi, wo, _, pm, qm, g = inputs[SHAPES[1]]
            acts = [torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                entity_attn.kernel_backward(ents, wi, wo, pm, qm, g, cs.HEADS)
                torch.cuda.synchronize()
            stages = [(e.name[:60], e.time_range.elapsed_us()) for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            print(json.dumps({"variant": name, "round": rep, "bwd_ms": ms,
                              f"stages_us_at_{SHAPES[1][0]}": stages}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
