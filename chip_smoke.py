"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --kernels-only  # build + kernel checks, no training

Phases, each printing JSON lines; any failure raises and exits non-zero:
  1. device: the card's name and power limit, torch and CUDA versions; TF32
     off for matmuls and cuDNN, so the plain versions are true float32.
  2. build: nvcc builds every ``refil_torch/csrc/*.cu`` for sm_90a from the
     sources in this checkout; prints the build time and ptxas's registers
     and shared memory per kernel.
  3. kernels: the entity-attention forward and backward kernels against the
     plain PyTorch version on the card, at every shape of the Group Matching
     slice in float32 and bfloat16, plus an Nq < Ne case with a fully blocked
     row, a post-masked row, no pre-mask and a batch that is not a multiple of
     the block's samples. Times by CUDA events after warm-up: the kernel, the
     plain version and a PyTorch yardstick (matmul + scaled_dot_product_attention),
     beside the least time the card could take (``bound_ms``).
  4. slice: ``refil_torch.main`` trains refil_group_matching on Group
     Matching for at least 16 learner updates; prints the last metrics, the
     env-steps/s of the training blocks and the kernels' launch counts, and
     checks them against the counts the run's shapes imply.
  5. the ``kernels`` line and the last line ``{"ok": true, "device": ...}``.

It exits non-zero, printing no result, where CUDA is not available or the
``refil_torch`` package is not beside it.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# the card's peaks used for bound_ms (H100 SXM data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {"fwd": {torch.float32: 1e-5, torch.bfloat16: 2e-2},
       "bwd": {torch.float32: 1e-4, torch.bfloat16: 2e-2}}

# (name, Bp): every entity-attention call of one refil_group_matching update
# and of a rollout step; Ne = Nq = 8, D = E = O = 64, 4 heads
SLICE_SHAPES = [("agent_x3", 4896), ("target_agent", 1632), ("mixer", 1600),
                ("rollout", 8)]
NE, NQ, WIDTH, HEADS = 8, 8, 64, 4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- inputs
def make_inputs(Bp, Ne, Nq, D, E, O, dtype, seed, pre=True, mask_rows=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    ents = torch.relu(torch.randn((Bp, Ne, D), generator=g, device=dev)).to(dtype)
    wi = ((torch.rand((D, 3 * E), generator=g, device=dev) * 2 - 1) / math.sqrt(D)).to(dtype)
    wo = ((torch.rand((E, O), generator=g, device=dev) * 2 - 1) / math.sqrt(E)).to(dtype)
    bo = ((torch.rand((O,), generator=g, device=dev) * 2 - 1) / math.sqrt(E)).to(dtype)
    pre_mask = None
    if pre:
        rows = mask_rows or Nq
        pre_mask = torch.rand((Bp, rows, Ne), generator=g, device=dev) < 0.25
        pre_mask[0, min(1, Nq - 1), :] = True  # a fully blocked row -> exact zeros
    post_mask = torch.rand((Bp, Nq), generator=g, device=dev) < 0.1
    post_mask[0, 0] = True
    gout = torch.randn((Bp, Nq, O), generator=g, device=dev).to(dtype)
    return ents, wi, wo, bo, pre_mask, post_mask, gout


def library_attention(ents, wi, wo, bo, pre_mask, post_mask, n_heads):
    """Yardstick: one PyTorch composition of the same function, with
    scaled_dot_product_attention. Timed here only; the port never calls it."""
    Bp, Ne, _ = ents.shape
    Nq = post_mask.shape[1]
    E = wi.shape[1] // 3
    hd = E // n_heads
    qkv = torch.matmul(ents, wi)
    q = qkv[:, :Nq, :E].reshape(Bp, Nq, n_heads, hd).transpose(1, 2)
    k = qkv[:, :, E:2 * E].reshape(Bp, Ne, n_heads, hd).transpose(1, 2)
    v = qkv[:, :, 2 * E:].reshape(Bp, Ne, n_heads, hd).transpose(1, 2)
    if pre_mask is None:
        a = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    else:
        keep = ~pre_mask[:, :Nq]
        a = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=keep[:, None])
        a = a.masked_fill(~keep.any(-1)[:, None, :, None], 0.0)
    a = a.transpose(1, 2).reshape(Bp, Nq, E)
    return (torch.matmul(a, wo) + bo).masked_fill(post_mask[..., None], 0.0)


def cost(Bp, Ne, Nq, D, E, O, dtype, pre: bool, bwd: bool):
    """(bytes, flops) the function needs: each input read once, each output
    written once; multiply-adds count 2 operations."""
    b = torch.tensor([], dtype=dtype).element_size()
    weights = (D * 3 * E + E * O + O) * b
    masks = Bp * Nq * (Ne if pre else 0) + Bp * Nq
    qkv = 2 * Bp * Ne * D * 3 * E
    scores = 2 * 2 * Bp * Nq * Ne * E  # q k^T and w v
    proj = 2 * Bp * Nq * E * O
    if not bwd:
        return Bp * Ne * D * b + weights + masks + Bp * Nq * O * b, qkv + scores + proj
    reads = Bp * Ne * D * b + Bp * Nq * O * b + weights + masks
    writes = Bp * Ne * D * 4 + (D * 3 * E + E * O + O) * 4
    flops = qkv + scores + 2 * proj + 2 * scores + 2 * qkv  # recompute + VJPs
    return reads + writes, flops


def cuda_time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max()) if a.numel() else 0.0


def scaled_err(a, b) -> float:
    """max |a - b| / max(1, max |b|): a gradient summed over thousands of
    samples is compared at the tolerance relative to its own scale."""
    if not a.numel():
        return 0.0
    return max_err(a, b) / max(1.0, float(b.detach().float().abs().max()))


# ---------------------------------------------------------------- phases
def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script runs on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_power = smi_name_power()
    print(name_power, flush=True)
    emit("device", nvidia_smi=name_power, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return name_power


def phase_build():
    from refil_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    wall = time.perf_counter() - t0
    for name, b in built.items():
        ptxas = [ln.strip() for ln in b.ptxas.splitlines()
                 if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
        emit("build", source=f"refil_torch/csrc/{name}.cu", nvcc_seconds=round(b.seconds, 2),
             wall_seconds=round(wall, 2), ptxas=ptxas)
    from refil_torch.ops import entity_attn

    for Bp in sorted({bp for _, bp in SLICE_SHAPES}):
        for bwd in (False, True):
            spb, grid, smem = entity_attn.launch_plan(
                bwd, (Bp, NE, NQ, WIDTH, WIDTH, WIDTH, HEADS), torch.cuda.current_device())
            emit("launch_plan", kernel="entity_attn_bwd" if bwd else "entity_attn_fwd", Bp=Bp,
                 samples_per_block_iteration=spb, grid=grid, dynamic_shared_memory_bytes=smem)
    return built


def check_case(tag, Bp, Ne, Nq, D, E, O, H, dtype, pre=True, mask_rows=None, seed=0,
               timing=False):
    from refil_torch.ops import entity_attn
    from refil_torch.ops.attention import entity_attention as plain

    ents, wi, wo, bo, pm, qm, gout = make_inputs(Bp, Ne, Nq, D, E, O, dtype, seed, pre,
                                                 mask_rows)
    out_k = entity_attn.kernel_forward(ents, wi, wo, bo, pm, qm, H)
    out_p = plain(ents, wi, wo, bo, pm, qm, H)
    torch.cuda.synchronize()
    fwd_err = max_err(out_k, out_p)
    if pm is not None:
        # a fully blocked row attends to nothing: its output is exactly the bias
        blocked = pm[:, :Nq].all(-1)
        expect = torch.where(qm[..., None], torch.zeros_like(bo), bo).expand_as(out_k)
        if not torch.equal(out_k[blocked], expect[blocked]):
            raise AssertionError(f"{tag}: a fully blocked row is not exactly the bias")
    if not torch.isfinite(out_k.float()).all():
        raise AssertionError(f"{tag}: forward kernel gave a non-finite value")

    # backward: kernel vs autograd of the plain version, same inputs and g
    grads_k = entity_attn.kernel_backward(ents, wi, wo, pm, qm, gout, H)
    leaves = [t.detach().clone().requires_grad_(True) for t in (ents, wi, wo, bo)]
    out_ref = plain(*leaves, pm, qm, H)
    grads_p = torch.autograd.grad(out_ref, leaves, gout, retain_graph=True)
    torch.cuda.synchronize()
    names = ("d_entities", "d_in_kernel", "d_out_kernel", "d_out_bias")
    bwd_err = {n: scaled_err(a, b) for n, a, b in zip(names, grads_k, grads_p)}
    tol_f, tol_b = TOL["fwd"][dtype], TOL["bwd"][dtype]
    row = dict(case=tag, Bp=Bp, Ne=Ne, Nq=Nq, D=D, E=E, O=O, heads=H,
               dtype=str(dtype).replace("torch.", ""), pre_mask=pre,
               fwd_max_abs_err=fwd_err, fwd_tol=tol_f, bwd_scaled_err=bwd_err, bwd_tol=tol_b,
               bwd_max_abs_err=max(max_err(a, b) for a, b in zip(grads_k, grads_p)))
    ok = fwd_err <= tol_f and all(v <= tol_b for v in bwd_err.values())

    if timing:
        lib_leaves = [t.detach().clone().requires_grad_(True) for t in (ents, wi, wo, bo)]
        out_lib = library_attention(*lib_leaves, pm, qm, H)
        row["library_fwd_max_abs_err"] = max_err(out_lib, out_p)
        row["ms"] = {
            "fwd": cuda_time_ms(lambda: entity_attn.kernel_forward(ents, wi, wo, bo, pm, qm, H)),
            "fwd_plain": cuda_time_ms(lambda: plain(ents, wi, wo, bo, pm, qm, H)),
            "fwd_library": cuda_time_ms(lambda: library_attention(ents, wi, wo, bo, pm, qm, H)),
            "bwd": cuda_time_ms(lambda: entity_attn.kernel_backward(ents, wi, wo, pm, qm, gout, H)),
            "bwd_plain": cuda_time_ms(
                lambda: torch.autograd.grad(out_ref, leaves, gout, retain_graph=True)),
            "bwd_library": cuda_time_ms(
                lambda: torch.autograd.grad(out_lib, lib_leaves, gout, retain_graph=True)),
        }
        for kind in ("fwd", "bwd"):
            nbytes, flops = cost(Bp, Ne, Nq, D, E, O, dtype, pre, kind == "bwd")
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
            row[f"{kind}_bytes"], row[f"{kind}_flops"] = nbytes, flops
            row[f"{kind}_bound_ms"] = max(t_bytes, t_ops)
            row[f"{kind}_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    emit("kernels_check", ok=ok, **row)
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {tag} {dtype}")
    return row


def phase_kernels():
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (tag, Bp) in enumerate(SLICE_SHAPES):
            rows.append(check_case(tag, Bp, NE, NQ, WIDTH, WIDTH, WIDTH, HEADS, dtype,
                                   seed=i, timing=True))
        # Nq < Ne, Bp not a multiple of the block's samples, a pre-mask with
        # more rows than queries, and no pre-mask at all
        rows.append(check_case("nq_lt_ne", 37, NE, 5, WIDTH, WIDTH, WIDTH, HEADS, dtype,
                               mask_rows=NE, seed=11))
        rows.append(check_case("nq_lt_ne_no_pre_mask", 37, NE, 5, WIDTH, WIDTH, WIDTH, HEADS,
                               dtype, pre=False, seed=12))
        rows.append(check_case("narrow_uneven", 3, 6, 6, 24, 32, 16, 2, dtype, seed=13))
    return rows


# one refil_group_matching learner update launches 9 forward and 6 backward
# attention calls: agent x3 (fwd+bwd), target agent (fwd), mixer chosen path
# hyper_w_1 + V (fwd+bwd), imagined path hyper_w_1 x2 + V (fwd+bwd), target
# mixer hyper_w_1 + V (fwd). A rollout step is one forward; a gt diagnostic is
# two imagine passes of agent + hyper_w_1 x2 + V.
FWD_PER_ITER, BWD_PER_ITER, FWD_PER_DIAG = 9, 6, 8
SLICE_T_MAX = 8000  # >= 21 blocks of <= 400 env steps: >= 18 learner updates


def phase_slice(name_power):
    from refil_torch import main as tmain
    from refil_torch.ops import entity_attn

    out_dir = os.path.join(HERE, "results", "torch_smoke")
    argv = ["--config=refil_group_matching", "--env-config=group_matching", "with",
            f"t_max={SLICE_T_MAX}", "use_cuda=True", f"local_results_path={out_dir}"]
    entity_attn.reset_launches()  # count only the main path's launches
    t0 = time.perf_counter()
    summary = tmain.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(entity_attn.launches)

    steps = summary["episode_limit"] * (summary["blocks"] + summary["test_blocks"])
    expected = {
        "entity_attn_fwd": FWD_PER_ITER * summary["iterations"] + steps
        + FWD_PER_DIAG * summary["diag_calls"],
        "entity_attn_bwd": BWD_PER_ITER * summary["iterations"],
    }
    loss = summary["last_metrics"].get("loss", float("nan"))
    emit("slice", command="python -m refil_torch.main " + " ".join(argv), wall_seconds=wall,
         card=name_power, env_steps_per_s=summary["env_steps_per_s"],
         train_seconds=summary["train_seconds"], t_env=summary["t_env"],
         blocks=summary["blocks"], test_blocks=summary["test_blocks"],
         updates=summary["updates"], iterations=summary["iterations"],
         diag_calls=summary["diag_calls"], last_metrics=summary["last_metrics"],
         params_max_abs_change=summary["params_max_abs_change"],
         launches=launches, expected_launches=expected)
    if summary["updates"] < 16:
        raise AssertionError(f"only {summary['updates']} learner updates ran")
    if not math.isfinite(loss):
        raise AssertionError(f"loss is not finite: {loss}")
    if not summary["params_max_abs_change"] > 0:
        raise AssertionError("training did not change the parameters")
    if min(launches.values()) <= 0 or launches != expected:
        raise AssertionError(f"kernel launches {launches} != expected {expected}")
    return launches


def kernels_line(rows, launches):
    """One entry per ported kernel, its numbers from the largest call of the
    slice (agent x3, Bp = 4896, float32)."""
    row = next(r for r in rows if r["case"] == "agent_x3" and r["dtype"] == "float32")
    out = []
    for kind, name, line in (("fwd", "entity_attn_fwd", 87), ("bwd", "entity_attn_bwd", 224)):
        err = row["fwd_max_abs_err"] if kind == "fwd" else row["bwd_max_abs_err"]
        out.append({
            "name": name, "route": "cuda", "source": "refil_torch/csrc/entity_attn.cu",
            "replaces": f"refil_tpu/ops/pallas_attn.py:{line}", "launches": launches[name],
            "max_abs_err": err, "ms": row["ms"][kind], "plain_ms": row["ms"][f"{kind}_plain"],
            "bound_ms": row[f"{kind}_bound_ms"], "bound_by": row[f"{kind}_bound_by"],
            "library_ms": row["ms"][f"{kind}_library"],
        })
    return {"kernels": out}


def main(argv) -> None:
    kernels_only = "--kernels-only" in argv
    if not os.path.isdir(os.path.join(HERE, "refil_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, HERE)
    name_power = phase_device()
    phase_build()
    rows = phase_kernels()
    if kernels_only:
        return
    launches = phase_slice(name_power)
    print(name_power, flush=True)
    print(json.dumps(kernels_line(rows, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
