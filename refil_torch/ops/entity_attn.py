"""The masked entity-attention CUDA kernels and their autograd wrapper.

``entity_attention`` is the port's counterpart of
``refil_tpu/ops/pallas_attn.py:pallas_entity_attention``. It dispatches on the
device of the tensors it is given:

  * CUDA tensors go through ``EntityAttentionFn``: the forward kernels
    (``entity_attn_fwd`` in ``csrc/entity_attn.cu``, replacing the Pallas
    ``_kernel``) and, on backward, the backward kernels (``entity_attn_bwd``,
    replacing ``_bwd_kernel``). A launch that fails raises; nothing falls back.
  * CPU tensors go to the plain PyTorch version ``ops.attention.entity_attention``.

Weights keep the JAX layout at this interface: ``in_kernel`` (D, 3E),
``out_kernel`` (E, O), ``out_bias`` (O,).

``launches`` counts the kernel launches of each wrapper, so a run can show its
main path went through the kernels. One launch is all the stage kernels of
one call: forward, the projections (``csrc/gemm.cuh``), the per-sample kernel
and the output product; backward, the projections, the per-sample kernel,
the products of dEnts and the weight gradients over row chunks, and the
chunks summed in order. In bfloat16 every product runs on the tensor cores
(``gemm.cuh``'s wgmma instance) and the planes between the stages are
bfloat16; in float32 the products run on its f32 FMA instance. ``gemm``
launches the matrix product alone, for its checks; the main path never
calls it, so its count stays 0 there.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .attention import entity_attention as plain_entity_attention

launches = {"entity_attn_fwd": 0, "entity_attn_bwd": 0, "entity_attn_gemm": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load

        lib = load("entity_attn")
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.entity_attn_plan.argtypes = [i] * 10 + [ip] * 4
        lib.entity_attn_plan.restype = i
        lib.entity_attn_fwd.argtypes = [i] + [p] * 9 + [i] * 11 + [p]
        lib.entity_attn_fwd.restype = i
        lib.entity_attn_bwd.argtypes = [i] + [p] * 14 + [i] * 12 + [p]
        lib.entity_attn_bwd.restype = i
        ll = ctypes.c_longlong
        lib.entity_attn_gemm.argtypes = ([i] * 4 + [p, ll, i, i] + [p, ll] * 2 + [i] * 4
                                         + [ll, p, p] + [i] * 4 + [p])
        lib.entity_attn_gemm.restype = i
        lib.entity_attn_gemm_tile.argtypes = [i] * 4 + [ip] * 2
        lib.entity_attn_gemm_tile.restype = i
        lib.entity_attn_error_string.argtypes = [i]
        lib.entity_attn_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.entity_attn_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _validate(entities, in_kernel, out_kernel, pre_mask, post_mask, n_heads):
    if entities.dtype not in _DTYPES:
        raise TypeError(f"entity attention kernel takes float32 or bfloat16, not {entities.dtype}")
    Bp, Ne, D = entities.shape
    Nq = post_mask.shape[1]
    E = in_kernel.shape[1] // 3
    O = out_kernel.shape[1]
    tensors = [entities, in_kernel, out_kernel, post_mask]
    if pre_mask is not None:
        tensors.append(pre_mask)
    for t in tensors:
        if t.device != entities.device:
            raise ValueError("entity attention: all tensors must be on one device")
    for w in (in_kernel, out_kernel):
        if w.dtype != entities.dtype:
            raise TypeError("entity attention: weights must have the entities' dtype")
    if in_kernel.shape != (D, 3 * E) or out_kernel.shape != (E, O):
        raise ValueError("entity attention: weight shapes do not match (D,3E), (E,O)")
    if post_mask.dtype != torch.bool or post_mask.shape != (Bp, Nq) or not 0 < Nq <= Ne:
        raise ValueError("entity attention: post_mask must be bool (Bp, Nq) with 0 < Nq <= Ne")
    if pre_mask is not None and (pre_mask.dtype != torch.bool or pre_mask.dim() != 3
                                 or pre_mask.shape[0] != Bp or pre_mask.shape[1] < Nq
                                 or pre_mask.shape[2] != Ne):
        raise ValueError("entity attention: pre_mask must be bool (Bp, >=Nq, Ne)")
    if E % n_heads:
        raise ValueError(f"embed dim {E} is not a multiple of n_heads {n_heads}")
    return Bp, Ne, Nq, D, E, O


class Plan(NamedTuple):
    spb: int  # samples per block of the per-sample kernel
    grid: int  # its blocks
    smem: int  # its dynamic shared memory in bytes
    chunks: int  # row chunks of the backward's weight-gradient products (0: forward)
    # each product stage's instance of csrc/gemm.cuh, in launch order:
    # "stage=wgmma_bf16_<rows>x<cols>" (the tensor cores, its tile) or
    # "stage=fma_f32"
    products: tuple = ()


def product_stages(bwd: bool, dims, chunks: int):
    """(stage, M, N, split-K chunks) of each product a call launches, in
    the order ``launch_fwd`` / ``launch_bwd`` (``csrc/entity_attn.cu``)
    launch them."""
    Bp, Ne, Nq, D, E, O, _ = dims
    rows_e, rows_q = Bp * Ne, Bp * Nq
    stages = [("i_proj_kv", rows_e, 2 * E, 1), ("i_proj_q", rows_q, E, 1)]
    if not bwd:
        return stages + [("iii_out", rows_q, O, 1)]
    return stages + [("i_dattn", rows_q, E, 1), ("iii_dents_kv", rows_e, D, 1),
                     ("iii_dents_q", rows_q, D, 1), ("iii_dw_kv", D, 2 * E, chunks),
                     ("iii_dw_q", D, E, chunks), ("iii_dw_o", E, O, chunks)]


@functools.lru_cache(maxsize=64)  # a few dozen call shapes per run
def launch_plan(bwd: bool, dtype: torch.dtype, dims, device_index: int) -> Plan:
    """The launch of a call's per-sample kernel at ``dims`` = (Bp, Ne, Nq,
    D, E, O, heads), and the instance each of its products takes (bfloat16:
    the tensor cores, float32: FMA); raises where not even one sample fits
    one block's shared memory."""
    lib = _lib()
    Bp, Ne, Nq, D, E, O, H = dims
    out = [ctypes.c_int() for _ in range(4)]
    err = lib.entity_attn_plan(int(bwd), _DTYPES[dtype], Bp, Ne, Nq, D, E, O, H, device_index,
                               *(ctypes.byref(v) for v in out))
    _check(lib, err, f"entity attention plan (Ne={Ne} D={D} E={E} O={O}: too wide "
                     "for one block's shared memory?)")
    spb, grid, smem, chunks = (v.value for v in out)
    products = []
    for stage, M, N, ch in product_stages(bwd, dims, chunks):
        if dtype != torch.bfloat16:
            products.append(f"{stage}=fma_f32")
            continue
        rows, cols = ctypes.c_int(), ctypes.c_int()
        _check(lib, lib.entity_attn_gemm_tile(M, N, ch, device_index, ctypes.byref(rows),
                                              ctypes.byref(cols)), "entity_attn_gemm_tile")
        products.append(f"{stage}=wgmma_bf16_{rows.value}x{cols.value}")
    return Plan(spb, grid, smem, chunks, tuple(products))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def kernel_forward(entities, in_kernel, out_kernel, out_bias, pre_mask, post_mask,
                   n_heads: int) -> torch.Tensor:
    """Launches the forward's kernels on CUDA tensors; returns (Bp, Nq, O)."""
    Bp, Ne, Nq, D, E, O = _validate(entities, in_kernel, out_kernel, pre_mask, post_mask,
                                    n_heads)
    if entities.device.type != "cuda":
        raise ValueError("kernel_forward takes CUDA tensors")
    if (out_bias.shape != (O,) or out_bias.dtype != entities.dtype
            or out_bias.device != entities.device):
        raise ValueError("entity attention: out_bias must be (O,) like the entities")
    out = torch.empty((Bp, Nq, O), dtype=entities.dtype, device=entities.device)
    if Bp == 0:
        return out
    lib = _lib()
    ents, wi, wo, bo = (t.contiguous() for t in (entities, in_kernel, out_kernel, out_bias))
    pm = None if pre_mask is None else pre_mask.contiguous()
    qm = post_mask.contiguous()
    plan = launch_plan(False, entities.dtype, (Bp, Ne, Nq, D, E, O, n_heads),
                       entities.device.index)
    # scratch of the inputs' type (the values the TPU rounds to it): Q (then
    # attn), (Bp * Nq, E), and K|V, (Bp * Ne, 2E)
    scratch = torch.empty((Bp * (Nq + 2 * Ne) * E,), dtype=entities.dtype,
                          device=entities.device)
    q = scratch.data_ptr()
    kv = q + Bp * Nq * E * scratch.element_size()
    stream = torch.cuda.current_stream(entities.device).cuda_stream
    err = lib.entity_attn_fwd(
        _DTYPES[entities.dtype], _ptr(ents), _ptr(wi), _ptr(wo), _ptr(bo), _ptr(pm), _ptr(qm),
        _ptr(out), q, kv, Bp, Ne, Nq, D, E, O, n_heads,
        0 if pm is None else pm.shape[1], plan.spb, plan.grid, plan.smem, stream)
    _check(lib, err, "entity_attn_fwd launch")
    launches["entity_attn_fwd"] += 1
    return out


def kernel_backward(entities, in_kernel, out_kernel, pre_mask, post_mask, g,
                    n_heads: int):
    """Launches the backward kernel; returns f32 (dEnts, dW_qkv, dW_o, db_o)."""
    Bp, Ne, Nq, D, E, O = _validate(entities, in_kernel, out_kernel, pre_mask, post_mask,
                                    n_heads)
    dev = entities.device
    if dev.type != "cuda":
        raise ValueError("kernel_backward takes CUDA tensors")
    if g.shape != (Bp, Nq, O) or g.device != dev:
        raise ValueError("entity attention backward: g must be (Bp, Nq, O) on the entities' device")
    n_w, n_wo = D * 3 * E, E * O
    dents = torch.empty((Bp, Ne, D), dtype=torch.float32, device=dev)
    # the chunk sum writes every element; with no rows the gradients are 0
    dweights = (torch.empty if Bp > 0 else torch.zeros)((n_w + n_wo + O,), dtype=torch.float32,
                                                       device=dev)
    if Bp > 0:
        lib = _lib()
        ents, wi, wo = (t.contiguous() for t in (entities, in_kernel, out_kernel))
        gg = g.to(entities.dtype).contiguous()
        pm = None if pre_mask is None else pre_mask.contiguous()
        qm = post_mask.contiguous()
        plan = launch_plan(True, entities.dtype, (Bp, Ne, Nq, D, E, O, n_heads), dev.index)
        # planes of the inputs' type (each holds values the TPU rounds to it;
        # csrc/entity_attn.cu, BwdScratch); the chunk partials f32
        cdt = dict(dtype=entities.dtype, device=dev)
        q = torch.empty((Bp * Nq * E,), **cdt)  # Q, then dq
        kv = torch.empty((Bp * Ne * 2 * E,), **cdt)  # K|V, then dK|dV
        da = torch.empty((Bp * Nq * E,), **cdt)  # dattn, then attn
        gm = torch.empty((Bp * Nq * O,), **cdt)  # g * post_keep
        wt = torch.empty((3 * E * D + O * E,), **cdt)  # W^T
        partials = torch.empty((plan.chunks, n_w + n_wo + O), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.entity_attn_bwd(
            _DTYPES[entities.dtype], _ptr(ents), _ptr(gg), _ptr(wi), _ptr(wo), _ptr(pm),
            _ptr(qm), _ptr(dents), _ptr(q), _ptr(kv), _ptr(da), _ptr(gm), _ptr(wt),
            _ptr(partials), _ptr(dweights), Bp, Ne, Nq, D, E, O, n_heads,
            0 if pm is None else pm.shape[1], plan.spb, plan.grid, plan.smem, plan.chunks, stream)
        _check(lib, err, "entity_attn_bwd launch")
        launches["entity_attn_bwd"] += 1
    dwqkv = dweights[:n_w].view(D, 3 * E)
    dwo = dweights[n_w:n_w + n_wo].view(E, O)
    dbo = dweights[n_w + n_wo:]
    return dents, dwqkv, dwo, dbo


class Operand(NamedTuple):
    """A matrix as the product (``csrc/gemm.cuh``) reads it: element (r, c)
    at ``flat[row(r) * ld + c]``, with row(r) = (r // group) * stride + r %
    group (group = stride: plain rows; group Nq, stride Ne: the first Nq of
    every Ne rows)."""
    flat: torch.Tensor  # 1-d, float32 or bfloat16
    ld: int
    group: int = 1
    stride: int = 1

    def rows(self, n: int) -> torch.Tensor:
        r = torch.arange(n, device=self.flat.device)
        return (r // self.group) * self.stride + r % self.group

    def check(self, n_rows: int, n_cols: int, extra: int = 0) -> None:
        if self.flat.dim() != 1 or not self.flat.is_contiguous():
            raise ValueError("gemm: an operand is a contiguous 1-d tensor")
        if n_rows and n_cols:
            last = ((n_rows - 1) // self.group) * self.stride + (n_rows - 1) % self.group
            if last * self.ld + n_cols + extra > self.flat.numel():
                raise ValueError("gemm: an operand's rows reach past its tensor")

    def matrix(self, n_rows: int, n_cols: int) -> torch.Tensor:
        idx = self.rows(n_rows)[:, None] * self.ld + torch.arange(n_cols, device=self.flat.device)
        return self.flat[idx].float()


def plain_gemm(a: Operand, b: Operand, c: Operand, M: int, N: int, K: int, ka: bool,
               add: bool = False, round_bf16: bool = False, chunks: int = 1,
               chunk_stride: int = 0, bias: Optional[torch.Tensor] = None,
               drop: Optional[torch.Tensor] = None) -> None:
    """The plain version of ``gemm``: the same products written into ``c``
    the same way, by torch.matmul in float32."""
    A = a.matrix(M, K) if ka else a.matrix(K, M).T
    B = b.matrix(K, N)
    for chunk in range(chunks):
        k0, k1 = K * chunk // chunks, K * (chunk + 1) // chunks
        val = A[:, k0:k1] @ B[k0:k1]
        if bias is not None:
            val = val + bias.float()
        if drop is not None:
            val = val.masked_fill(drop[:, None], 0.0)
        if round_bf16:
            val = val.bfloat16().float()
        idx = (chunk * chunk_stride + c.rows(M)[:, None] * c.ld
               + torch.arange(N, device=c.flat.device))
        c.flat[idx] = (c.flat[idx].float() + val if add else val).to(c.flat.dtype)


def gemm(a: Operand, b: Operand, c: Operand, M: int, N: int, K: int, ka: bool,
         add: bool = False, round_bf16: bool = False, chunks: int = 1,
         chunk_stride: int = 0, bias: Optional[torch.Tensor] = None,
         drop: Optional[torch.Tensor] = None) -> None:
    """Launches the attention's matrix product alone on CUDA tensors: C (M x
    N) = sum over k of A(m, k) B(k, n), A stored m x k where ``ka`` (else
    k x m), B stored k x n (plain rows); chunk c of ``chunks`` sums its
    share of K into ``c`` shifted by c * ``chunk_stride``. The epilogue adds
    ``bias`` ((N,), C's dtype) and stores the rows where ``drop`` ((M,)
    bool) is set as zeros (with the forward's output product's types only).
    The forward and backward launch it from C (``launch_fwd``,
    ``launch_bwd``); this entry is for its checks. Takes the operand and
    output types they use (see ``entity_attn_gemm``): float32 operands on
    the FMA instance (C float32); bfloat16 operands on the tensor cores (C
    float32, or bfloat16 with A k-contiguous)."""
    for op in (a, b, c):
        if op.flat.dtype not in _DTYPES:
            raise TypeError(f"gemm takes float32 or bfloat16, not {op.flat.dtype}")
        if op.flat.device.type != "cuda" or op.flat.device != c.flat.device:
            raise ValueError("gemm takes CUDA tensors on one device")
    if b.group != 1 or b.stride != 1:
        raise ValueError("gemm: B has plain rows")
    if bias is not None and (bias.shape != (N,) or bias.dtype != c.flat.dtype
                             or not bias.is_contiguous()):
        raise ValueError("gemm: bias is (N,) of C's dtype")
    if drop is not None and (drop.shape != (M,) or drop.dtype != torch.bool):
        raise ValueError("gemm: drop is (M,) bool")
    a.check(*((M, K) if ka else (K, M)))
    b.check(K, N)
    c.check(M, N, (chunks - 1) * chunk_stride)
    lib = _lib()
    err = lib.entity_attn_gemm(
        _DTYPES[a.flat.dtype], _DTYPES[b.flat.dtype], int(ka), _DTYPES[c.flat.dtype],
        _ptr(a.flat), a.ld, a.group, a.stride, _ptr(b.flat), b.ld,
        _ptr(c.flat), c.ld, c.group, c.stride, int(add), int(round_bf16), chunk_stride,
        _ptr(bias), _ptr(drop), M, N, K, chunks,
        torch.cuda.current_stream(c.flat.device).cuda_stream)
    _check(lib, err, "entity_attn_gemm launch")
    launches["entity_attn_gemm"] += 1


class EntityAttentionFn(torch.autograd.Function):
    """Forward kernel forward, backward kernel backward. The masks get no
    gradient; the f32 gradients are cast to the inputs' dtypes, as the JAX
    package's ``_bwd`` does (``pallas_attn.py:393-400``)."""

    @staticmethod
    def forward(ctx, entities, in_kernel, out_kernel, out_bias, pre_mask, post_mask, n_heads):
        out = kernel_forward(entities, in_kernel, out_kernel, out_bias, pre_mask, post_mask,
                             n_heads)
        ctx.save_for_backward(entities, in_kernel, out_kernel, pre_mask, post_mask)
        ctx.n_heads = n_heads
        ctx.bias_dtype = out_bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        entities, in_kernel, out_kernel, pre_mask, post_mask = ctx.saved_tensors
        de, dwi, dwo, dbo = kernel_backward(entities, in_kernel, out_kernel, pre_mask,
                                            post_mask, g, ctx.n_heads)
        return (de.to(entities.dtype), dwi.to(in_kernel.dtype), dwo.to(out_kernel.dtype),
                dbo.to(ctx.bias_dtype), None, None, None)


def entity_attention(entities, in_kernel, out_kernel, out_bias, pre_mask, post_mask,
                     n_heads: int) -> torch.Tensor:
    """Masked entity attention (see ``ops.attention.entity_attention``): the
    CUDA kernels on CUDA tensors, the plain PyTorch version on CPU tensors."""
    if entities.device.type == "cpu":
        return plain_entity_attention(entities, in_kernel, out_kernel, out_bias, pre_mask,
                                      post_mask, n_heads)
    if entities.device.type != "cuda":
        raise ValueError(f"entity attention has no kernel for device {entities.device}")
    return EntityAttentionFn.apply(entities, in_kernel, out_kernel, out_bias, pre_mask,
                                   post_mask, n_heads)
