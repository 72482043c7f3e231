"""The GRU recurrence CUDA kernels and their autograd wrapper.

``gru_sequence`` is the port's counterpart of
``refil_tpu/ops/pallas_gru.py:gru_sequence``. It dispatches on the device of
the tensors it is given:

  * CUDA tensors go through ``GRUFn``: the forward kernel (``gru_fwd`` in
    ``csrc/gru.cu``, replacing the Pallas ``_fwd_kernel``) and, on backward,
    the backward's kernels (``gru_bwd``, replacing ``_bwd_kernel``), at every T,
    the T = 1 rollout step included. The JAX dispatch sends T = 1 to its
    scan (``pallas_gru.py:326``); on the card one launch is cheaper than the
    chain of small ops a step takes, and one rule leaves no path around the
    kernel. A launch that fails raises; nothing falls back.
  * CPU tensors go to the plain PyTorch version ``ops.gru.gru_sequence``.

``launches`` counts the kernel launches of each wrapper. One backward launch
is all the stage kernels of one call: the recurrent product GH (two
products of ``csrc/gemm.cuh``), the kernel that carries dh, the weight
gradient's products over row chunks, db_hn's column sums and the chunks
summed in order.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .gru import gru_sequence as plain_gru_sequence

launches = {"gru_fwd": 0, "gru_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load

        lib = load("gru")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gru_max_hidden.restype = i
        lib.gru_plan.argtypes = [i] * 6 + [ctypes.POINTER(i)] * 5
        lib.gru_plan.restype = i
        lib.gru_fwd.argtypes = [i] + [p] * 5 + [i] * 5 + [p]
        lib.gru_fwd.restype = i
        lib.gru_bwd.argtypes = [i] + [p] * 12 + [i] * 7 + [p]
        lib.gru_bwd.restype = i
        lib.gru_error_string.argtypes = [i]
        lib.gru_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({lib.gru_error_string(err).decode()})")


def _validate(xw, wh, bhn, h0):
    if xw.dtype not in _DTYPES:
        raise TypeError(f"GRU kernel takes float32 or bfloat16 xw, not {xw.dtype}")
    if xw.device.type != "cuda":
        raise ValueError("the GRU kernel takes CUDA tensors")
    T, R, H3 = xw.shape
    H = h0.shape[-1]
    if H3 != 3 * H or wh.shape != (H, 3 * H) or bhn.shape != (H,) or h0.shape != (R, H):
        raise ValueError("GRU: shapes must be xw (T, R, 3H), wh (H, 3H), bhn (H,), h0 (R, H)")
    for t in (wh, bhn, h0):
        if t.device != xw.device:
            raise ValueError("GRU: all tensors must be on one device")
    if wh.dtype != torch.float32 or bhn.dtype != torch.float32:
        raise TypeError("GRU: wh and bhn must be float32 (the recurrence is float32)")
    if H > _lib().gru_max_hidden():
        raise ValueError(f"GRU kernel takes H <= {_lib().gru_max_hidden()}, not {H}")
    return T, R, H


class Plan(NamedTuple):
    rows_per_block: int  # 1, 2, 4 or 8: the recurrent kernel's template instance
    grid: int  # its blocks
    blocks_per_sm: int  # blocks of that instance one SM holds at once
    chunks: int  # backward: row chunks of the weight-gradient product over hs[:T-1]
    h0_chunks: int  # and over h0 (both 0 for the forward)


@functools.lru_cache(maxsize=64)  # a handful of shapes per run
def launch_plan(bwd: bool, T: int, R: int, H: int, dtype: torch.dtype,
                device_index: int) -> Plan:
    """The launch of the forward's or the backward's recurrent kernel for R
    rows (``gru_plan`` in ``csrc/gru.cu``)."""
    lib = _lib()
    out = [ctypes.c_int() for _ in Plan._fields]
    _check(lib, lib.gru_plan(int(bwd), _DTYPES[dtype], T, R, H, device_index,
                             *(ctypes.byref(v) for v in out)), "gru plan")
    return Plan(*(v.value for v in out))


def kernel_forward(xw, wh, bhn, h0) -> torch.Tensor:
    """Launches the forward kernel; returns hs (T, R, H) in ``xw``'s dtype.
    ``h0`` is read as float32."""
    T, R, H = _validate(xw, wh, bhn, h0)
    hs = torch.empty((T, R, H), dtype=xw.dtype, device=xw.device)
    if T * R == 0:
        return hs
    lib = _lib()
    plan = launch_plan(False, T, R, H, xw.dtype, xw.device.index)
    x, w, b, h = xw.contiguous(), wh.contiguous(), bhn.contiguous(), h0.float().contiguous()
    err = lib.gru_fwd(_DTYPES[xw.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(), h.data_ptr(),
                      hs.data_ptr(), T, R, H, plan.rows_per_block, plan.grid,
                      torch.cuda.current_stream(xw.device).cuda_stream)
    _check(lib, err, "gru_fwd launch")
    launches["gru_fwd"] += 1
    return hs


def kernel_backward(xw, hs, h0, wh, bhn, g):
    """Launches the backward's kernels; returns f32 (dxw, dwh, dbhn, dh0)."""
    T, R, H = _validate(xw, wh, bhn, h0)
    dev = xw.device
    if hs.shape != (T, R, H) or g.shape != (T, R, H):
        raise ValueError("GRU backward: hs and g must be (T, R, H)")
    f32 = dict(dtype=torch.float32, device=dev)
    dxw = torch.empty((T, R, 3 * H), **f32)
    if T * R == 0:
        return dxw, torch.zeros((H, 3 * H), **f32), torch.zeros((H,), **f32), \
            torch.zeros((R, H), **f32)
    dh0 = torch.empty((R, H), **f32)
    dweights = torch.empty((H * 3 * H + H,), **f32)
    lib = _lib()
    plan = launch_plan(True, T, R, H, xw.dtype, dev.index)
    gh = torch.empty((T * R * 3 * H,), **f32)  # h_{t-1} W_h for every step
    dgh = torch.empty((T * R * 3 * H,), **f32)  # [dpre_r | dpre_z | da_hn]
    partials = torch.empty((plan.chunks + plan.h0_chunks, H * 3 * H + H), **f32)
    x, s = xw.contiguous(), hs.to(xw.dtype).contiguous()
    gg = g.to(xw.dtype).contiguous()
    h, w, b = h0.float().contiguous(), wh.contiguous(), bhn.contiguous()
    err = lib.gru_bwd(_DTYPES[xw.dtype], x.data_ptr(), s.data_ptr(), gg.data_ptr(),
                      h.data_ptr(), w.data_ptr(), b.data_ptr(), dxw.data_ptr(),
                      dh0.data_ptr(), gh.data_ptr(), dgh.data_ptr(), partials.data_ptr(),
                      dweights.data_ptr(), T, R, H, plan.rows_per_block, plan.grid,
                      plan.chunks, plan.h0_chunks, torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, err, "gru_bwd launch")
    launches["gru_bwd"] += 1
    return dxw, dweights[:H * 3 * H].view(H, 3 * H), dweights[H * 3 * H:], dh0


class GRUFn(torch.autograd.Function):
    """Forward kernel forward, backward kernel backward. The backward
    recomputes the gates from the saved (xw, hs, h0); gradients are cast to
    the inputs' dtypes, as the JAX package's ``_vjp_bwd`` does
    (``pallas_gru.py:307-315``)."""

    @staticmethod
    def forward(ctx, xw, wh, bhn, h0):
        hs = kernel_forward(xw, wh, bhn, h0)
        ctx.save_for_backward(xw, hs, h0, wh, bhn)
        return hs

    @staticmethod
    def backward(ctx, g):
        xw, hs, h0, wh, bhn = ctx.saved_tensors
        dxw, dwh, dbhn, dh0 = kernel_backward(xw, hs, h0, wh, bhn, g)
        return dxw.to(xw.dtype), dwh.to(wh.dtype), dbhn.to(bhn.dtype), dh0.to(h0.dtype)


def gru_sequence(xw, wh, bhn, h0) -> torch.Tensor:
    """GRU over a sequence (see ``ops.gru.gru_sequence``): the CUDA kernels
    on CUDA tensors, the plain PyTorch version on CPU tensors."""
    if xw.device.type == "cpu":
        return plain_gru_sequence(xw, wh, bhn, h0)
    if xw.device.type != "cuda":
        raise ValueError(f"the GRU has no kernel for device {xw.device}")
    return GRUFn.apply(xw, wh, bhn, h0)
