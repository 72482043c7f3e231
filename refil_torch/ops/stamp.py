"""Clock stamps at the fused pipeline's stage boundaries (``core/pipeline.py``).

``stamp(buf, slot)`` writes the time into ``buf[slot]`` (int64 ns). On a
CUDA tensor it launches ``stamp_kernel`` (``csrc/stamp.cu``): one thread
writes the card's ``%globaltimer`` when the stream reaches it, so a CUDA
graph that captured the call rewrites the slot on every replay. On a CPU
tensor, where a block runs eagerly and synchronously, it writes the host
clock (``utils/profiling.CLOCK_NS``). Its launches are not counted in
``core/pipeline.launch_counts``: they are no attention or GRU work.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import CLOCK_NS

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ._build import load

        lib = load("stamp")
        lib.stamp_write.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.stamp_write.restype = ctypes.c_int
        lib.stamp_error_string.argtypes = [ctypes.c_int]
        lib.stamp_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def stamp(buf: torch.Tensor, slot: int) -> None:
    if not 0 <= slot < buf.numel() or buf.dtype != torch.int64:
        raise ValueError(f"stamp: slot {slot} of an int64 buffer of {buf.numel()}, "
                         f"not {buf.dtype}")
    if buf.device.type != "cuda":
        buf[slot] = CLOCK_NS()
        return
    lib = _lib()
    err = lib.stamp_write(buf.data_ptr(), slot, torch.cuda.current_stream(buf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stamp launch failed: CUDA error {err} "
                           f"({lib.stamp_error_string(err).decode()})")
