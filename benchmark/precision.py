"""The matrix products of the plain references, in float32 or in a lower
precision for the controls of ``correct``.

A control is the reference put in the program's place with its products
computed one precision below the configuration's: TF32 for float32 (the
operands rounded to TF32's 10-bit mantissa, the sums in float32, as the
tensor cores do), float8 for bfloat16 (e4m3 operands forward and e5m2
gradients backward, each tensor scaled so that its largest magnitude is the
format's largest, as float8 training recipes do). Both are emulated with
float32 arithmetic, so a control gives the same numbers on the CPU and on
the card. Elementwise work stays in float32.
"""
from __future__ import annotations

import torch


def exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x scaled to the float8 format's range, rounded to it and scaled back."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return (x.float() * scale).to(dtype).float() / scale


def _reduce_to(grad: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """Sums a broadcast product's gradient down to an operand's shape."""
    while grad.dim() > len(shape):
        grad = grad.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and grad.shape[i] != 1:
            grad = grad.sum(i, keepdim=True)
    return grad


class _Rounded(torch.autograd.Function):
    """a @ b with both operands rounded forward, and the gradient and the
    saved operands rounded in the two backward products."""

    @staticmethod
    def forward(ctx, a, b, fwd, bwd):
        ra, rb = fwd(a), fwd(b)
        ctx.save_for_backward(ra, rb)
        ctx.bwd = bwd
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = ctx.bwd(g)
        ga = torch.matmul(rg, rb.transpose(-1, -2))
        gb = torch.matmul(ra.transpose(-1, -2), rg)
        return _reduce_to(ga, ra.shape), _reduce_to(gb, rb.shape), None, None


def tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Rounded.apply(a, b, round_tf32, round_tf32)


def fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Rounded.apply(a, b, lambda x: round_fp8(x, torch.float8_e4m3fn),
                          lambda x: round_fp8(x, torch.float8_e5m2))


PRODUCTS = {"exact": exact, "tf32": tf32, "fp8": fp8}
# the control of each configuration dtype: the next precision below it
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
