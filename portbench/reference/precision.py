"""Operand rounding for the reference's products.

The reference computes every convolution and matrix product in float32
with TF32 off (``fp32``).  Its control computes them one precision step
below what the configuration states: ``fp8`` rounds both operands to
float8 e4m3 with one scale per tensor (the amax mapped to 448, as fp8
training recipes do) and the gradients that flow back into them to e5m2;
``tf32`` rounds all of them to TF32's 10-bit mantissa.  Products still
accumulate in float32.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to nearest-even on a 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def _scaled(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with a per-tensor scale."""
    return _scaled(x, torch.float8_e4m3fn, E4M3_MAX)


def fp8_grad(x: torch.Tensor) -> torch.Tensor:
    """A gradient through float8 e5m2 with a per-tensor scale (the fp8
    recipes' format for the backward's operands)."""
    return _scaled(x, torch.float8_e5m2, E5M2_MAX)


class _Round(torch.autograd.Function):
    """Rounds an operand forward, and the gradient that flows back into
    it: both products of the backward then read rounded operands."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


ROUND = {"fp32": None, "tf32": (tf32, tf32), "fp8": (fp8, fp8_grad)}


def rounder(mode: str):
    """The operand rounding of ``mode`` as a function of a tensor."""
    if ROUND[mode] is None:
        return lambda x: x
    fwd, bwd = ROUND[mode]
    return lambda x: _Round.apply(x, fwd, bwd)


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuBLAS and cuDNN inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
