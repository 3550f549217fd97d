"""The arithmetic of the reference and of its controls.

``"ref"``: float64 products and sums, the reference itself.
``"tf32"``: each operand rounded to TF32 (10-bit mantissa, round to
nearest even), products summed in float32: what a TF32 tensor core
computes, the control of a configuration that states float32 with TF32
off.  ``"bf16"``: operands rounded to bfloat16, float32 sums, the output
rounded to bfloat16: a configuration that states bfloat16 compute.
``"fp8"``: operands scaled by their largest magnitude onto float8 e4m3
(per tensor), float32 sums, the output rounded to bfloat16: the control
of a bfloat16 configuration.  The roundings are explicit, so the same
code is the control on the CPU and on the card, whatever the library's
TF32 flags say (the harness turns TF32 off).
"""

from __future__ import annotations

import torch

PRECISIONS = ("ref", "tf32", "bf16", "fp8")
FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    scale = FP8_MAX / torch.clamp(x.abs().amax(), min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "ref":
        return x.to(torch.float64)
    return {"tf32": round_tf32, "bf16": round_bf16, "fp8": round_fp8}[prec](x)


def output(y: torch.Tensor, prec: str) -> torch.Tensor:
    """A product's result as the precision stores it."""
    if prec in ("bf16", "fp8"):
        return round_bf16(y)
    return y


def mm(a: torch.Tensor, b: torch.Tensor, prec: str = "ref") -> torch.Tensor:
    """``a @ b`` in ``prec``; float64 out for "ref", float32 otherwise."""
    if prec not in PRECISIONS:
        raise ValueError(f"unknown precision {prec!r}")
    return output(operand(a, prec) @ operand(b, prec), prec)


def st(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """``rounded`` forward, the identity's gradient backward."""
    return x + (rounded - x).detach()


class _GradRound(torch.autograd.Function):
    """Identity forward; the gradient rounded to bfloat16 backward, as a
    bfloat16 tensor's gradient is stored."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_bf16(g)


def grad_bf16(x: torch.Tensor) -> torch.Tensor:
    return _GradRound.apply(x)


def mm_grad(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """`mm` with gradients: the roundings pass gradients straight through;
    in "bf16" and "fp8" the operands' and the output's gradients are
    stored in bfloat16, as a bfloat16 layer's backward stores them."""
    if prec == "ref":
        return a.to(torch.float64) @ b.to(torch.float64)
    lo = prec in ("bf16", "fp8")
    a_, b_ = st(a.to(torch.float32), operand(a, prec)), st(b.to(torch.float32), operand(b, prec))
    if lo:
        a_, b_ = grad_bf16(a_), grad_bf16(b_)
    y = a_ @ b_
    y = st(y, output(y, prec))
    return grad_bf16(y) if lo else y
