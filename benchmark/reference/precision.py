"""The reference's products, in float32 or one precision below.

``prec`` is "f32" (the configuration's float32: every product summed in
float32 from float32 operands) or "tf32" (the control: the operands of
every float32 product rounded to TF32's 10-bit mantissa first, as the
card's TF32 tensor cores take them). The rounding is done on the
operands, so the control reads the same on the CPU and on the card, and
the card's TF32 switch stays off throughout.
"""

from __future__ import annotations

import torch

PRECISIONS = ("f32", "tf32")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to the nearest value with a 10-bit mantissa
    (ties away from zero, as the card's conversion does)."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back (round to nearest even)."""
    return x.to(torch.bfloat16).to(torch.float32)


def operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f32":
        return x
    if prec == "tf32":
        # The rounded value forward; the gradient passes as it would
        # through the card's own conversion of the operand.
        return x + (tf32_round(x.detach()) - x.detach())
    raise ValueError(f"unknown precision {prec!r}")


def bmm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    return torch.bmm(operand(a, prec), operand(b, prec))


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    return torch.matmul(operand(a, prec), operand(b, prec))


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           prec: str) -> torch.Tensor:
    return matmul(x, w.t(), prec) + b


def no_tf32() -> None:
    """Float32 products stay float32 on the card (PyTorch's own TF32
    switches off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
