"""Roundings of float32 values onto lower precisions, for the controls: the
reference put in the program's place one precision below the one the
configuration states (TF32 for float32 with TF32 off; float8 e4m3 for the
bf16 operands of the serving path)."""

from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, nearest even), kept float32:
    what a TF32 tensor-core product reads of each float32 operand.  The
    gradient passes through the rounding, as through a TF32 product's."""
    b = x.detach().float().contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0xFFF + lsb) & ~0x1FFF
    return x + (b.view(torch.float32) - x).detach()


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 (3 mantissa bits), kept float32."""
    return x.to(torch.float8_e4m3fn).float()


ROUNDINGS = {"f32": None, "tf32": tf32, "bf16": bf16, "fp8": fp8}
