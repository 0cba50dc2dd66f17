"""The products of the reference's matrix multiplications, in float32 or,
for the precision control, in TF32: each float32 operand rounded to
TF32's 10-bit mantissa (to nearest, ties to even) before a float32
product, which is what the tensor cores do to float32 inputs when
``torch.backends.cuda.matmul.allow_tf32`` is on. Rounding the operands
here makes the control the same on every device."""

from __future__ import annotations

import contextlib
import threading

import torch

_STATE = threading.local()


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (1 sign, 8 exponent, 10 mantissa
    bits); non-finite entries as they are."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


@contextlib.contextmanager
def tf32_products():
    """Inside the block, ``matmul`` rounds its operands to TF32."""
    before = getattr(_STATE, "tf32", False)
    _STATE.tf32 = True
    try:
        yield
    finally:
        _STATE.tf32 = before


def matmul(a, b):
    """``a @ b`` in float32, or in TF32 inside ``tf32_products``."""
    if getattr(_STATE, "tf32", False):
        a, b = tf32_round(a), tf32_round(b)
    return a @ b
