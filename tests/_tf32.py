"""The float32 attention cores' precision scheme, 3xTF32, emulated on the
CPU for the port's tests: tf32 rounding on the bits as cvt.rna.tf32.f32
rounds, the split of a float32 value into tf32 halves, and a product taken
as a_lo b_hi + a_hi b_lo + a_hi b_hi with float32 accumulation. Patching
``torch.matmul`` with ``matmul_3xtf32`` runs a plain core's products as the
cores' tensor cores take them."""

import torch

_MATMUL = torch.matmul


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to tf32 (10 fraction bits) as cvt.rna.tf32.f32
    rounds a finite value: to nearest, ties away from zero, on the bits
    (u + 0x1000) & 0xFFFFE000."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)  # -0x2000: 0xFFFFE000


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def matmul_3xtf32(a, b):
    """a @ b as the float32 cores' tensor cores take it: both operands split
    into tf32 halves, a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first,
    float32 accumulation."""
    (ah, al), (bh, bl) = split(a.float()), split(b.float())
    return (_MATMUL(al, bh) + _MATMUL(ah, bl)) + _MATMUL(ah, bh)
