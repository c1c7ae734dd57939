"""Precisions of the reference: exact float32 (TF32 off) for every check,
and the lower precisions of the controls, which put the reference in the
system's place one step below the precision the configuration states:
float8 (e4m3, per-tensor scale) for bfloat16, TF32 for float32."""

from __future__ import annotations

import contextlib

import torch
from torch import nn

FP8_MAX = 448.0  # largest finite float8_e4m3fn


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 in cuBLAS and cuDNN on or off for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, in its dtype."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = FP8_MAX / amax
    return ((x * scale).to(torch.float8_e4m3fn).to(x.dtype)) / scale


@contextlib.contextmanager
def fp8_products(model: nn.Module):
    """Every convolution's and linear layer's weight and input rounded to
    float8 for the duration (the products then run on float8 values)."""
    saved, hooks = {}, []
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            saved[mod] = mod.weight.data
            mod.weight.data = fp8(mod.weight.data)
            hooks.append(mod.register_forward_pre_hook(
                lambda _m, args: (fp8(args[0]),) + tuple(args[1:])))
    try:
        yield model
    finally:
        for h in hooks:
            h.remove()
        for mod, w in saved.items():
            mod.weight.data = w


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (nearest, ties to
    even), as float32."""
    if x.dtype != torch.float32:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    # the rounding in the forward, the products' own gradient in the backward
    return x + (bits.view(torch.float32) - x).detach()


@contextlib.contextmanager
def tf32_emulated():
    """TF32's rounding of every linear layer's and convolution's inputs and
    weights, where no TF32 unit exists (the CPU tests)."""
    import torch.nn.functional as F

    saved = (F.linear, F.conv2d)
    linear, conv2d = saved

    def lin(x, w, b=None):
        return linear(round_tf32(x), round_tf32(w), b)

    def conv(x, w, b=None, *args, **kwargs):
        return conv2d(round_tf32(x), round_tf32(w), b, *args, **kwargs)

    F.linear, F.conv2d = lin, conv
    try:
        yield
    finally:
        F.linear, F.conv2d = saved
