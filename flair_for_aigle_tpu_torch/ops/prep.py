"""K1: fused swin-block prologue — LN + cyclic shift + pad + window
partition (CUDA kernel ``csrc/prep.cu``) and its plain PyTorch version.

Replaces ``flair_for_aigle_tpu/ops/pallas/prep.py:146
fused_ln_shift_partition``. On the card the op is bandwidth-bound (one read
of the activation, one write of the windows); the kernel resolves the
shift/pad/partition gather per output token and keeps each token's channels
in registers between the LayerNorm statistics and the write, so the
activation is read once and no shifted or padded copy exists.

Differentiable: the backward recomputes through the plain version from the
saved raw inputs, as the reference's ``custom_vjp`` does (``prep.py:137-141``).
"""

from __future__ import annotations

import torch

from flair_for_aigle_tpu_torch.ops import _build
from flair_for_aigle_tpu_torch.ops._vjp import plain_vjp


def _padded(n: int, ws: int) -> int:
    return n + (ws - n % ws) % ws


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C), windows row-major per image."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    x = x.reshape(-1, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, w, c)


def fused_ln_shift_partition_reference(x: torch.Tensor, ln_scale, ln_bias, *,
                                       ws: int, ss: int,
                                       eps: float = 1e-5) -> torch.Tensor:
    """Plain version: LN (float32 statistics) -> roll(-ss) -> zero pad ->
    window partition, in the Pallas body's order of operations."""
    b, h, w, c = x.shape
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = (y * ln_scale.float() + ln_bias.float()).to(x.dtype)
    if ss:
        y = torch.roll(y, (-ss, -ss), dims=(1, 2))
    hp, wp = _padded(h, ws), _padded(w, ws)
    if hp > h or wp > w:
        y = torch.nn.functional.pad(y, (0, 0, 0, wp - w, 0, hp - h))
    return window_partition(y, ws)


def _launch(x: torch.Tensor, ln_scale, ln_bias, ws: int, ss: int,
            eps: float) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_ln_shift_partition_reference(x, ln_scale, ln_bias, ws=ws,
                                                  ss=ss, eps=eps)
    b, h, w, c = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"prep kernel: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"prep kernel: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("prep kernel: input must be contiguous NHWC")
    if c > 1024 or not 0 <= ss < ws:
        raise ValueError(f"prep kernel: unsupported C={c}, ws={ws}, ss={ss}")
    scale = ln_scale.detach().to(x.device, torch.float32).contiguous()
    bias = ln_bias.detach().to(x.device, torch.float32).contiguous()
    if scale.numel() != c or bias.numel() != c:
        raise ValueError("prep kernel: LayerNorm params must have C entries")
    hp, wp = _padded(h, ws), _padded(w, ws)
    out = torch.empty((b * (hp // ws) * (wp // ws), ws * ws, c),
                      dtype=x.dtype, device=x.device)
    rc = _build.lib().prep_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, h, w, c, ws, ss, float(eps), _build.dtype_code(x),
        _build.stream_ptr(x))
    _build.check(rc, "prep_fwd")
    fused_ln_shift_partition.launches += 1
    return out


class _Prep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, ws, ss, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias)
        ctx.cfg = dict(ws=ws, ss=ss, eps=eps)
        return _launch(x, ln_scale, ln_bias, ws, ss, eps)

    @staticmethod
    def backward(ctx, g):
        grads = plain_vjp(
            lambda *a: fused_ln_shift_partition_reference(*a, **ctx.cfg),
            ctx.saved_tensors, g, ctx.needs_input_grad[:3])
        return (*grads, None, None, None)


def fused_ln_shift_partition(x: torch.Tensor, ln_scale, ln_bias, *, ws: int,
                             ss: int, eps: float = 1e-5) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C): LN + roll(-ss) + pad-to-window +
    window partition. CPU tensors take the plain version; CUDA tensors
    launch the kernel (float32 or bfloat16, contiguous NHWC, C <= 1024).
    Differentiable in x and the LayerNorm parameters."""
    return _Prep.apply(x, ln_scale, ln_bias, ws, ss, eps)


fused_ln_shift_partition.launches = 0
