"""EfficientNet (MBConv) encoders (timm layout), NHWC PyTorch.

Port of ``flair_for_aigle_tpu/models/efficientnet.py``. Module names are
timm's (``conv_stem``, ``bn1``, ``blocks.{stage}.{j}``; DS blocks
``conv_dw/bn1/se/conv_pw/bn2``, IR blocks ``conv_pw/bn1/conv_dw/bn2/se/
conv_pwl/bn3``, SE ``se.conv_reduce/conv_expand``). Channels scale by the
width multiplier through ``_make_divisible`` (divisor 8, round limit 0.9),
repeats by ``ceil(r * depth_mult)``; the SE width is round(block input *
0.25). Native (not ``tf_``) variants: symmetric k // 2 padding, BN eps
1e-5, SiLU. The forward returns smp's pyramid ``[x, s2, s4, s8, s16,
s32]``, each the output of the last stage at that reduction. ``remat=True``
recomputes each DS / IR block in the backward (``models/layers.py remat``,
JAX ``efficientnet.py:190-191``), in training mode only; the recompute
leaves the BatchNorm running statistics as the forward set them.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from flair_for_aigle_tpu_torch.models.layers import (
    TorchBatchNorm,
    TorchConv,
    remat,
    remat_active,
)

# b0 stage specs: (kernel, stride, expansion, channels, repeats)
_BASE_STAGES = (
    (3, 1, 1, 16, 1),
    (3, 2, 6, 24, 2),
    (5, 2, 6, 40, 2),
    (3, 2, 6, 80, 3),
    (5, 1, 6, 112, 3),
    (5, 2, 6, 192, 4),
    (3, 1, 6, 320, 1),
)
_BASE_STEM = 32

# variant -> (width_mult, depth_mult); timm efficientnet_b{0..7}
_VARIANTS = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
    "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
}

# 'micro' is NOT a timm release: a test-scale spec (narrow, one block per
# stage but one) so CPU parity tests run at tractable cost.
_MICRO_STEM = 8
_MICRO_STAGES = (
    (3, 1, 1, 8, 1),
    (3, 2, 6, 16, 1),
    (5, 2, 6, 24, 1),
    (3, 2, 6, 32, 1),
    (5, 1, 6, 40, 2),  # two repeats: the in == out residual path
    (5, 2, 6, 48, 1),
    (3, 1, 6, 64, 1),
)


def _make_divisible(v: float, divisor: int = 8, round_limit: float = 0.9) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < round_limit * v:
        new_v += divisor
    return new_v


def _round_channels(c: int, mult: float) -> int:
    return c if mult == 1.0 else _make_divisible(c * mult)


def efficientnet_spec(variant: str):
    """(stem channels, stage specs) for a variant tag, else None."""
    if variant == "micro":
        return _MICRO_STEM, _MICRO_STAGES
    if variant not in _VARIANTS:
        return None
    w, d = _VARIANTS[variant]
    stages = tuple((k, s, e, _round_channels(c, w), int(math.ceil(r * d)))
                   for (k, s, e, c, r) in _BASE_STAGES)
    return _round_channels(_BASE_STEM, w), stages


def _tap_indices(stages) -> tuple[int, ...]:
    """The stages whose outputs are the s2 ... s32 features: the last stage
    at each cumulative reduction."""
    taps, red = {}, 2  # the stem's stride
    for i, (_k, s, _e, _c, _r) in enumerate(stages):
        red *= s
        taps[red] = i
    return tuple(taps[r] for r in sorted(taps))


class SqueezeExcite(nn.Module):
    """float32 mean pool -> conv_reduce -> SiLU -> conv_expand -> sigmoid
    gate."""

    def __init__(self, ch: int, rd: int):
        super().__init__()
        self.conv_reduce = TorchConv(ch, rd, 1, 1, 0)
        self.conv_expand = TorchConv(rd, ch, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean((1, 2), keepdim=True).to(x.dtype)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class DsBlock(nn.Module):
    """timm DepthwiseSeparableConv: conv_dw -> bn1 -> SiLU -> SE -> conv_pw
    -> bn2; the residual when stride 1 and the widths match."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int):
        super().__init__()
        self.residual = stride == 1 and in_ch == out_ch
        self.conv_dw = TorchConv(in_ch, in_ch, kernel, stride, kernel // 2, bias=False,
                                 groups=in_ch)
        self.bn1 = TorchBatchNorm(in_ch)
        self.se = SqueezeExcite(in_ch, max(1, round(in_ch * 0.25)))
        self.conv_pw = TorchConv(in_ch, out_ch, 1, 1, 0, bias=False)
        self.bn2 = TorchBatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.se(F.silu(self.bn1(self.conv_dw(x))))
        y = self.bn2(self.conv_pw(y))
        return y + x if self.residual else y


class IrBlock(nn.Module):
    """timm InvertedResidual: conv_pw (expand) -> bn1 -> SiLU -> conv_dw ->
    bn2 -> SiLU -> SE -> conv_pwl -> bn3; the residual as DsBlock's."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, expand: int):
        super().__init__()
        mid = in_ch * expand
        self.residual = stride == 1 and in_ch == out_ch
        self.conv_pw = TorchConv(in_ch, mid, 1, 1, 0, bias=False)
        self.bn1 = TorchBatchNorm(mid)
        self.conv_dw = TorchConv(mid, mid, kernel, stride, kernel // 2, bias=False,
                                 groups=mid)
        self.bn2 = TorchBatchNorm(mid)
        self.se = SqueezeExcite(mid, max(1, round(in_ch * 0.25)))
        self.conv_pwl = TorchConv(mid, out_ch, 1, 1, 0, bias=False)
        self.bn3 = TorchBatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.bn1(self.conv_pw(x)))
        y = self.se(F.silu(self.bn2(self.conv_dw(y))))
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.residual else y


class EfficientNetEncoder(nn.Module):
    def __init__(self, in_channels: int = 3, stem_channels: int = _BASE_STEM,
                 stages: Sequence[tuple[int, int, int, int, int]] = _BASE_STAGES,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.taps = _tap_indices(stages)
        self.out_channels = (in_channels, *(stages[i][3] for i in self.taps))
        self.conv_stem = TorchConv(in_channels, stem_channels, 3, 2, 1, bias=False)
        self.bn1 = TorchBatchNorm(stem_channels)
        self.blocks = nn.ModuleList()
        ch = stem_channels
        for k, s, e, c, r in stages:
            blocks = []
            for j in range(r):
                stride = s if j == 0 else 1
                blocks.append(DsBlock(ch, c, k, stride) if e == 1
                              else IrBlock(ch, c, k, stride, e))
                ch = c
            self.blocks.append(nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = [x]
        y = F.silu(self.bn1(self.conv_stem(x)))
        rm = remat_active(self, self.remat)
        for i, stage in enumerate(self.blocks):
            if rm:
                for block in stage:
                    y = remat(block, y)
            else:
                y = stage(y)
            if i in self.taps:
                feats.append(y)
        return feats
