"""PAN (Pyramid Attention Network) decoder (smp layout), NHWC PyTorch.

Port of ``flair_for_aigle_tpu/models/pan.py`` (smp dilates the encoder to
output stride 16):

* ``fpa``: Feature Pyramid Attention on the deepest feature — a global
  pooling branch (mean -> ConvBnRelu 1x1 -> align-corners bilinear), a
  ``mid`` 1x1 branch, and a three-level single-channel pyramid (max pool 2
  + ConvBnRelu k7 -> k5 -> two k3) recombined bottom-up with align-corners
  bilinear, multiplied into ``mid``, plus the global branch;
* ``gau3`` / ``gau2`` / ``gau1``: Global Attention Upsample — a 3x3
  ConvBnRelu on the low-level feature gated by a sigmoid of the high-level
  one's pooled ConvBn, added to the upsampled high-level map.

ConvBnRelu is a conv with bias + BN (+ ReLU), children ``conv`` / ``bn``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.layers import TorchBatchNorm, TorchConv, max_pool2d
from flair_for_aigle_tpu_torch.ops.resize import resize_bilinear_ac_nhwc


class ConvBnRelu(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1, padding: int = 0,
                 add_relu: bool = True):
        super().__init__()
        self.add_relu = add_relu
        self.conv = TorchConv(in_ch, out_ch, kernel_size, 1, padding)
        self.bn = TorchBatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(self.conv(x))
        return torch.relu(y) if self.add_relu else y


def _at(module: nn.Module) -> nn.Module:
    """A holder with ``module`` as child ``1`` (smp's Sequential(pool, ...))."""
    holder = nn.Module()
    holder.add_module("1", module)
    return holder


class FPABlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.branch1 = _at(ConvBnRelu(in_ch, out_ch, 1))
        self.mid = nn.Sequential(ConvBnRelu(in_ch, out_ch, 1))
        self.down1 = _at(ConvBnRelu(in_ch, 1, 7, 3))
        self.down2 = _at(ConvBnRelu(1, 1, 5, 2))
        self.down3 = _at(ConvBnRelu(1, 1, 3, 1))
        self.down3.add_module("2", ConvBnRelu(1, 1, 3, 1))
        self.conv2 = ConvBnRelu(1, 1, 5, 2)
        self.conv1 = ConvBnRelu(1, 1, 7, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-3], x.shape[-2]
        b1 = getattr(self.branch1, "1")(x.mean((1, 2), keepdim=True))
        b1 = resize_bilinear_ac_nhwc(b1, h, w)
        mid = self.mid(x)
        x1 = getattr(self.down1, "1")(max_pool2d(x, 2, 2, 0))
        x2 = getattr(self.down2, "1")(max_pool2d(x1, 2, 2, 0))
        x3 = getattr(self.down3, "1")(max_pool2d(x2, 2, 2, 0))
        x3 = resize_bilinear_ac_nhwc(getattr(self.down3, "2")(x3), h // 4, w // 4)
        x2 = self.conv2(x2)
        y = resize_bilinear_ac_nhwc(x2 + x3, h // 2, w // 2)
        x1 = self.conv1(x1)
        y = resize_bilinear_ac_nhwc(y + x1, h, w)
        return y * mid + b1


class GAUBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = _at(ConvBnRelu(out_ch, out_ch, 1, add_relu=False))
        self.conv2 = ConvBnRelu(in_ch, out_ch, 3, 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x: the low-level feature; y: the high-level one."""
        y_up = resize_bilinear_ac_nhwc(y, x.shape[-3], x.shape[-2])
        x = self.conv2(x)
        g = getattr(self.conv1, "1")(y.mean((1, 2), keepdim=True))
        return y_up + x * torch.sigmoid(g)


class PANDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], decoder_channels: int = 32):
        super().__init__()
        enc = list(encoder_channels)
        self.fpa = FPABlock(enc[-1], decoder_channels)
        self.gau3 = GAUBlock(enc[-2], decoder_channels)
        self.gau2 = GAUBlock(enc[-3], decoder_channels)
        self.gau1 = GAUBlock(enc[-4], decoder_channels)

    def forward(self, *features, generator: torch.Generator | None = None) -> torch.Tensor:
        x5 = self.fpa(features[-1])
        x4 = self.gau3(features[-2], x5)
        x3 = self.gau2(features[-3], x4)
        return self.gau1(features[-4], x3)
