"""FPN decoder and head (smp layout), NHWC PyTorch.

Port of ``flair_for_aigle_tpu/models/fpn.py``:

* ``p5``: 1x1 conv (bias) on the deepest feature to the pyramid width;
  ``p4`` / ``p3`` / ``p2``: nearest x2 top-down (torch's floor index) plus
  a 1x1 ``skip_conv`` lateral;
* ``seg_blocks.{0..3}`` over [p5, p4, p3, p2] with 3, 2, 1, 0 upsamples:
  Conv3x3 (no bias) + GroupNorm(32) + ReLU blocks, each but a 0-upsample
  one followed by an align-corners bilinear x2;
* the four stride-4 maps summed, then a channel dropout (torch
  ``Dropout2d(0.2)``) in training only, drawn from the caller's generator;
* the head (``layers.py SegmentationHead``): a 1x1 conv, then x4
  align-corners bilinear.

Only the last four features are read, so a zero-channel dummy never
reaches it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.layers import TorchConv, TorchGroupNorm, dropout
from flair_for_aigle_tpu_torch.ops.resize import resize_bilinear_ac_nhwc, resize_nearest_nhwc


class Conv3x3GNReLU(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, upsample: bool = False):
        super().__init__()
        self.upsample = upsample
        self.block = nn.Sequential(TorchConv(in_ch, out_ch, 3, 1, 1, bias=False),
                                   TorchGroupNorm(32, out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.block(x))
        if self.upsample:
            y = resize_bilinear_ac_nhwc(y, y.shape[-3] * 2, y.shape[-2] * 2)
        return y


class SegmentationBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n_upsamples: int = 0):
        super().__init__()
        blocks = [Conv3x3GNReLU(in_ch, out_ch, upsample=n_upsamples > 0)]
        blocks += [Conv3x3GNReLU(out_ch, out_ch, upsample=True)
                   for _ in range(1, n_upsamples)]
        self.block = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class FPNLateralBlock(nn.Module):
    """smp FPNBlock: nearest x2 on the top-down path + 1x1 lateral add."""

    def __init__(self, skip_ch: int, pyramid_ch: int):
        super().__init__()
        self.skip_conv = TorchConv(skip_ch, pyramid_ch, 1, 1, 0)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = resize_nearest_nhwc(x, skip.shape[-3], skip.shape[-2])
        return x + self.skip_conv(skip)


class FPNDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], pyramid_channels: int = 256,
                 segmentation_channels: int = 128, dropout: float = 0.2):
        super().__init__()
        c2, c3, c4, c5 = list(encoder_channels)[-4:]
        self.dropout = dropout
        self.p5 = TorchConv(c5, pyramid_channels, 1, 1, 0)
        self.p4 = FPNLateralBlock(c4, pyramid_channels)
        self.p3 = FPNLateralBlock(c3, pyramid_channels)
        self.p2 = FPNLateralBlock(c2, pyramid_channels)
        self.seg_blocks = nn.ModuleList(
            SegmentationBlock(pyramid_channels, segmentation_channels, n)
            for n in (3, 2, 1, 0))

    def forward(self, *features, generator: torch.Generator | None = None) -> torch.Tensor:
        c2, c3, c4, c5 = features[-4:]
        p5 = self.p5(c5)
        p4 = self.p4(p5, c4)
        p3 = self.p3(p4, c3)
        p2 = self.p2(p3, c2)
        pyramid = [blk(p) for blk, p in zip(self.seg_blocks, (p5, p4, p3, p2))]
        y = pyramid[0] + pyramid[1] + pyramid[2] + pyramid[3]
        return dropout(y, self.dropout, self.training, generator, channel_wise=True)
