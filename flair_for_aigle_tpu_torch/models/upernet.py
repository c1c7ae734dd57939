"""UPerNet decoder + head (smp 0.4.0 layout), NHWC PyTorch.

Port of ``flair_for_aigle_tpu/models/upernet.py``: PSP on the deepest
feature (pools 1, 2, 3, 6 -> 1x1 Conv+BN+ReLU -> align-corners bilinear
back), FPN laterals with top-down nearest x2 + add, every pyramid level
resized (bilinear) to stride 4 and fused by a 3x3 Conv+BN+ReLU computed
concat-free, then the segmentation head (3x3 conv; x4 align-corners
bilinear unless ``upsampling=1``, the stride-4 mode that hands the logits
to the fused zonal epilogue; ``layers.py SegmentationHead``). Module names
mirror the smp state-dict keys.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.layers import ConvBNReLU
from flair_for_aigle_tpu_torch.ops.resize import (
    adaptive_avg_pool_nhwc,
    resize_bilinear_ac_nhwc,
    resize_bilinear_nhwc,
    resize_nearest_nhwc,
)


# identical param tree; the list-input mode lives in TorchConv
SplitInputConvBNReLU = ConvBNReLU


class PSPBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, pool_size: int):
        super().__init__()
        self.pool_size = pool_size
        self.pool = nn.Module()
        self.pool.add_module("1", ConvBNReLU(in_ch, out_ch, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-3], x.shape[-2]
        y = adaptive_avg_pool_nhwc(x, self.pool_size, self.pool_size)
        y = getattr(self.pool, "1")(y)
        return resize_bilinear_ac_nhwc(y, h, w)


class PSPModule(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, sizes: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        branch = in_ch // len(sizes)
        self.blocks = nn.ModuleList(PSPBlock(in_ch, branch, s) for s in sizes)
        self.out_conv = ConvBNReLU(branch * len(sizes) + in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [blk(x) for blk in self.blocks]
        return self.out_conv(torch.cat(ys + [x], dim=-1))


class FPNBlock(nn.Module):
    def __init__(self, skip_ch: int, pyramid_ch: int):
        super().__init__()
        self.skip_conv = ConvBNReLU(skip_ch, pyramid_ch, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        skip = self.skip_conv(skip)
        x = resize_nearest_nhwc(x, skip.shape[-3], skip.shape[-2])
        return x + skip


class UPerNetDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 pyramid_channels: int = 256, segmentation_channels: int = 64):
        super().__init__()
        chans = list(encoder_channels)[2:]  # drop input + zero-channel dummy
        self.psp = PSPModule(chans[-1], pyramid_channels)
        self.fpn_stages = nn.ModuleList(
            FPNBlock(c, pyramid_channels) for c in chans[:-1])
        self.fpn_bottleneck = SplitInputConvBNReLU(
            pyramid_channels * len(chans), segmentation_channels, 3)

    def forward(self, *features, generator: torch.Generator | None = None) -> torch.Tensor:
        feats = list(features[2:])
        fpn_features = [self.psp(feats[-1])]
        for i in range(len(feats) - 2, -1, -1):
            fpn_features.append(self.fpn_stages[i](fpn_features[-1], feats[i]))
        th, tw = feats[0].shape[-3], feats[0].shape[-2]
        resized = [resize_bilinear_nhwc(f, th, tw) for f in fpn_features]
        return self.fpn_bottleneck(resized)
