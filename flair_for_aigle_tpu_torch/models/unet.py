"""smp U-Net decoder and segmentation head, NHWC PyTorch.

Port of ``flair_for_aigle_tpu/models/unet.py``: decoder_channels (256, 128,
64, 32, 16); each block is a nearest x2 upsample (torch's floor index,
``ops/resize.py resize_nearest_nhwc``), the skip concatenated, then two
Conv3x3 (no bias) + BN + ReLU. Module names are smp's
(``blocks.{i}.conv1.{0,1}``). The decoder takes the encoder's channel
pyramid at construction; a zero-channel skip (the transformer encoders'
stride-2 dummy) adds no input channels. Its head is a 3x3 conv at full
resolution (``layers.py SegmentationHead``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.layers import ConvBNReLU
from flair_for_aigle_tpu_torch.ops.resize import resize_nearest_nhwc


class UnetDecoderBlock(nn.Module):
    def __init__(self, in_ch: int, skip_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = ConvBNReLU(in_ch + skip_ch, out_ch, 3)
        self.conv2 = ConvBNReLU(out_ch, out_ch, 3)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None) -> torch.Tensor:
        x = resize_nearest_nhwc(x, x.shape[-3] * 2, x.shape[-2] * 2)
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        return self.conv2(self.conv1(x))


class UnetDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]  # identity dropped, deepest first
        skips = enc[1:]
        in_ch = [enc[0], *decoder_channels[:-1]]
        self.blocks = nn.ModuleList(
            UnetDecoderBlock(i, skips[k] if k < len(skips) else 0, o)
            for k, (i, o) in enumerate(zip(in_ch, decoder_channels)))

    def forward(self, *features, generator: torch.Generator | None = None) -> torch.Tensor:
        feats = list(features[1:])[::-1]
        x, skips = feats[0], feats[1:]
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
        return x
