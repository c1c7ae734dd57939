"""LinkNet decoder and head (smp layout), NHWC PyTorch.

Port of ``flair_for_aigle_tpu/models/linknet.py``: identity dropped,
deepest first; five blocks, each ``block`` = Sequential(Conv1x1 (no bias)
+ BN + ReLU, ConvTranspose 4x4 / stride 2 / padding 1 (bias) + BN + ReLU,
Conv1x1 (no bias) + BN + ReLU) with a bottleneck of in // 4 and the channel
plan reversed-encoder + [prefinal 32]; the skip is added after the block.
The head is a 1x1 conv at full resolution. The transposed convolutions sit
at ``...block.1.0`` (``LINKNET_TRANSPOSE_CONV_PATTERNS``, the checkpoint
rule's hint).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.layers import (
    ConvBNReLU,
    SequentialReLU,
    TorchBatchNorm,
    TorchConvTranspose,
)

LINKNET_TRANSPOSE_CONV_PATTERNS: Sequence[str] = (".block.1.0",)


class LinknetDecoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        mid = in_ch // 4
        self.block = nn.Sequential(
            ConvBNReLU(in_ch, mid),
            SequentialReLU(TorchConvTranspose(mid, mid, 4, 2, 1), TorchBatchNorm(mid)),
            ConvBNReLU(mid, out_ch))

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None) -> torch.Tensor:
        x = self.block(x)
        return x if skip is None else x + skip


class LinknetDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], prefinal_channels: int = 32,
                 n_blocks: int = 5):
        super().__init__()
        channels = list(encoder_channels[1:])[::-1] + [prefinal_channels]
        self.blocks = nn.ModuleList(LinknetDecoderBlock(channels[i], channels[i + 1])
                                    for i in range(n_blocks))

    def forward(self, *features, generator: torch.Generator | None = None) -> torch.Tensor:
        feats = list(features[1:])[::-1]
        x, skips = feats[0], feats[1:]
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
        return x
