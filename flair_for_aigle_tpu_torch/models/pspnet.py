"""PSPNet decoder (smp layout), NHWC PyTorch.

Port of ``flair_for_aigle_tpu/models/pspnet.py``. smp's PSPNet builds the
encoder at depth 3 (stem, layer1, layer2: deepest stride 8) and reads
``features[-1]`` only:

* a PSP module over pool sizes (1, 2, 3, 6): AdaptiveAvgPool2d -> Conv1x1
  + BN + ReLU (the size-1 branch has no BN, so its conv keeps a bias) ->
  align-corners bilinear back; branch width in // 4; the branches and the
  input concatenated;
* ``conv``: Conv1x1 (no bias) + BN + ReLU to 512, then a channel dropout
  of 0.2 in training only, drawn from the caller's generator.

The head (``layers.py SegmentationHead``) is a 3x3 conv and x8
align-corners bilinear.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.layers import ConvBNReLU, TorchBatchNorm, TorchConv, dropout
from flair_for_aigle_tpu_torch.ops.resize import adaptive_avg_pool_nhwc, resize_bilinear_ac_nhwc


class PSPBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, pool_size: int):
        super().__init__()
        self.pool_size = pool_size
        use_bn = pool_size != 1
        layers = [TorchConv(in_ch, out_ch, 1, 1, 0, bias=not use_bn)]
        if use_bn:
            layers.append(TorchBatchNorm(out_ch))
        self.pool = nn.Module()
        self.pool.add_module("1", nn.Sequential(*layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = adaptive_avg_pool_nhwc(x, self.pool_size, self.pool_size)
        y = torch.relu(getattr(self.pool, "1")(y))
        return resize_bilinear_ac_nhwc(y, x.shape[-3], x.shape[-2])


class PSPDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], out_channels: int = 512,
                 sizes: Sequence[int] = (1, 2, 3, 6), dropout: float = 0.2):
        super().__init__()
        in_ch = encoder_channels[-1]
        branch = in_ch // len(sizes)
        self.dropout = dropout
        self.psp = nn.Module()
        self.psp.blocks = nn.ModuleList(PSPBlock(in_ch, branch, s) for s in sizes)
        self.conv = ConvBNReLU(branch * len(sizes) + in_ch, out_channels)

    def forward(self, *features, generator: torch.Generator | None = None) -> torch.Tensor:
        x = features[-1]
        y = torch.cat([blk(x) for blk in self.psp.blocks] + [x], dim=-1)
        y = self.conv(y)
        return dropout(y, self.dropout, self.training, generator, channel_wise=True)
