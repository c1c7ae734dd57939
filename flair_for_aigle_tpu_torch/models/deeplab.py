"""DeepLabV3 and DeepLabV3+ decoders (smp layout), NHWC PyTorch.

Port of ``flair_for_aigle_tpu/models/deeplab.py``. smp dilates the encoder
to output stride 16 (V3+) or 8 (V3), then:

* ``ASPP``: five branches in ``convs`` — a 1x1 Conv+BN+ReLU, three atrous
  3x3 at rates (12, 24, 36) (separable for V3+, plain for V3), and a
  pooling branch (float32 global mean -> 1x1 Conv+BN+ReLU -> bilinear back
  without align corners); concatenated, ``project`` 1x1 Conv+BN+ReLU, then
  an element-wise dropout of 0.5 in training only, drawn from the caller's
  generator;
* V3+: ``aspp.1`` separable 3x3 + ``aspp.2`` BN + ReLU, x4 align-corners
  bilinear (x2 at output stride 8), ``block1`` 1x1 Conv+BN+ReLU to 48 on
  ``features[-4]``, concatenated, ``block2`` separable 3x3 + BN + ReLU;
* V3: ``decoder.{0,1,2}`` = ASPP, Conv3x3 (no bias), BN, ReLU.

``SeparableConv2d`` is Sequential(depthwise no bias, pointwise), children
``0`` and ``1``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.layers import (
    ConvBNReLU,
    SequentialReLU,
    TorchBatchNorm,
    TorchConv,
    dropout,
)
from flair_for_aigle_tpu_torch.ops.resize import resize_bilinear_ac_nhwc, resize_bilinear_nhwc


class SeparableConv2d(nn.Sequential):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, padding: int = 1,
                 dilation: int = 1, bias: bool = True):
        super().__init__(
            TorchConv(in_ch, in_ch, kernel_size, 1, padding, bias=False,
                      dilation=dilation, groups=in_ch),
            TorchConv(in_ch, out_ch, 1, 1, 0, bias=bias))


def sep_bn_relu(in_ch: int, out_ch: int, dilation: int = 1) -> SequentialReLU:
    return SequentialReLU(SeparableConv2d(in_ch, out_ch, 3, dilation, dilation, bias=False),
                          TorchBatchNorm(out_ch))


def atrous_bn_relu(in_ch: int, out_ch: int, dilation: int = 1) -> SequentialReLU:
    return SequentialReLU(TorchConv(in_ch, out_ch, 3, 1, dilation, bias=False,
                                    dilation=dilation), TorchBatchNorm(out_ch))


class _Pooling(nn.Module):
    """The ASPP pooling branch: Sequential(pool, conv, BN) -> children 1, 2."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.add_module("1", TorchConv(in_ch, out_ch, 1, 1, 0, bias=False))
        self.add_module("2", TorchBatchNorm(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = x.float().mean((1, 2), keepdim=True).to(x.dtype)
        p = torch.relu(getattr(self, "2")(getattr(self, "1")(p)))
        return resize_bilinear_nhwc(p, x.shape[-3], x.shape[-2])


class ASPP(nn.Module):
    def __init__(self, in_ch: int, out_ch: int = 256,
                 atrous_rates: Sequence[int] = (12, 24, 36), separable: bool = True):
        super().__init__()
        atrous = sep_bn_relu if separable else atrous_bn_relu
        self.convs = nn.ModuleList([ConvBNReLU(in_ch, out_ch)]
                                   + [atrous(in_ch, out_ch, r) for r in atrous_rates]
                                   + [_Pooling(in_ch, out_ch)])
        self.project = ConvBNReLU(out_ch * len(self.convs), out_ch)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        y = self.project(torch.cat([c(x) for c in self.convs], dim=-1))
        return dropout(y, 0.5, self.training, generator)


class DeepLabV3PlusDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int], out_channels: int = 256,
                 atrous_rates: Sequence[int] = (12, 24, 36), output_stride: int = 16):
        super().__init__()
        self.scale = 2 if output_stride == 8 else 4
        # the outer aspp Sequential is flat: ASPP at .0, separable at .1, BN at .2
        self.aspp = nn.ModuleList([
            ASPP(encoder_channels[-1], out_channels, atrous_rates),
            SeparableConv2d(out_channels, out_channels, 3, 1, bias=False),
            TorchBatchNorm(out_channels)])
        self.block1 = ConvBNReLU(encoder_channels[-4], 48)
        self.block2 = sep_bn_relu(out_channels + 48, out_channels)

    def forward(self, *features, generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.aspp[0](features[-1], generator)
        x = torch.relu(self.aspp[2](self.aspp[1](x)))
        x = resize_bilinear_ac_nhwc(x, x.shape[-3] * self.scale, x.shape[-2] * self.scale)
        hi = self.block1(features[-4])
        return self.block2(torch.cat([x, hi], dim=-1))


class DeepLabV3Decoder(nn.Module):
    """``decoder.{0,1,2}``: ASPP (not separable), Conv3x3 no bias, BN; ReLU."""

    def __init__(self, encoder_channels: Sequence[int], out_channels: int = 256,
                 atrous_rates: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.add_module("0", ASPP(encoder_channels[-1], out_channels, atrous_rates,
                                  separable=False))
        self.add_module("1", TorchConv(out_channels, out_channels, 3, 1, 1, bias=False))
        self.add_module("2", TorchBatchNorm(out_channels))

    def forward(self, *features, generator: torch.Generator | None = None) -> torch.Tensor:
        x = getattr(self, "0")(features[-1], generator)
        return torch.relu(getattr(self, "2")(getattr(self, "1")(x)))
