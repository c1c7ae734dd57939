"""MAnet decoder (smp layout), NHWC PyTorch.

Port of ``flair_for_aigle_tpu/models/manet.py``:

* ``center``: PAB (position attention) on the deepest feature, with smp's
  two quirks kept — the attention map is softmaxed over the flattened
  (hw x hw) matrix, and the attended (B, hw, C) output is reshaped, not
  transposed, to (B, C, h, w) — then a residual add and a 3x3 ``out_conv``;
* ``blocks.{i}``: MFAB (multi-scale fusion attention) where a skip exists:
  ``hl_conv`` (Conv3x3+BN+ReLU, Conv1x1+BN+ReLU to the skip's width),
  nearest x2, the sum of two channel squeeze-excite gates (``SE_hl``,
  ``SE_ll``) on the upsampled branch, the skip concatenated, two
  Conv3x3+BN+ReLU; the last, skipless block is the U-Net block.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.layers import ConvBNReLU, TorchConv
from flair_for_aigle_tpu_torch.models.unet import UnetDecoderBlock
from flair_for_aigle_tpu_torch.ops.resize import resize_nearest_nhwc


class PAB(nn.Module):
    def __init__(self, ch: int, pab_channels: int = 64):
        super().__init__()
        self.top_conv = TorchConv(ch, pab_channels, 1, 1, 0)
        self.center_conv = TorchConv(ch, pab_channels, 1, 1, 0)
        self.bottom_conv = TorchConv(ch, ch, 3, 1, 1)
        self.out_conv = TorchConv(ch, ch, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        top = self.top_conv(x).reshape(b, h * w, -1)
        center = self.center_conv(x).reshape(b, h * w, -1)
        bottom = self.bottom_conv(x).reshape(b, h * w, c)
        sp = torch.einsum("bpk,bqk->bpq", center, top)
        sp = torch.softmax(sp.reshape(b, -1), dim=-1).reshape(b, h * w, h * w)
        att = torch.einsum("bpq,bqc->bpc", sp, bottom)
        att = att.reshape(b, c, h, w).permute(0, 2, 3, 1)
        return self.out_conv(x + att)


class _SE(nn.Module):
    """Sequential(pool, conv, ReLU, conv, Sigmoid): children ``1`` and ``3``."""

    def __init__(self, ch: int, reduction: int = 16):
        super().__init__()
        red = max(1, ch // reduction)
        self.add_module("1", TorchConv(ch, red, 1, 1, 0))
        self.add_module("3", TorchConv(red, ch, 1, 1, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean((1, 2), keepdim=True)
        y = torch.relu(getattr(self, "1")(y))
        return torch.sigmoid(getattr(self, "3")(y))


class MFAB(nn.Module):
    def __init__(self, in_ch: int, skip_ch: int, out_ch: int, reduction: int = 16):
        super().__init__()
        self.hl_conv = nn.Sequential(ConvBNReLU(in_ch, in_ch, 3), ConvBNReLU(in_ch, skip_ch))
        self.SE_hl = _SE(skip_ch, reduction)
        self.SE_ll = _SE(skip_ch, reduction)
        self.conv1 = ConvBNReLU(2 * skip_ch, out_ch, 3)
        self.conv2 = ConvBNReLU(out_ch, out_ch, 3)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.hl_conv(x)
        x = resize_nearest_nhwc(x, x.shape[-3] * 2, x.shape[-2] * 2)
        gate = self.SE_hl(x) + self.SE_ll(skip)
        x = torch.cat([x * gate, skip], dim=-1)
        return self.conv2(self.conv1(x))


class MAnetDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 pab_channels: int = 64, reduction: int = 16):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]
        self.center = PAB(enc[0], pab_channels)
        skips = enc[1:]
        blocks, in_ch = [], enc[0]
        for i, ch in enumerate(decoder_channels):
            blocks.append(MFAB(in_ch, skips[i], ch, reduction) if i < len(skips)
                          else UnetDecoderBlock(in_ch, 0, ch))
            in_ch = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, *features, generator: torch.Generator | None = None) -> torch.Tensor:
        feats = list(features[1:])[::-1]
        x, skips = self.center(feats[0]), feats[1:]
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i]) if i < len(skips) else block(x)
        return x
