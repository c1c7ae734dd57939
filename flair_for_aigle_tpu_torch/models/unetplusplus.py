"""U-Net++ (nested U-Net) decoder (smp ``UnetPlusPlusDecoder``), NHWC
PyTorch.

Port of ``flair_for_aigle_tpu/models/unetplusplus.py``: a dense grid of
U-Net decoder blocks ``blocks.x_{d}_{l}``. Along layer l, block
``x_{d}_{l}`` upsamples its predecessor ``x_{d}_{l-1}`` (or the raw feature
at depth d when d == l) and concatenates every same-column deeper output
``x_{d+1..l}_{l}`` and the raw skip feature. Row-0 blocks output
``decoder_channels[l]``, deeper ones the skip's channels, and the final
``x_0_{depth}`` has no skip. A transformer encoder's zero-channel dummy
makes some blocks zero-channel, as in smp.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.unet import UnetDecoderBlock


def _grid(n_layers: int):
    """(d, l, layer) of every inner block, in the reference's order."""
    for layer in range(n_layers):
        for d in range(n_layers - layer):
            yield d, d + layer, layer


class UnetPlusPlusDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]
        dec = list(decoder_channels)
        self.depth = depth = len(dec) - 1
        skip_ch = enc[1:] + [0]
        out: dict[str, int] = {}
        self.blocks = nn.ModuleDict()
        for d, li, layer in _grid(depth):
            if layer == 0:
                x_ch, s_ch = enc[d], enc[d + 1]
            else:
                x_ch = out[f"x_{d}_{li - 1}"]
                s_ch = sum(out[f"x_{i}_{li}"] for i in range(d + 1, li + 1)) + enc[li + 1]
            out[f"x_{d}_{li}"] = dec[li] if d == 0 else skip_ch[li]
            self.blocks[f"x_{d}_{li}"] = UnetDecoderBlock(x_ch, s_ch, out[f"x_{d}_{li}"])
        self.blocks[f"x_0_{depth}"] = UnetDecoderBlock(out[f"x_0_{depth - 1}"], 0, dec[depth])

    def forward(self, *features, generator: torch.Generator | None = None) -> torch.Tensor:
        feats = list(features[1:])[::-1]
        dense: dict[str, torch.Tensor] = {}
        for d, li, layer in _grid(self.depth):
            if layer == 0:
                x, skip = feats[d], feats[d + 1]
            else:
                x = dense[f"x_{d}_{li - 1}"]
                skip = torch.cat([dense[f"x_{i}_{li}"] for i in range(d + 1, li + 1)]
                                 + [feats[li + 1]], dim=-1)
            dense[f"x_{d}_{li}"] = self.blocks[f"x_{d}_{li}"](x, skip)
        return self.blocks[f"x_0_{self.depth}"](dense[f"x_0_{self.depth - 1}"])
