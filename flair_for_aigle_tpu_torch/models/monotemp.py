"""Monotemporal model factory (the smp ``create_model`` equivalent), swin +
UPerNet family.

Port of ``flair_for_aigle_tpu/models/monotemp.py`` for the zonal main
path's architecture family: ``swin_<size>_patch<p>_window<w>_<res>-upernet``.
The other encoder and decoder families raise ``NotImplementedError`` (ROADMAP
Queue A item 10). Module names mirror the reference checkpoint keys; smp's
TimmUniversalEncoder nests the timm backbone under ``model.``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.swin import SwinTransformerEncoder
from flair_for_aigle_tpu_torch.models.upernet import (
    UPerNetDecoder,
    UPerNetSegmentationHead,
)

# timm Swin-v1 size table: size tag -> (embed_dim, depths, num_heads).
_SWIN_SIZES = {
    # 'micro' is NOT a timm release: a test-scale tag (embed_dim 128, one
    # block per stage) so CPU parity tests run at tractable cost.
    "micro": (128, (1, 1, 1, 1), (4, 8, 16, 32)),
    "tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "small": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "base": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
    "large": (192, (2, 2, 18, 2), (6, 12, 24, 48)),
}
_SWIN_NAME_RE = re.compile(r"swin_([a-z]+)_patch(\d+)_window(\d+)_(\d+)")

_NOT_PORTED = ("not ported to flair_for_aigle_tpu_torch yet (ROADMAP Queue A "
               "item 10: other encoder and decoder families)")


def swin_spec(encoder_name: str):
    """(embed_dim, depths, heads, window, patch) for a timm swin v1 name,
    else None."""
    m = _SWIN_NAME_RE.fullmatch(encoder_name)
    if not m or m.group(1) not in _SWIN_SIZES:
        return None
    ed, depths, heads = _SWIN_SIZES[m.group(1)]
    return ed, depths, heads, int(m.group(3)), int(m.group(2))


def _strip_tu(encoder_name: str) -> str:
    return encoder_name[3:] if encoder_name.startswith("tu-") else encoder_name


def encoder_out_channels(encoder_name: str, in_channels: int) -> tuple[int, ...]:
    spec = swin_spec(_strip_tu(encoder_name))
    if spec is None:
        raise NotImplementedError(f"encoder '{encoder_name}' {_NOT_PORTED}")
    ed, depths = spec[0], spec[1]
    return (in_channels, 0, *[ed * 2 ** i for i in range(len(depths))])


class TimmUniversalEncoder(nn.Module):
    """smp's timm wrapper: backbone params under a ``model.`` sub-level."""

    def __init__(self, encoder_name: str, in_channels: int,
                 attn_f32: bool = True):
        super().__init__()
        spec = swin_spec(_strip_tu(encoder_name))
        if spec is None:
            raise NotImplementedError(f"encoder '{encoder_name}' {_NOT_PORTED}")
        ed, depths, heads, win, patch = spec
        self.model = SwinTransformerEncoder(
            in_channels=in_channels, embed_dim=ed, depths=depths,
            num_heads=heads, window_size=win, patch_size=patch,
            attn_f32=attn_f32)

    @property
    def out_channels(self) -> tuple[int, ...]:
        return self.model.out_channels

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return self.model(x)


def make_encoder(encoder_name: str, in_channels: int,
                 attn_f32: bool = True) -> nn.Module:
    return TimmUniversalEncoder(encoder_name, in_channels, attn_f32=attn_f32)


class MonotempDecoder(nn.Module):
    """``FLAIR_Monotemp(return_type='decoder')`` (decoder -> head).
    ``head_upsampling=1`` emits stride-4 logits for the fused epilogue."""

    def __init__(self, decoder_name: str, encoder_channels, classes: int,
                 head_upsampling: int = 4):
        super().__init__()
        if decoder_name != "upernet":
            raise NotImplementedError(f"decoder '{decoder_name}' {_NOT_PORTED}")
        self.decoder = UPerNetDecoder(encoder_channels)
        self.segmentation_head = UPerNetSegmentationHead(
            64, classes, upsampling=head_upsampling)

    def forward(self, *features) -> torch.Tensor:
        return self.segmentation_head(self.decoder(*features))


@dataclass
class MonotempSpec:
    encoder_name: str
    decoder_name: str

    @classmethod
    def from_arch(cls, arch: str) -> "MonotempSpec":
        enc, dec = arch.rsplit("-", 1)
        return cls(enc, dec)
