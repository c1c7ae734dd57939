"""Monotemporal model factory (the smp ``create_model`` equivalent).

Port of ``flair_for_aigle_tpu/models/monotemp.py``: the arch string
``"<encoder>-<decoder>"`` (``resnet34-unet``,
``swin_base_patch4_window12_384-upernet``, ``convnext_base-fpn`` ...)
selects an encoder tower and a decoder + segmentation head.

* Encoders: resnet18/34/50/101 (flat torchvision keys), timm Swin v1
  (``swin_<size>_patch<p>_window<w>_<res>``), timm ConvNeXt v1
  (``convnext_<size>``) and timm EfficientNet (``efficientnet_b0`` ..
  ``b7``); the timm ones sit under smp's TimmUniversalEncoder ``model.``
  level. A ``tu-`` prefix is accepted and stripped; the test-scale tag
  ``micro`` exists for Swin, ConvNeXt and EfficientNet.
* Decoders: unet, unetplusplus, upernet, fpn, deeplabv3plus, deeplabv3,
  linknet, manet, pan, pspnet. Each is built from the encoder's channel
  pyramid. DeepLabV3+ and PAN dilate the encoder to output stride 16,
  DeepLabV3 to 8; PSPNet truncates it to depth 3. Only the ResNet encoders
  dilate or truncate; the others raise ``ValueError`` as the reference.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.convnext import ConvNeXtEncoder
from flair_for_aigle_tpu_torch.models.deeplab import DeepLabV3Decoder, DeepLabV3PlusDecoder
from flair_for_aigle_tpu_torch.models.efficientnet import (
    EfficientNetEncoder,
    _tap_indices,
    efficientnet_spec,
)
from flair_for_aigle_tpu_torch.models.fpn import FPNDecoder
from flair_for_aigle_tpu_torch.models.layers import SegmentationHead
from flair_for_aigle_tpu_torch.models.linknet import LinknetDecoder
from flair_for_aigle_tpu_torch.models.manet import MAnetDecoder
from flair_for_aigle_tpu_torch.models.pan import PANDecoder
from flair_for_aigle_tpu_torch.models.pspnet import PSPDecoder
from flair_for_aigle_tpu_torch.models.resnet import (
    _RESNET_SPECS,
    ResNetEncoder,
    resnet_out_channels,
)
from flair_for_aigle_tpu_torch.models.swin import SwinTransformerEncoder
from flair_for_aigle_tpu_torch.models.unet import UnetDecoder
from flair_for_aigle_tpu_torch.models.unetplusplus import UnetPlusPlusDecoder
from flair_for_aigle_tpu_torch.models.upernet import UPerNetDecoder

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

# timm ConvNeXt v1 size table: size tag -> (dims, depths); a pretrained-tag
# suffix (``.fb_in22k``) names weights, not architecture.
_CONVNEXT_SIZES = {
    # 'micro' is NOT a timm release: a test-scale tag (one block per stage).
    "micro": ((16, 32, 64, 128), (1, 1, 1, 1)),
    "tiny": ((96, 192, 384, 768), (3, 3, 9, 3)),
    "small": ((96, 192, 384, 768), (3, 3, 27, 3)),
    "base": ((128, 256, 512, 1024), (3, 3, 27, 3)),
    "large": ((192, 384, 768, 1536), (3, 3, 27, 3)),
    "xlarge": ((256, 512, 1024, 2048), (3, 3, 27, 3)),
}
_CONVNEXT_NAME_RE = re.compile(r"convnext_([a-z]+)(?:\..+)?")
_EFFNET_NAME_RE = re.compile(r"efficientnet_(b\d|micro)(?:\..+)?")

# decoder -> the encoder's output stride and depth it asks for
_ENCODER_MODE = {"deeplabv3plus": (16, 5), "deeplabv3": (8, 5), "pan": (16, 5),
                 "pspnet": (32, 3)}


def swin_spec(encoder_name: str):
    """(embed_dim, depths, heads, window, patch) for a timm swin v1 name,
    else None."""
    m = _SWIN_NAME_RE.fullmatch(encoder_name)
    if not m or m.group(1) not in _SWIN_SIZES:
        return None
    ed, depths, heads = _SWIN_SIZES[m.group(1)]
    return ed, depths, heads, int(m.group(3)), int(m.group(2))


def convnext_spec(encoder_name: str):
    """(dims, depths) for a timm convnext v1 name, else None."""
    m = _CONVNEXT_NAME_RE.fullmatch(encoder_name)
    if not m or m.group(1) not in _CONVNEXT_SIZES:
        return None
    return _CONVNEXT_SIZES[m.group(1)]


def effnet_spec(encoder_name: str):
    """(stem channels, stage specs) for a timm efficientnet name, else None."""
    m = _EFFNET_NAME_RE.fullmatch(encoder_name)
    return efficientnet_spec(m.group(1)) if m else None


def _strip_tu(encoder_name: str) -> str:
    return encoder_name[3:] if encoder_name.startswith("tu-") else encoder_name


def _unknown_encoder_error(encoder_name: str) -> ValueError:
    return ValueError(
        f"Unknown encoder '{encoder_name}'. Supported families: "
        f"resnet ({', '.join(sorted(_RESNET_SPECS))}), timm swin v1 "
        f"(any 'swin_<size>_patch<p>_window<w>_<res>' with size in "
        f"{sorted(_SWIN_SIZES)}), timm convnext v1 "
        f"('convnext_<size>' with size in {sorted(_CONVNEXT_SIZES)}) and "
        f"timm efficientnet ('efficientnet_b0'..'b7'); "
        f"a 'tu-' prefix is accepted and stripped.")


def encoder_mode(decoder_name: str) -> tuple[int, int]:
    """(output_stride, depth) the decoder asks of its encoder."""
    return _ENCODER_MODE.get(decoder_name, (32, 5))


def encoder_out_channels(encoder_name: str, in_channels: int) -> tuple[int, ...]:
    """The pyramid's channels of the encoder at output stride 32, depth 5."""
    name = _strip_tu(encoder_name)
    if name in _RESNET_SPECS:
        return resnet_out_channels(name, in_channels)
    spec = swin_spec(name)
    if spec is not None:
        ed, depths = spec[0], spec[1]
        return (in_channels, 0, *[ed * 2 ** i for i in range(len(depths))])
    cspec = convnext_spec(name)
    if cspec is not None:
        return (in_channels, 0, *cspec[0])
    espec = effnet_spec(name)
    if espec is not None:
        stages = espec[1]
        return (in_channels, *(stages[i][3] for i in _tap_indices(stages)))
    raise _unknown_encoder_error(name)


class TimmUniversalEncoder(nn.Module):
    """smp's timm wrapper: backbone params under a ``model.`` sub-level."""

    def __init__(self, encoder_name: str, in_channels: int,
                 attn_f32: bool = True, remat: bool = False):
        super().__init__()
        name = _strip_tu(encoder_name)
        spec, cspec, espec = swin_spec(name), convnext_spec(name), effnet_spec(name)
        if spec is not None:
            ed, depths, heads, win, patch = spec
            self.model = SwinTransformerEncoder(
                in_channels=in_channels, embed_dim=ed, depths=depths,
                num_heads=heads, window_size=win, patch_size=patch,
                attn_f32=attn_f32, remat=remat)
        elif cspec is not None:
            self.model = ConvNeXtEncoder(in_channels, *cspec, remat=remat)
        elif espec is not None:
            self.model = EfficientNetEncoder(in_channels, *espec, remat=remat)
        else:
            raise _unknown_encoder_error(encoder_name)

    @property
    def out_channels(self) -> tuple[int, ...]:
        return self.model.out_channels

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return self.model(x)


def make_encoder(encoder_name: str, in_channels: int, attn_f32: bool = True,
                 output_stride: int = 32, depth: int = 5, remat: bool = False) -> nn.Module:
    """Encoder with smp's internal naming. ``output_stride`` < 32 (smp's
    make_dilated) and ``depth`` < 5 (a truncated encoder) are ResNet's
    only; the timm encoders raise ``ValueError`` as smp's does. ``remat``
    (per-block recompute in training) reaches the timm encoders only, as
    in the JAX package: ResNet takes none."""
    name = _strip_tu(encoder_name)
    if name in _RESNET_SPECS:
        return ResNetEncoder(name, in_channels, output_stride=output_stride, depth=depth)
    if swin_spec(name) or convnext_spec(name) or effnet_spec(name):
        if output_stride != 32:
            raise ValueError(
                f"encoder '{name}' does not support dilated mode "
                f"(output_stride={output_stride}); DeepLabV3+ needs a resnet encoder")
        if depth != 5:
            raise ValueError(
                f"encoder '{name}' does not support encoder_depth={depth}; "
                f"PSPNet needs a resnet encoder")
        return TimmUniversalEncoder(name, in_channels, attn_f32=attn_f32, remat=remat)
    raise _unknown_encoder_error(name)


# decoder -> (its class, the head's input channels, kernel, upsampling)
_DECODERS = {
    "unet": (UnetDecoder, 16, 3, 1),
    "unetplusplus": (UnetPlusPlusDecoder, 16, 3, 1),
    "upernet": (UPerNetDecoder, 64, 3, 4),
    "fpn": (FPNDecoder, 128, 1, 4),
    "deeplabv3plus": (DeepLabV3PlusDecoder, 256, 1, 4),
    "deeplabv3": (DeepLabV3Decoder, 256, 1, 8),
    "linknet": (LinknetDecoder, 32, 1, 1),
    "manet": (MAnetDecoder, 16, 3, 1),
    "pan": (PANDecoder, 32, 3, 4),
    "pspnet": (PSPDecoder, 512, 3, 8),
}


class MonotempDecoder(nn.Module):
    """``FLAIR_Monotemp(return_type='decoder')``: smp's ``decoder_name``
    built on the encoder's channel pyramid, then its segmentation head.
    ``head_upsampling=1`` makes the UPerNet head emit stride-4 logits for
    the fused zonal epilogue. Every decoder takes the training step's
    generator; FPN, PSPNet and the DeepLabs draw their dropout from it."""

    def __init__(self, decoder_name: str, encoder_channels, classes: int,
                 head_upsampling: int = 4):
        super().__init__()
        if decoder_name not in _DECODERS:
            raise ValueError(f"Unknown decoder: {decoder_name}")
        cls, head_ch, kernel, up = _DECODERS[decoder_name]
        if decoder_name == "upernet":
            up = head_upsampling
        self.decoder = cls(list(encoder_channels))
        self.segmentation_head = SegmentationHead(head_ch, classes, kernel, up)

    def forward(self, *features, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.segmentation_head(self.decoder(*features, generator=generator))


@dataclass
class MonotempSpec:
    encoder_name: str
    decoder_name: str

    @classmethod
    def from_arch(cls, arch: str) -> "MonotempSpec":
        # the decoder is the last dash-part; the encoder may hold dashes
        # (smp's 'tu-<timm>' prefix)
        enc, dec = arch.rsplit("-", 1)
        return cls(enc, dec)
