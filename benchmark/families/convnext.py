"""ConvNeXt v1 (Liu et al. 2022) with smp's UPerNet: the plain reference
model, the geometry of each stage and the forward operations of one
image."""

from __future__ import annotations

from dataclasses import dataclass

from benchmark.families import upernet
from benchmark.reference.models import ConvNeXtEncoder, SegModel


@dataclass(frozen=True)
class Stage:
    h: int
    w: int
    c: int
    depth: int

    @property
    def tokens(self) -> int:
        return self.h * self.w


def stages(cfg: dict, px: int) -> list[Stage]:
    enc = cfg["encoder"]
    h = w = px // enc["patch_size"]
    out = []
    for i, (dim, depth) in enumerate(zip(enc["dims"], enc["depths"])):
        if i > 0:
            h, w = h // 2, w // 2
        out.append(Stage(h, w, dim, depth))
    return out


def build(cfg: dict, in_channels: int) -> SegModel:
    enc = cfg["encoder"]
    dec = cfg["decoder"]
    encoder = ConvNeXtEncoder(in_channels, tuple(enc["dims"]), tuple(enc["depths"]))
    return SegModel(encoder, (in_channels, 0, *enc["dims"]), cfg["num_classes"],
                    dec["pyramid_channels"], dec["segmentation_channels"])


def forward_flops(cfg: dict, px: int, in_channels: int) -> int:
    enc = cfg["encoder"]
    sts = stages(cfg, px)
    r, k = enc["mlp_ratio"], enc["dw_kernel"]
    total = upernet.conv_flops(sts[0].tokens, in_channels, sts[0].c, enc["patch_size"])
    for i, st in enumerate(sts):
        if i > 0:  # downsample: LayerNorm then a 2 x 2 stride-2 convolution
            total += upernet.conv_flops(st.tokens, sts[i - 1].c, st.c, 2)
        per_block = (upernet.conv_flops(st.tokens, st.c, st.c, k, groups=st.c)
                     + 2 * 2 * st.tokens * st.c * r * st.c)
        total += st.depth * per_block
    dec = cfg["decoder"]
    return total + upernet.forward_flops(
        [st.c for st in sts], [st.tokens for st in sts], cfg["num_classes"],
        dec["pyramid_channels"], dec["segmentation_channels"])
