"""Swin Transformer v1 (Liu et al. 2021) with smp's UPerNet: the plain
reference model, the geometry of each stage at an input size, and the
forward operations of one image."""

from __future__ import annotations

from dataclasses import dataclass

from benchmark.families import upernet
from benchmark.reference.models import SegModel, SwinEncoder


@dataclass(frozen=True)
class Stage:
    """One stage at an input size: tokens h x w of width c, windows of
    ws x ws padded to hp x wp, shift ss in every second block."""
    h: int
    w: int
    c: int
    heads: int
    depth: int
    ws: int
    ss: int
    hp: int
    wp: int

    @property
    def tokens(self) -> int:
        return self.h * self.w

    @property
    def windows(self) -> int:
        return (self.hp // self.ws) * (self.wp // self.ws)


def stages(cfg: dict, px: int) -> list[Stage]:
    enc = cfg["encoder"]
    h = w = px // enc["patch_size"]
    out = []
    for i, (depth, heads) in enumerate(zip(enc["depths"], enc["num_heads"])):
        if i > 0:
            h, w = (h + 1) // 2, (w + 1) // 2
        ws = min(enc["window_size"], h, w)
        ss = ws // 2 if min(h, w) > ws else 0
        out.append(Stage(h, w, enc["embed_dim"] * 2 ** i, heads, depth, ws, ss,
                         -(-h // ws) * ws, -(-w // ws) * ws))
    return out


def build(cfg: dict, in_channels: int) -> SegModel:
    enc = cfg["encoder"]
    dec = cfg["decoder"]
    encoder = SwinEncoder(in_channels, enc["embed_dim"], tuple(enc["depths"]),
                          tuple(enc["num_heads"]), enc["window_size"])
    out_ch = (in_channels, 0, *(enc["embed_dim"] * 2 ** i for i in range(len(enc["depths"]))))
    return SegModel(encoder, out_ch, cfg["num_classes"], dec["pyramid_channels"],
                    dec["segmentation_channels"])


def block_flops(st: Stage, mlp_ratio: int) -> int:
    """One block: the qkv, output and MLP products on the real tokens, the
    two attention products on the padded windows."""
    n, c = st.tokens, st.c
    linear = 2 * n * c * (3 * c + c + 2 * mlp_ratio * c)
    attn = 2 * 2 * st.windows * (st.ws * st.ws) ** 2 * c
    return linear + attn


def forward_flops(cfg: dict, px: int, in_channels: int) -> int:
    enc = cfg["encoder"]
    sts = stages(cfg, px)
    p = enc["patch_size"]
    total = upernet.conv_flops(sts[0].tokens, in_channels, enc["embed_dim"], p)
    for i, st in enumerate(sts):
        if i > 0:  # patch merging: LayerNorm(4C') then the 4C' -> 2C' reduction
            total += 2 * st.tokens * (2 * st.c) * st.c
        total += st.depth * block_flops(st, enc["mlp_ratio"])
    dec = cfg["decoder"]
    return total + upernet.forward_flops(
        [st.c for st in sts], [st.tokens for st in sts], cfg["num_classes"],
        dec["pyramid_channels"], dec["segmentation_channels"])
