"""smp's UPerNet decoder and head: operations counted from the published
shapes (pyramid and segmentation channels), shared by every encoder family
whose configuration names ``"decoder": {"name": "upernet"}``.

Operations are those of the products alone (convolutions, matrix
products), two a multiply-add; norms, activations, pools and resizes are
left out, as model FLOPs are counted by convention."""

from __future__ import annotations


def conv_flops(pixels: int, cin: int, cout: int, k: int = 1, groups: int = 1) -> int:
    return 2 * pixels * (cin // groups) * k * k * cout


def forward_flops(stage_channels, stage_pixels, classes: int, pyramid: int = 256,
                  seg_channels: int = 64) -> int:
    """One image through the decoder and the head's convolution at stride 4
    (the x4 upsampling is a resize). ``stage_channels`` and
    ``stage_pixels``: the encoder's four feature maps, stride 4 first."""
    c4, n4 = stage_channels[-1], stage_pixels[-1]
    branch = c4 // 4
    total = sum(conv_flops(s * s, c4, branch) for s in (1, 2, 3, 6))  # PSP pools
    total += conv_flops(n4, c4 + 4 * branch, pyramid)  # PSP out_conv
    total += sum(conv_flops(n, c, pyramid)
                 for c, n in zip(stage_channels[:-1], stage_pixels[:-1]))  # FPN skips
    total += conv_flops(stage_pixels[0], pyramid * len(stage_channels), seg_channels, 3)
    total += conv_flops(stage_pixels[0], seg_channels, classes, 3)  # head conv
    return total
