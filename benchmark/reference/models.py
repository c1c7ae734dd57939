"""Plain PyTorch reference models, in the published state-dict layout
(timm 1.x encoders under smp's ``encoder.model.``, smp's UPerNet
``decoder.`` and ``segmentation_head.``).

Frozen copy of the repository's independent test oracle
(``tests/torch_refs.py``: ``TSwinEncoder`` and its blocks, ``TConvNeXt*``,
``TUPerNetDecoder``, ``TUPerNetHead``), imported from nothing of the port.
Two additions, neither of which changes the arithmetic: ``checkpoint``
recomputes each encoder block in the backward (``torch.utils.checkpoint``,
to fit a training step at batch 16 beside nothing else), and
``SegModel`` holds an encoder, the decoder and the head as smp's
``SegmentationModel`` does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint


def _run(block, x, ckpt: bool):
    if ckpt and torch.is_grad_enabled():
        return _checkpoint(block, x, use_reentrant=False)
    return block(x)


# ---------------------------------------------------------------------------
# Swin Transformer v1 (timm 1.x layout)
# ---------------------------------------------------------------------------


def _rel_pos_index(ws, table_w=None):
    table_w = table_w or ws
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
    coords = coords.flatten(1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.permute(1, 2, 0).contiguous()
    rel[:, :, 0] += table_w - 1
    rel[:, :, 1] += table_w - 1
    rel[:, :, 0] *= 2 * table_w - 1
    return rel.sum(-1)


def _window_partition(x, ws):
    B, H, W, C = x.shape
    x = x.view(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def _window_reverse(x, ws, H, W):
    C = x.shape[-1]
    x = x.view(-1, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, H, W, C)


class WindowAttention(nn.Module):
    def __init__(self, dim, num_heads, ws):
        super().__init__()
        self.num_heads = num_heads
        self.ws = ws
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.randn((2 * ws - 1) ** 2, num_heads) * 0.02)

    def forward(self, x, mask=None):
        B_, N, C = x.shape
        wa = int(N ** 0.5)
        rpi = _rel_pos_index(wa, self.ws).to(x.device)
        qkv = self.qkv(x).reshape(B_, N, 3, self.num_heads, C // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        q = q * self.scale
        attn = q @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[rpi.view(-1)].view(N, N, -1).permute(2, 0, 1)
        attn = attn + bias.unsqueeze(0)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.view(B_ // nW, nW, self.num_heads, N, N) + mask[None, :, None]
            attn = attn.view(-1, self.num_heads, N, N)
        attn = attn.softmax(dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(x)


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, ws, shift):
        super().__init__()
        self.dim, self.ws_target, self.shift_flag = dim, ws, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, ws)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = nn.Sequential()
        self.mlp.fc1 = nn.Linear(dim, dim * 4)
        self.mlp.fc2 = nn.Linear(dim * 4, dim)

    def forward(self, x):  # (B, H, W, C)
        B, H, W, C = x.shape
        ws = min(self.ws_target, H, W)
        ss = ws // 2 if (self.shift_flag and min(H, W) > ws) else 0
        shortcut = x
        y = self.norm1(x)
        if ss:
            y = torch.roll(y, (-ss, -ss), dims=(1, 2))
        pad_h = (ws - H % ws) % ws
        pad_w = (ws - W % ws) % ws
        if pad_h or pad_w:
            y = F.pad(y, (0, 0, 0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w
        windows = _window_partition(y, ws)
        mask = None
        if ss:
            img_mask = torch.zeros(Hp, Wp, device=x.device)
            cnt = 0
            for hs in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
                for wsl in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
                    img_mask[hs, wsl] = cnt
                    cnt += 1
            mw = img_mask.view(Hp // ws, ws, Wp // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
            mask = mw[:, None, :] - mw[:, :, None]
            mask = torch.where(mask != 0, torch.tensor(-100.0, device=x.device),
                               torch.tensor(0.0, device=x.device))
        aw = self.attn(windows, mask)
        y = _window_reverse(aw, ws, Hp, Wp)
        y = y[:, :H, :W, :]
        if ss:
            y = torch.roll(y, (ss, ss), dims=(1, 2))
        x = shortcut + y
        y = self.norm2(x)
        y = self.mlp.fc2(F.gelu(self.mlp.fc1(y)))
        return x + y


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):  # (B, H, W, C)
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
            B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5).flatten(3)
        return self.reduction(self.norm(x))


class SwinEncoder(nn.Module):
    """timm-1.x swin v1; smp TimmUniversalEncoder feature output."""

    def __init__(self, in_channels=3, embed_dim=128, depths=(2, 2, 18, 2),
                 num_heads=(4, 8, 16, 32), ws=12):
        super().__init__()
        self.checkpoint = False
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(in_channels, embed_dim, 4, 4)
        self.patch_embed.norm = nn.LayerNorm(embed_dim)
        self.layers = nn.ModuleList()
        for i, (d, h) in enumerate(zip(depths, num_heads)):
            dim = embed_dim * 2 ** i
            layer = nn.Module()
            if i > 0:
                layer.downsample = PatchMerging(dim // 2)
            layer.blocks = nn.ModuleList(
                [SwinBlock(dim, h, ws, shift=(j % 2 == 1)) for j in range(d)])
            self.layers.append(layer)

    def forward(self, x):  # NCHW in, list of NCHW features out
        feats = [x]
        B, C, H, W = x.shape
        feats.append(torch.zeros(B, 0, H // 2, W // 2, device=x.device))
        y = self.patch_embed.proj(x).permute(0, 2, 3, 1)
        y = self.patch_embed.norm(y)
        for layer in self.layers:
            if hasattr(layer, "downsample"):
                y = layer.downsample(y)
            for blk in layer.blocks:
                y = _run(blk, y, self.checkpoint)
            feats.append(y.permute(0, 3, 1, 2))
        return feats


# ---------------------------------------------------------------------------
# ConvNeXt v1 (timm 1.x layout)
# ---------------------------------------------------------------------------


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, 1, 3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, 4 * dim)
        self.mlp.fc2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):  # NCHW
        y = self.conv_dw(x).permute(0, 2, 3, 1)
        y = self.norm(y)
        y = self.mlp.fc2(F.gelu(self.mlp.fc1(y)))
        y = (self.gamma * y).permute(0, 3, 1, 2)
        return x + y


class LayerNorm2d(nn.LayerNorm):
    def forward(self, x):  # NCHW
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXtEncoder(nn.Module):
    """timm-1.x convnext; smp TimmUniversalEncoder feature output."""

    def __init__(self, in_channels=3, dims=(128, 256, 512, 1024), depths=(3, 3, 27, 3)):
        super().__init__()
        self.checkpoint = False
        self.stem = nn.Sequential(nn.Conv2d(in_channels, dims[0], 4, 4),
                                  LayerNorm2d(dims[0], eps=1e-6))
        self.stages = nn.ModuleList()
        for i, (dim, d) in enumerate(zip(dims, depths)):
            stage = nn.Module()
            if i > 0:
                stage.downsample = nn.Sequential(LayerNorm2d(dims[i - 1], eps=1e-6),
                                                 nn.Conv2d(dims[i - 1], dim, 2, 2))
            stage.blocks = nn.ModuleList([ConvNeXtBlock(dim) for _ in range(d)])
            self.stages.append(stage)

    def forward(self, x):  # NCHW in, list of NCHW features out
        B, C, H, W = x.shape
        feats = [x, torch.zeros(B, 0, H // 2, W // 2, device=x.device)]
        y = self.stem(x)
        for stage in self.stages:
            if hasattr(stage, "downsample"):
                y = stage.downsample(y)
            for blk in stage.blocks:
                y = _run(blk, y, self.checkpoint)
            feats.append(y)
        return feats


# ---------------------------------------------------------------------------
# UPerNet decoder + head (smp 0.4: PSP 1/2/3/6 with align_corners=True
# pyramid resizes, nearest FPN top-down, concat bottleneck, x4
# UpsamplingBilinear2d head)
# ---------------------------------------------------------------------------


class ConvBNReLU(nn.Sequential):
    def __init__(self, cin, cout, k=1):
        super().__init__(nn.Conv2d(cin, cout, k, 1, k // 2, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU(inplace=True))


class PSPBlock(nn.Module):
    def __init__(self, cin, cout, size):
        super().__init__()
        self.pool = nn.Sequential(nn.AdaptiveAvgPool2d(size), ConvBNReLU(cin, cout, 1))

    def forward(self, x):
        h, w = x.shape[-2:]
        return F.interpolate(self.pool(x), size=(h, w), mode="bilinear", align_corners=True)


class PSPModule(nn.Module):
    def __init__(self, cin, cout, sizes=(1, 2, 3, 6)):
        super().__init__()
        branch = cin // len(sizes)
        self.blocks = nn.ModuleList([PSPBlock(cin, branch, s) for s in sizes])
        self.out_conv = ConvBNReLU(cin + branch * len(sizes), cout, 1)

    def forward(self, x):
        ys = [blk(x) for blk in self.blocks]
        return self.out_conv(torch.cat(ys + [x], dim=1))


class FPNBlock(nn.Module):
    def __init__(self, cskip, pyramid):
        super().__init__()
        self.skip_conv = ConvBNReLU(cskip, pyramid, 1)

    def forward(self, x, skip):
        skip = self.skip_conv(skip)
        x = F.interpolate(x, size=skip.shape[-2:], mode="nearest")
        return x + skip


class UPerNetDecoder(nn.Module):
    def __init__(self, encoder_channels, pyramid=256, seg_channels=64):
        super().__init__()
        chans = list(encoder_channels[2:])  # drop input + dummy
        self.psp = PSPModule(chans[-1], pyramid)
        self.fpn_stages = nn.ModuleList([FPNBlock(c, pyramid) for c in chans[:-1]])
        self.fpn_bottleneck = ConvBNReLU(pyramid * len(chans), seg_channels, 3)

    def forward(self, *features):
        feats = list(features[2:])
        fpn = [self.psp(feats[-1])]
        for i in range(len(feats) - 2, -1, -1):
            fpn.append(self.fpn_stages[i](fpn[-1], feats[i]))
        th, tw = feats[0].shape[-2:]
        resized = [F.interpolate(f, size=(th, tw), mode="bilinear", align_corners=False)
                   if f.shape[-2:] != (th, tw) else f for f in fpn]
        return self.fpn_bottleneck(torch.cat(resized, dim=1))


class UPerNetHead(nn.Sequential):
    def __init__(self, cin, classes, upsampling=4):
        super().__init__(nn.Conv2d(cin, classes, 3, 1, 1),
                         nn.UpsamplingBilinear2d(scale_factor=upsampling))


class SegModel(nn.Module):
    """smp-style container: ``encoder.model.<timm>``, ``decoder.<upernet>``,
    ``segmentation_head.<head>``; NCHW logits at the input's size."""

    def __init__(self, encoder: nn.Module, out_channels, classes: int,
                 pyramid: int = 256, seg_channels: int = 64):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.model = encoder
        self.decoder = UPerNetDecoder(out_channels, pyramid, seg_channels)
        self.segmentation_head = UPerNetHead(seg_channels, classes)

    def forward(self, x):
        return self.segmentation_head(self.decoder(*self.encoder.model(x)))
