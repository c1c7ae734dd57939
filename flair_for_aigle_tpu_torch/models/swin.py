"""Swin Transformer v1 encoder (timm 1.x layout), NHWC PyTorch.

Port of ``flair_for_aigle_tpu/models/swin.py``. Module names mirror timm's
state-dict keys (``layers.{i}.blocks.{j}.attn.qkv`` ..., downsample at stage
entry on layers 1-3). Returned features follow smp's TimmUniversalEncoder:
``[input, zero-channel dummy at stride 2, s4, s8, s16, s32]``.

Each block runs the three fused ops of the reference's default path
(``swin.py:239-250, 156-171, 309-318``): the LN + shift + pad + partition
prologue (``ops/prep.py``), the fused window attention
(``ops/window_attn.py``) and the residual + LN + MLP + residual tail
(``ops/ffn.py``). With ``FLAIR_SWIN_FINISH=1`` (read at call time, as
``swin.py:261`` reads it) the window reverse, crop, un-shift and tail are
one op instead, the fused finish (``ops/finish.py``, ``swin.py:261-280``).
``PatchMerging`` runs the fused patch merge
(``ops/merge.py``, the reference's default ``FLAIR_SWIN_MERGE=1``,
``swin.py:344-356``). Each op launches its CUDA kernel on a CUDA tensor and
runs its plain version on a CPU tensor, and each is differentiable, so
training runs the same ops (the attention backward is kernel K6).
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.layers import (
    MLP,
    TorchConv,
    TorchLayerNorm,
    TorchLinear,
)
from flair_for_aigle_tpu_torch.ops import ffn, finish, merge, prep, window_attn
from flair_for_aigle_tpu_torch.ops.prep import window_reverse


@lru_cache(maxsize=None)
def _relative_position_index(wh: int, ww: int, table_w: int) -> np.ndarray:
    """Index into a bias table built for ``table_w`` using an actual window
    (wh, ww) <= table_w."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += table_w - 1
    rel[:, :, 1] += table_w - 1
    rel[:, :, 0] *= 2 * table_w - 1
    return rel.sum(-1)


@lru_cache(maxsize=None)
def _shift_attn_mask(h: int, w: int, ws: int, ss: int) -> np.ndarray | None:
    """timm's (nW, T, T) shifted-window mask over a padded (h, w) raster;
    None when there is no shift."""
    if ss == 0:
        return None
    img_mask = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
        for wsl in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    mw = img_mask.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    mw = mw.reshape(-1, ws * ws)
    attn_mask = mw[:, None, :] - mw[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


def _trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Normal(0, std) truncated to +-2 std (flax truncated_normal)."""
    with torch.no_grad():
        v = torch.randn(t.shape, generator=gen)
        bad = v.abs() > 2
        while bad.any():
            v[bad] = torch.randn(int(bad.sum()), generator=gen)
            bad = v.abs() > 2
        t.copy_(v * std)


class WindowAttention(nn.Module):
    """Windowed multi-head attention with a relative-position bias table
    built for ``table_window``; the actual window may be clamped smaller."""

    def __init__(self, dim: int, num_heads: int, table_window: int,
                 attn_f32: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.table_window = table_window
        self.attn_f32 = attn_f32
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * table_window - 1) ** 2, num_heads))
        self.qkv = TorchLinear(dim, 3 * dim)
        self.proj = TorchLinear(dim, dim)

    def reset_parameters(self, gen: torch.Generator) -> None:
        _trunc_normal_(self.relative_position_bias_table, 0.02, gen)

    def position_bias(self, ws: int) -> torch.Tensor:
        """(nh, T, T) float32 bias gathered from the table."""
        t = ws * ws
        idx = torch.as_tensor(
            _relative_position_index(ws, ws, self.table_window).reshape(-1),
            device=self.relative_position_bias_table.device)
        bias = self.relative_position_bias_table[idx].reshape(t, t, -1)
        return bias.permute(2, 0, 1).float()

    def forward(self, x: torch.Tensor, *, window_size: int, shift_size: int,
                grid_hw: tuple[int, int]) -> torch.Tensor:
        """x: (B*nW, T, C) windows of the padded, pre-rolled raster, row-major
        over its (nwh, nww) = ``grid_hw`` window grid. Returns the same
        layout."""
        return window_attn.fused_window_attention(
            x, self.qkv.weight, self.qkv.bias, self.proj.weight,
            self.proj.bias, self.position_bias(window_size),
            num_heads=self.num_heads, window_size=window_size,
            shift_size=shift_size, grid_hw=grid_hw, attn_f32=self.attn_f32)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift: bool,
                 mlp_ratio: float = 4.0, attn_f32: bool = True):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.norm1 = TorchLayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size, attn_f32)
        self.norm2 = TorchLayerNorm(dim)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        # timm _calc_window_shift: the window clamps to the feature size and
        # the shift disables when the feature fits in one window
        ws = min(self.window_size, h, w)
        ss = ws // 2 if (self.shift and min(h, w) > ws) else 0
        hp = h + (ws - h % ws) % ws
        wp = w + (ws - w % ws) % ws
        win = prep.fused_ln_shift_partition(x, self.norm1.weight,
                                            self.norm1.bias, ws=ws, ss=ss)
        y = self.attn(win, window_size=ws, shift_size=ss,
                      grid_hw=(hp // ws, wp // ws))
        if os.environ.get("FLAIR_SWIN_FINISH", "0") == "1":
            return finish.fused_reverse_ln_mlp_residual(
                y, x, self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
                self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias,
                ws=ws, ss=ss)
        y = window_reverse(y, ws, hp, wp)[:, :h, :w]
        if ss:
            y = torch.roll(y, (ss, ss), dims=(1, 2))
        return ffn.fused_ln_mlp_residual(
            x, y, self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
            self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias)


class PatchMerging(nn.Module):
    """2x2 neighbourhood gather in timm order [x00, x10, x01, x11], LN over
    the 4C concat, bias-free reduction (the fused merge op); an odd H or W
    is zero-padded first."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = TorchLayerNorm(4 * dim)
        self.reduction = TorchLinear(4 * dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = torch.nn.functional.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        return merge.fused_patch_merge(x.contiguous(), self.norm.weight,
                                       self.norm.bias, self.reduction.weight)


class _PatchEmbed(nn.Module):
    def __init__(self, in_ch: int, dim: int, patch: int):
        super().__init__()
        self.proj = TorchConv(in_ch, dim, patch, patch, 0)
        self.norm = TorchLayerNorm(dim)


class _Stage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, heads: int,
                 window: int, attn_f32: bool, downsample: bool):
        super().__init__()
        if downsample:
            self.downsample = PatchMerging(in_dim, dim)
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, shift=(j % 2 == 1), attn_f32=attn_f32)
            for j in range(depth))


class SwinTransformerEncoder(nn.Module):
    """timm-1.x Swin with smp-TimmUniversalEncoder-style 6-feature output."""

    def __init__(self, in_channels: int = 3, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 window_size: int = 12, patch_size: int = 4,
                 attn_f32: bool = True):
        super().__init__()
        self.in_channels = in_channels
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.patch_embed = _PatchEmbed(in_channels, embed_dim, patch_size)
        self.layers = nn.ModuleList(
            _Stage(embed_dim * 2 ** max(i - 1, 0), embed_dim * 2 ** i, d, nh,
                   window_size, attn_f32, downsample=i > 0)
            for i, (d, nh) in enumerate(zip(depths, num_heads)))

    @property
    def out_channels(self) -> tuple[int, ...]:
        dims = [self.embed_dim * 2 ** i for i in range(len(self.depths))]
        return (self.in_channels, 0, *dims)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        b, h, w, _ = x.shape
        feats = [x, x.new_zeros((b, h // 2, w // 2, 0))]
        y = self.patch_embed.norm(self.patch_embed.proj(x))
        for stage in self.layers:
            if hasattr(stage, "downsample"):
                y = stage.downsample(y)
            for block in stage.blocks:
                y = block(y.contiguous())
            feats.append(y)
        return feats
