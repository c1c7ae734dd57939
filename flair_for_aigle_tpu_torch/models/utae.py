"""U-TAE: U-net with Temporal Attention Encoder for satellite time series.

Port of ``flair_for_aigle_tpu/models/utae.py``, whose semantics it keeps
where they differ from the upstream utae-paps model, on (B, T, H, W, C)
sequences and NHWC maps:

* ``_smart_forward`` convolves all B·T frames and then writes ``pad_value``
  over the padded ones (it does not gather the valid frames), so a
  BatchNorm encoder in training mode counts the padded frames in its
  statistics.
* LTAE's scores, softmax and value product run in float32 whatever the
  compute dtype; scores at padded dates are *set* to -1e3.
* ``positional_encoding`` computes in the dtype of the dates (float32 on
  every path: the zonal step and the training step never cast ``*_DATES``).
* The temporal aggregator multiplies by the pad mask unconditionally.

Module names are the torch checkpoint keys (``in_conv.conv.conv.0``,
``temporal_encoder.attention_heads.Q``, transposed convolutions at
``up_blocks.{i}.up.0``). Dropout (LTAE's attention and MLP, training mode
only) draws from the ``torch.Generator`` passed to ``forward``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from flair_for_aigle_tpu_torch.models.layers import (
    TorchBatchNorm,
    TorchConv,
    TorchConvTranspose,
    TorchGroupNorm,
    TorchInstanceNorm,
    TorchLinear,
    avg_pool2d,
    dropout,
)
from flair_for_aigle_tpu_torch.ops.resize import resize_bilinear_nhwc

UTAE_TRANSPOSE_CONV_PATTERNS = (".up.0",)


def temporal_pad_mask(x: torch.Tensor, pad_value: float) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T), True where the whole frame equals
    ``pad_value``."""
    return (x == pad_value).flatten(2).all(-1)


class ConvLayer(nn.Module):
    """[Conv (+ norm) (+ ReLU)] x N under ``conv.{i}``, the indices of the
    reference's torch Sequential (ReLUs hold an index, no parameter)."""

    def __init__(self, nkernels: Sequence[int], norm: str = "batch", k: int = 3,
                 s: int = 1, p: int = 1, n_groups: int = 4, last_relu: bool = True,
                 padding_mode: str = "reflect"):
        super().__init__()
        layers: list[nn.Module] = []
        n = len(nkernels) - 1
        for i in range(n):
            c = nkernels[i + 1]
            layers.append(TorchConv(nkernels[i], c, k, s, p, padding_mode=padding_mode))
            if norm == "batch":
                layers.append(TorchBatchNorm(c))
            elif norm == "instance":
                layers.append(TorchInstanceNorm())
            elif norm == "group":
                layers.append(TorchGroupNorm(n_groups, c))
            if last_relu or i < n - 1:
                layers.append(nn.ReLU())
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def _smart_forward(fn, x: torch.Tensor, pad_value) -> torch.Tensor:
    """``fn`` over every frame of (B, T, H, W, C), padded frames set to
    ``pad_value`` afterwards; a 4-D input goes straight through."""
    if x.ndim == 4:
        return fn(x)
    b, t = x.shape[:2]
    flat = x.reshape(b * t, *x.shape[2:])
    out = fn(flat)
    if pad_value is not None:
        pad = (flat == pad_value).flatten(1).all(-1)
        out = torch.where(pad[:, None, None, None],
                          torch.full((), pad_value, dtype=out.dtype, device=out.device), out)
    return out.reshape(b, t, *out.shape[1:])


class ConvBlock(nn.Module):
    def __init__(self, nkernels: Sequence[int], pad_value=None, norm: str = "batch",
                 last_relu: bool = True, padding_mode: str = "reflect"):
        super().__init__()
        self.pad_value = pad_value
        self.conv = ConvLayer(nkernels, norm=norm, last_relu=last_relu,
                              padding_mode=padding_mode)

    def forward(self, x: torch.Tensor, smart: bool = False) -> torch.Tensor:
        if smart:
            return _smart_forward(self.conv, x, self.pad_value)
        return self.conv(x)


class DownConvBlock(nn.Module):
    def __init__(self, d_in: int, d_out: int, k: int, s: int, p: int, pad_value=None,
                 norm: str = "batch", padding_mode: str = "reflect"):
        super().__init__()
        self.pad_value = pad_value
        self.down = ConvLayer([d_in, d_in], norm=norm, k=k, s=s, p=p,
                              padding_mode=padding_mode)
        self.conv1 = ConvLayer([d_in, d_out], norm=norm, padding_mode=padding_mode)
        self.conv2 = ConvLayer([d_out, d_out], norm=norm, padding_mode=padding_mode)

    def _frames(self, y: torch.Tensor) -> torch.Tensor:
        y = self.conv1(self.down(y))
        return y + self.conv2(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _smart_forward(self._frames, x, self.pad_value)


class UpConvBlock(nn.Module):
    def __init__(self, d_in: int, d_out: int, k: int, s: int, p: int, d_skip=None,
                 norm: str = "batch", padding_mode: str = "reflect"):
        super().__init__()
        d = d_out if d_skip is None else d_skip
        self.skip_conv = nn.Sequential(TorchConv(d, d, 1, 1, 0), TorchBatchNorm(d), nn.ReLU())
        self.up = nn.Sequential(TorchConvTranspose(d_in, d_out, k, s, p),
                                TorchBatchNorm(d_out), nn.ReLU())
        self.conv1 = ConvLayer([d_out + d, d_out], norm=norm, padding_mode=padding_mode)
        self.conv2 = ConvLayer([d_out, d_out], norm=norm, padding_mode=padding_mode)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        out = torch.cat([self.up(x), self.skip_conv(skip)], dim=-1)
        out = self.conv1(out)
        return out + self.conv2(out)


def positional_encoding(positions: torch.Tensor, d: int, T: int = 1000,
                        repeat: int | None = None) -> torch.Tensor:
    """Sinusoidal encoding of day offsets, (..., T_seq) -> (..., T_seq,
    d * repeat), in the dtype of ``positions``."""
    denom = torch.as_tensor(T ** (2 * (np.arange(d) // 2) / d), dtype=positions.dtype,
                            device=positions.device)
    table = positions[..., None] / denom
    out = torch.empty_like(table)
    out[..., 0::2] = torch.sin(table[..., 0::2])
    out[..., 1::2] = torch.cos(table[..., 1::2])
    if repeat:
        out = torch.cat([out] * repeat, dim=-1)
    return out


class _AttentionHeads(nn.Module):
    """The learned query ``Q`` (n_head, d_k) and the key projection."""

    def __init__(self, n_head: int, d_k: int, d_model: int):
        super().__init__()
        self.Q = nn.Parameter(torch.empty(n_head, d_k))
        self.fc1_k = TorchLinear(d_model, n_head * d_k)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.Q.copy_(torch.randn(self.Q.shape, generator=gen)
                         * np.sqrt(2.0 / self.Q.shape[1]))


class LTAE2d(nn.Module):
    """Lightweight Temporal Attention Encoder, per pixel over time."""

    def __init__(self, in_channels: int = 128, n_head: int = 16, d_k: int = 4,
                 mlp: Sequence[int] = (256, 128), dropout: float = 0.2,
                 d_model: int | None = 256, T: int = 1000, positional: bool = True):
        super().__init__()
        self.n_head, self.d_k, self.T = n_head, d_k, T
        self.positional = positional
        self.p_drop = dropout
        self.in_norm = TorchGroupNorm(n_head, in_channels)
        self.d_model = d_model if d_model is not None else in_channels
        if d_model is not None:
            self.inconv = TorchLinear(in_channels, d_model)
        self.attention_heads = _AttentionHeads(n_head, d_k, self.d_model)
        self.mlp = nn.Sequential(TorchLinear(self.d_model, mlp[1]), TorchBatchNorm(mlp[1]))
        self.out_norm = TorchGroupNorm(n_head, mlp[-1])

    def forward(self, x: torch.Tensor, batch_positions=None, pad_mask=None,
                generator: torch.Generator | None = None):
        """x (B, T, H, W, C) -> ((B, H, W, C'), attention (heads, B, T, H, W))."""
        b, t, h, w, c = x.shape
        nh, dk, dm = self.n_head, self.d_k, self.d_model
        seq = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
        seq = self.in_norm(seq)
        if hasattr(self, "inconv"):
            seq = self.inconv(seq)
        if self.positional and batch_positions is not None:
            bp = batch_positions[:, None, None, :].expand(b, h, w, t).reshape(b * h * w, t)
            seq = seq + positional_encoding(bp, dm // nh, self.T, repeat=nh).to(seq.dtype)

        k = self.attention_heads.fc1_k(seq).reshape(b * h * w, t, nh, dk)
        logits = torch.einsum("hd,nthd->nht", self.attention_heads.Q.float(),
                              k.float()) / np.sqrt(dk)
        if pad_mask is not None:
            pm = pad_mask[:, None, None, :].expand(b, h, w, t).reshape(b * h * w, t)
            logits = logits.masked_fill(pm[:, None, :], -1e3)
        attn = torch.softmax(logits, dim=-1)  # (N, heads, T)
        attn = dropout(attn, 0.1, self.training, generator)
        v = seq.reshape(b * h * w, t, nh, dm // nh)
        out = torch.einsum("nht,nthd->nhd", attn, v.float()).to(x.dtype)
        out = torch.relu(self.mlp(out.reshape(b * h * w, dm)))
        out = dropout(out, self.p_drop, self.training, generator)
        out = self.out_norm(out).reshape(b, h, w, -1)
        attn_maps = attn.reshape(b, h, w, nh, t).permute(3, 0, 4, 1, 2)
        return out, attn_maps


class TemporalAggregator(nn.Module):
    def __init__(self, mode: str = "att_group"):
        super().__init__()
        if mode not in ("att_group", "att_mean", "mean"):
            raise ValueError(mode)
        self.mode = mode

    def forward(self, x: torch.Tensor, pad_mask=None, attn_mask=None) -> torch.Tensor:
        """x (B, T, H, W, C), attn_mask (heads, B, T, h, w) -> (B, H, W, C)."""
        b, t, h, w, c = x.shape
        if self.mode == "att_group":
            nh = attn_mask.shape[0]
            ah = attn_mask.shape[-2]
            attn = attn_mask.reshape(nh * b, t, *attn_mask.shape[-2:]).permute(0, 2, 3, 1)
            if h > ah:
                attn = resize_bilinear_nhwc(attn, h, w)
            elif ah > h:
                attn = avg_pool2d(attn, ah // h)
            attn = attn.permute(0, 3, 1, 2).reshape(nh, b, t, h, w)
            if pad_mask is not None:
                attn = attn * (~pad_mask).to(attn.dtype)[None, :, :, None, None]
            xg = x.reshape(b, t, h, w, nh, c // nh)
            out = torch.einsum("nbthw,bthwnd->bhwnd", attn.float(), xg.float())
            return out.to(x.dtype).reshape(b, h, w, c)
        if self.mode == "att_mean":
            attn = resize_bilinear_nhwc(attn_mask.mean(0).permute(0, 2, 3, 1), h, w)
            attn = attn.permute(0, 3, 1, 2)  # (B, T, H, W)
            if pad_mask is not None:
                attn = attn * (~pad_mask).to(attn.dtype)[:, :, None, None]
            return torch.einsum("bthw,bthwc->bhwc", attn.float(), x.float()).to(x.dtype)
        if pad_mask is not None:
            keep = (~pad_mask).float()
            out = torch.einsum("bt,bthwc->bhwc", keep, x.float())
            return (out / keep.sum(1).clamp(min=1.0)[:, None, None, None]).to(x.dtype)
        return x.mean(1)


class UTAE(nn.Module):
    """U-TAE on (B, T, H, W, C) sequences. Returns the logits (B, H, W,
    out_conv[-1]); with ``return_maps`` also the maps [LTAE output, each up
    block's output]; with ``encoder`` (out, maps) before ``out_conv``."""

    def __init__(self, input_dim: int, encoder_widths: Sequence[int] = (64, 64, 64, 128),
                 decoder_widths: Sequence[int] = (32, 32, 64, 128),
                 out_conv: Sequence[int] = (32, 20), str_conv_k: int = 4,
                 str_conv_s: int = 2, str_conv_p: int = 1, agg_mode: str = "att_group",
                 encoder_norm: str = "group", n_head: int = 16, d_model: int = 256,
                 d_k: int = 4, encoder: bool = False, return_maps: bool = False,
                 pad_value: float = 0.0, padding_mode: str = "reflect"):
        super().__init__()
        ew, dw = list(encoder_widths), list(decoder_widths)
        n = len(ew)
        self.encoder, self.pad_value = encoder, pad_value
        self.return_maps = return_maps or encoder
        self.in_conv = ConvBlock([input_dim, ew[0], ew[0]], pad_value=pad_value,
                                 norm=encoder_norm, padding_mode=padding_mode)
        self.down_blocks = nn.ModuleList(
            DownConvBlock(ew[i], ew[i + 1], str_conv_k, str_conv_s, str_conv_p,
                          pad_value=pad_value, norm=encoder_norm, padding_mode=padding_mode)
            for i in range(n - 1))
        # up block i takes the LTAE output (ew[-1] channels) or the previous
        # up block's (dw[-(i + 1)])
        self.up_blocks = nn.ModuleList(
            UpConvBlock(ew[-1] if i == 0 else dw[-(i + 1)], dw[-(i + 2)], str_conv_k,
                        str_conv_s, str_conv_p, d_skip=ew[-(i + 2)], norm="batch",
                        padding_mode=padding_mode)
            for i in range(n - 1))
        self.temporal_encoder = LTAE2d(in_channels=ew[-1], d_model=d_model, n_head=n_head,
                                       mlp=(d_model, ew[-1]), d_k=d_k)
        self.temporal_aggregator = TemporalAggregator(mode=agg_mode)
        if not encoder:
            self.out_conv = ConvBlock([dw[0]] + list(out_conv), padding_mode=padding_mode)

    def forward(self, x: torch.Tensor, batch_positions=None,
                generator: torch.Generator | None = None):
        pad_mask = temporal_pad_mask(x, self.pad_value)
        feature_maps = [self.in_conv(x, smart=True)]
        for blk in self.down_blocks:
            feature_maps.append(blk(feature_maps[-1]))
        out, att = self.temporal_encoder(feature_maps[-1], batch_positions=batch_positions,
                                         pad_mask=pad_mask, generator=generator)
        maps = [out]
        for i, blk in enumerate(self.up_blocks):
            skip = self.temporal_aggregator(feature_maps[-(i + 2)], pad_mask=pad_mask,
                                            attn_mask=att)
            out = blk(out, skip)
            maps.append(out)
        if self.encoder:
            return out, maps
        out = self.out_conv(out)
        return (out, maps) if self.return_maps else out
