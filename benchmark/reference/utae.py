"""Plain float32 reference of FLAIR-HUB's aerial + Sentinel-2 model: U-TAE
over the time series (Garnot & Landrieu 2021, arXiv:2107.07933, upstream
``VSainteuf/utae-paps`` ``src/backbones/utae.py`` and ``ltae.py``), the
Swin-B UPerNet of ``reference/models.py`` (imported, not copied) on the
aerial tile, and FLAIR-HUB's full fusion (``flair_hub/models/
flair_model.py`` ``FusionHandler``, :437-547); and the series route of the
zonal reference: each tile's window of the Sentinel-2 raster and of its
cloud and snow mask, the dates it keeps, and the padding of a batch to its
largest date count. Imports nothing of the port.

State-dict names are FLAIR-HUB's checkpoint keys: ``encoders.<MOD>.
seg_model.model.*`` (the aerial encoder, timm names), ``encoders.<TS>.*``
(U-TAE), ``fusion_handler.conv_f.{i}``, ``main_decoders.<task>.seg_model.
{decoder,segmentation_head}.*``.

Departures from upstream, none of which changes the labels:

* the unused U-TAE logits are computed by ``out_conv`` but not resized to
  the tile (FLAIR-HUB resizes them for an auxiliary loss that the zonal
  configuration turns off), and no auxiliary decoder is built;
* dropout layers are left out (the reference runs in eval mode only);
* ``TemporallySharedBlock.smart_forward`` gathers the valid frames as
  upstream does, but builds its pad-valued output without the upstream's
  extra dummy forward that only reads the output shape.
"""

from __future__ import annotations

import math
from datetime import datetime

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import zonal as zref
from benchmark.reference.models import SwinEncoder, UPerNetDecoder, UPerNetHead

# ---------------------------------------------------------------------------
# U-TAE (utae-paps src/backbones/utae.py)
# ---------------------------------------------------------------------------


class ConvLayer(nn.Module):
    def __init__(self, nkernels, norm="batch", k=3, s=1, p=1, n_groups=4, last_relu=True,
                 padding_mode="reflect"):
        super().__init__()
        layers = []
        if norm == "batch":
            nl = nn.BatchNorm2d
        elif norm == "instance":
            nl = nn.InstanceNorm2d
        elif norm == "group":
            def nl(c):
                return nn.GroupNorm(num_channels=c, num_groups=n_groups)
        else:
            nl = None
        for i in range(len(nkernels) - 1):
            layers.append(nn.Conv2d(nkernels[i], nkernels[i + 1], k, padding=p, stride=s,
                                    padding_mode=padding_mode))
            if nl is not None:
                layers.append(nl(nkernels[i + 1]))
            if last_relu or i < len(nkernels) - 2:
                layers.append(nn.ReLU())
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return self.conv(x)


class TemporallySharedBlock(nn.Module):
    """A block applied to each frame of (B, T, C, H, W); frames wholly at
    ``pad_value`` are not computed and come out at ``pad_value``."""

    def __init__(self, pad_value=None):
        super().__init__()
        self.pad_value = pad_value

    def smart_forward(self, x):
        if x.dim() == 4:
            return self.forward(x)
        b, t, c, h, w = x.shape
        flat = x.reshape(b * t, c, h, w)
        if self.pad_value is None:
            out = self.forward(flat)
        else:
            pad = (flat == self.pad_value).flatten(1).all(-1)
            valid = self.forward(flat[~pad])
            out = torch.full((b * t, *valid.shape[1:]), float(self.pad_value),
                             dtype=valid.dtype, device=valid.device)
            out[~pad] = valid
        return out.reshape(b, t, *out.shape[1:])


class ConvBlock(TemporallySharedBlock):
    def __init__(self, nkernels, pad_value=None, norm="batch", last_relu=True,
                 padding_mode="reflect"):
        super().__init__(pad_value)
        self.conv = ConvLayer(nkernels, norm=norm, last_relu=last_relu,
                              padding_mode=padding_mode)

    def forward(self, x):
        return self.conv(x)


class DownConvBlock(TemporallySharedBlock):
    def __init__(self, d_in, d_out, k, s, p, pad_value=None, norm="batch",
                 padding_mode="reflect"):
        super().__init__(pad_value)
        self.down = ConvLayer([d_in, d_in], norm=norm, k=k, s=s, p=p,
                              padding_mode=padding_mode)
        self.conv1 = ConvLayer([d_in, d_out], norm=norm, padding_mode=padding_mode)
        self.conv2 = ConvLayer([d_out, d_out], norm=norm, padding_mode=padding_mode)

    def forward(self, x):
        out = self.conv1(self.down(x))
        return out + self.conv2(out)


class UpConvBlock(nn.Module):
    def __init__(self, d_in, d_out, k, s, p, norm="batch", d_skip=None,
                 padding_mode="reflect"):
        super().__init__()
        d = d_out if d_skip is None else d_skip
        self.skip_conv = nn.Sequential(nn.Conv2d(d, d, 1), nn.BatchNorm2d(d), nn.ReLU())
        self.up = nn.Sequential(nn.ConvTranspose2d(d_in, d_out, k, stride=s, padding=p),
                                nn.BatchNorm2d(d_out), nn.ReLU())
        self.conv1 = ConvLayer([d_out + d, d_out], norm=norm, padding_mode=padding_mode)
        self.conv2 = ConvLayer([d_out, d_out], norm=norm, padding_mode=padding_mode)

    def forward(self, x, skip):
        out = torch.cat([self.up(x), self.skip_conv(skip)], dim=1)
        out = self.conv1(out)
        return out + self.conv2(out)


class TemporalAggregator(nn.Module):
    def __init__(self, mode="att_group"):
        super().__init__()
        if mode != "att_group":
            raise ValueError("the reference holds FLAIR-HUB's att_group aggregation only")
        self.mode = mode

    def forward(self, x, pad_mask=None, attn_mask=None):
        n_heads, b, t, h, w = attn_mask.shape
        attn = attn_mask.reshape(n_heads * b, t, h, w)
        if x.shape[-2] > w:
            attn = F.interpolate(attn, size=x.shape[-2:], mode="bilinear", align_corners=False)
        else:
            attn = F.avg_pool2d(attn, kernel_size=w // x.shape[-2])
        attn = attn.reshape(n_heads, b, t, *x.shape[-2:])
        if pad_mask is not None and pad_mask.any():
            attn = attn * (~pad_mask).float()[None, :, :, None, None]
        out = torch.stack(x.chunk(n_heads, dim=2))  # (heads, B, T, C / heads, H, W)
        out = (attn[:, :, :, None, :, :] * out).sum(dim=2)
        return torch.cat(list(out), dim=1)


# ---------------------------------------------------------------------------
# L-TAE (utae-paps src/backbones/ltae.py, Garnot & Landrieu 2020,
# arXiv:2007.00586)
# ---------------------------------------------------------------------------


class PositionalEncoder(nn.Module):
    def __init__(self, d, T=1000, repeat=None):
        super().__init__()
        self.d, self.T, self.repeat = d, T, repeat
        self.register_buffer("denom", torch.pow(
            float(T), 2 * torch.div(torch.arange(d).float(), 2, rounding_mode="floor") / d),
            persistent=False)

    def forward(self, batch_positions):
        table = batch_positions[:, :, None] / self.denom[None, None, :]
        table[:, :, 0::2] = torch.sin(table[:, :, 0::2])
        table[:, :, 1::2] = torch.cos(table[:, :, 1::2])
        if self.repeat is not None:
            table = torch.cat([table] * self.repeat, dim=-1)
        return table


class MultiHeadAttention(nn.Module):
    """One learned query per head over the dates (the L-TAE's attention)."""

    def __init__(self, n_head, d_k, d_in):
        super().__init__()
        self.n_head, self.d_k, self.d_in = n_head, d_k, d_in
        self.Q = nn.Parameter(torch.zeros((n_head, d_k)))
        self.fc1_k = nn.Linear(d_in, n_head * d_k)

    def forward(self, v, pad_mask=None):
        n_head, d_k = self.n_head, self.d_k
        sz_b, seq_len, _ = v.shape
        q = torch.stack([self.Q for _ in range(sz_b)], dim=1).view(-1, d_k)
        k = self.fc1_k(v).view(sz_b, seq_len, n_head, d_k)
        k = k.permute(2, 0, 1, 3).contiguous().view(-1, seq_len, d_k)
        if pad_mask is not None:
            pad_mask = pad_mask.repeat((n_head, 1))
        v = torch.stack(v.split(v.shape[-1] // n_head, dim=-1)).view(n_head * sz_b, seq_len, -1)
        attn = torch.matmul(q.unsqueeze(1), k.transpose(1, 2)) / math.sqrt(d_k)
        if pad_mask is not None:
            attn = attn.masked_fill(pad_mask.unsqueeze(1), -1e3)
        attn = torch.softmax(attn, dim=2)
        output = torch.matmul(attn, v)
        return (output.view(n_head, sz_b, self.d_in // n_head),
                attn.view(n_head, sz_b, seq_len))


class LTAE2d(nn.Module):
    def __init__(self, in_channels=128, n_head=16, d_k=4, mlp=(256, 128), d_model=256,
                 T=1000):
        super().__init__()
        self.in_channels, self.n_head, self.d_model = in_channels, n_head, d_model
        self.inconv = nn.Conv1d(in_channels, d_model, 1)
        self.positional_encoder = PositionalEncoder(d_model // n_head, T=T, repeat=n_head)
        self.attention_heads = MultiHeadAttention(n_head, d_k, d_model)
        self.in_norm = nn.GroupNorm(num_groups=n_head, num_channels=in_channels)
        self.out_norm = nn.GroupNorm(num_groups=n_head, num_channels=mlp[-1])
        layers = []
        for i in range(len(mlp) - 1):
            layers.extend([nn.Linear(mlp[i], mlp[i + 1]), nn.BatchNorm1d(mlp[i + 1]), nn.ReLU()])
        self.mlp = nn.Sequential(*layers)

    def forward(self, x, batch_positions=None, pad_mask=None):
        sz_b, seq_len, d, h, w = x.shape
        if pad_mask is not None:
            pad_mask = pad_mask[:, :, None, None].expand(sz_b, seq_len, h, w)
            pad_mask = pad_mask.permute(0, 2, 3, 1).reshape(sz_b * h * w, seq_len)
        out = x.permute(0, 3, 4, 1, 2).reshape(sz_b * h * w, seq_len, d)
        out = self.in_norm(out.permute(0, 2, 1)).permute(0, 2, 1)
        out = self.inconv(out.permute(0, 2, 1)).permute(0, 2, 1)
        bp = batch_positions[:, :, None, None].expand(sz_b, seq_len, h, w)
        bp = bp.permute(0, 2, 3, 1).reshape(sz_b * h * w, seq_len)
        out = out + self.positional_encoder(bp)
        out, attn = self.attention_heads(out, pad_mask=pad_mask)
        out = out.permute(1, 0, 2).reshape(sz_b * h * w, -1)  # heads concatenated
        out = self.out_norm(self.mlp(out))
        out = out.view(sz_b, h, w, -1).permute(0, 3, 1, 2)
        attn = attn.view(self.n_head, sz_b, h, w, seq_len).permute(0, 1, 4, 2, 3)
        return out, attn


class UTAE(nn.Module):
    """U-TAE with ``return_maps``: (logits, [L-TAE output, each up block's
    output]), as FLAIR-HUB builds it (``encoder=False, return_maps=True``)."""

    def __init__(self, input_dim, encoder_widths=(64, 64, 64, 128),
                 decoder_widths=(32, 32, 64, 128), out_conv=(32, 20), str_conv_k=4,
                 str_conv_s=2, str_conv_p=1, agg_mode="att_group", encoder_norm="group",
                 n_head=16, d_model=256, d_k=4, pad_value=0, padding_mode="reflect"):
        super().__init__()
        ew, dw = list(encoder_widths), list(decoder_widths)
        self.n_stages = len(ew)
        self.pad_value = pad_value
        self.in_conv = ConvBlock([input_dim, ew[0], ew[0]], pad_value=pad_value,
                                 norm=encoder_norm, padding_mode=padding_mode)
        self.down_blocks = nn.ModuleList(
            DownConvBlock(ew[i], ew[i + 1], str_conv_k, str_conv_s, str_conv_p,
                          pad_value=pad_value, norm=encoder_norm, padding_mode=padding_mode)
            for i in range(self.n_stages - 1))
        self.up_blocks = nn.ModuleList(
            UpConvBlock(dw[i], dw[i - 1], str_conv_k, str_conv_s, str_conv_p, norm="batch",
                        d_skip=ew[i - 1], padding_mode=padding_mode)
            for i in range(self.n_stages - 1, 0, -1))
        self.temporal_encoder = LTAE2d(ew[-1], n_head=n_head, d_k=d_k, mlp=(d_model, ew[-1]),
                                       d_model=d_model)
        self.temporal_aggregator = TemporalAggregator(agg_mode)
        self.out_conv = ConvBlock([dw[0]] + list(out_conv), padding_mode=padding_mode)

    def forward(self, x, batch_positions=None):
        pad_mask = (x == self.pad_value).all(dim=-1).all(dim=-1).all(dim=-1)  # (B, T)
        feature_maps = [self.in_conv.smart_forward(x)]
        for blk in self.down_blocks:
            feature_maps.append(blk.smart_forward(feature_maps[-1]))
        out, att = self.temporal_encoder(feature_maps[-1], batch_positions=batch_positions,
                                         pad_mask=pad_mask)
        maps = [out]
        for i, blk in enumerate(self.up_blocks):
            skip = self.temporal_aggregator(feature_maps[-(i + 2)], pad_mask=pad_mask,
                                            attn_mask=att)
            out = blk(out, skip)
            maps.append(out)
        return self.out_conv(out), maps


def adjust_fm_length(encoder_widths, n_stages: int) -> list[int]:
    """FLAIR-HUB's ``adjust_fm_length``: U-TAE widths for a mono encoder of
    ``n_stages`` stages, spread between the configured widths' extremes and
    rounded to powers of two."""
    spread = np.linspace(min(encoder_widths) - 1, max(encoder_widths) + 1, n_stages).astype(int)
    return [2 ** round(math.log2(v)) for v in spread]


# ---------------------------------------------------------------------------
# FLAIR-HUB: Swin-B UPerNet on the aerial tile, fused with U-TAE's maps
# ---------------------------------------------------------------------------


class _Holder(nn.Module):
    def __init__(self, **children):
        super().__init__()
        for k, v in children.items():
            setattr(self, k, v)


class FusedModel(nn.Module):
    """FLAIR-HUB's ``FLAIR_HUB_Model`` with one mono modality and one time
    series, full fusion, one task and no auxiliary decoder. ``forward(aerial
    (B, C, H, W), series (B, T, C', h, w), dates (B, T))`` returns NCHW
    logits at the aerial tile's size."""

    def __init__(self, mono: str, series: str, task: str, in_channels: int,
                 series_channels: int, enc: dict, dec: dict, utae: dict, classes: int):
        super().__init__()
        self.mono, self.series, self.task = mono, series, task
        depths = tuple(enc["depths"])
        swin = SwinEncoder(in_channels, enc["embed_dim"], depths, tuple(enc["num_heads"]),
                           enc["window_size"])
        stage_ch = [enc["embed_dim"] * 2 ** i for i in range(len(depths))]
        widths = adjust_fm_length(utae["encoder_widths"], len(stage_ch))
        out_conv = list(utae["out_conv"])
        if out_conv[-1] != classes:
            out_conv.append(classes)
        ts = UTAE(series_channels, widths, widths, out_conv, utae["str_conv_k"],
                  utae["str_conv_s"], utae["str_conv_p"], utae["agg_mode"],
                  utae["encoder_norm"], utae["n_head"], utae["d_model"], utae["d_k"],
                  utae["pad_value"], utae["padding_mode"])
        self.encoders = nn.ModuleDict({mono: _Holder(seg_model=_Holder(model=swin)),
                                       series: ts})
        # U-TAE's maps (L-TAE output, then each up block's) stage by stage
        maps_ch = [widths[-1]] + widths[-2::-1]
        self.fusion_handler = _Holder(conv_f=nn.ModuleList(
            nn.Conv2d(s + m, s, 1) for s, m in zip(stage_ch, maps_ch)))
        out_ch = (in_channels, 0, *stage_ch)
        self.main_decoders = nn.ModuleDict({task: _Holder(seg_model=_Holder(
            decoder=UPerNetDecoder(out_ch, dec["pyramid_channels"], dec["segmentation_channels"]),
            segmentation_head=UPerNetHead(dec["segmentation_channels"], classes)))})

    def fuse(self, feats: list, maps: list) -> list:
        """FusionHandler's full fusion: each modality's pyramid without its
        0-channel dummies, its first map repeated in front to the target's
        length, resized (bilinear) to the target's stages, concatenated in
        modality order (mono first) and through ``conv_f``; the target's
        dummies put back in front."""
        dummies, targets = feats[:2], feats[2:]
        maps = [maps[0]] * (len(targets) - len(maps)) + list(maps)
        aligned = [m if m.shape[-2:] == t.shape[-2:] else
                   F.interpolate(m, size=t.shape[-2:], mode="bilinear", align_corners=False)
                   for m, t in zip(maps, targets)]
        return dummies + [conv(torch.cat([t, m], dim=1)) for conv, t, m
                          in zip(self.fusion_handler.conv_f, targets, aligned)]

    def forward(self, aerial, series, dates):
        feats = self.encoders[self.mono].seg_model.model(aerial)
        _, maps = self.encoders[self.series](series, batch_positions=dates)
        head = self.main_decoders[self.task].seg_model
        return head.segmentation_head(head.decoder(*self.fuse(feats, maps)))


# ---------------------------------------------------------------------------
# The series route: a tile's window, its kept dates, a batch's padding
# ---------------------------------------------------------------------------


def day_offsets(date_strings: list[str], ref_date: str) -> np.ndarray:
    """Days from each date (``YYYYMMDD``) to the reference day (``MM-DD``)
    of its own year, float32."""
    month, day = (int(v) for v in ref_date.split("-"))
    dates = [datetime.strptime(d, "%Y%m%d") for d in date_strings]
    return np.array([(d - datetime(d.year, month, day)).days for d in dates], np.float32)


def window(raster: np.ndarray, row: int, col: int, size: int) -> np.ndarray:
    """(bands, size, size) of ``raster`` at (row, col), zero outside."""
    bands, height, width = raster.shape
    out = np.zeros((bands, size, size), raster.dtype)
    r0, c0 = max(row, 0), max(col, 0)
    r1, c1 = min(row + size, height), min(col + size, width)
    if r0 < r1 and c0 < c1:
        out[:, r0 - row:r1 - row, c0 - col:c1 - col] = raster[:, r0:r1, c0:c1]
    return out


def kept_dates(mask: np.ndarray, max_cloud: int = 1, max_snow: int = 1,
               max_cover: float = 0.05) -> np.ndarray:
    """(T,) bool of the dates a tile keeps from its (T, 2, h, w) mask window
    (band 0 snow, band 1 cloud probability): a date whose pixels above
    ``max_cloud`` in cloud or ``max_snow`` in snow pass ``max_cover`` of the
    window is dropped; where that drops every date, snow alone decides; where
    that too drops every date, every date is kept."""
    npix = mask.shape[2] * mask.shape[3]
    clear = ((mask[:, 1] <= max_cloud) & (mask[:, 0] <= max_snow)).reshape(len(mask), -1)
    keep = clear.sum(1) >= (1 - max_cover) * npix
    if not keep.any():
        keep = (mask[:, 0] <= max_snow).reshape(len(mask), -1).sum(1) >= (1 - max_cover) * npix
    if not keep.any():
        keep = np.ones(len(mask), bool)
    return keep


def series_windows(height: int, width: int, west: float, north: float, res: float,
                   patch: int, margin: int, series_res: float) -> list[tuple[int, int, int]]:
    """(row, col, size) on the series grid of each tile of
    ``reference/zonal.py tiles`` (the same tiles in the same order): the
    tile's box as that grid lays it, its corners inverted on the series
    grid, the offsets floored and the size rounded as a windowed read
    does. (A box's offset on the aerial grid, scaled, can fall on the
    other side of a whole series pixel, so the box itself is used.)"""
    min_x, max_y = west, north
    max_x = res * width + 0.0 * height + west
    min_y = 0.0 * width + -res * height + north
    geo_output, geo_margin = patch * res, margin * res
    geo_step = (patch - 2 * margin) * res
    series = (series_res, 0.0, west, 0.0, -series_res, north)
    out, existing = [], set()
    for x_coord in np.arange(min_x - geo_margin, max_x + geo_margin, geo_step):
        for y_coord in np.arange(min_y - geo_margin, max_y + geo_margin, geo_step):
            if x_coord + geo_output > max_x + geo_margin:
                x_coord = max_x + geo_margin - geo_output
            if y_coord + geo_output > max_y + geo_margin:
                y_coord = max_y + geo_margin - geo_output
            left = x_coord + geo_margin
            right = min(x_coord + geo_output - geo_margin, max_x)
            bottom = y_coord + geo_margin
            top = min(y_coord + geo_output - geo_margin, max_y)
            key = tuple(round(v, 6) for v in (left, bottom, right, top))
            if key in existing:
                continue
            existing.add(key)
            if right - left > 0 and top - bottom > 0:
                box = (float(x_coord), float(y_coord), float(x_coord + geo_output),
                       float(y_coord + geo_output))
                c0, r0 = zref._invert(series, box[0], box[3])
                c1, _ = zref._invert(series, box[2], box[1])
                out.append((int(math.floor(r0 + 1e-9)), int(math.floor(c0 + 1e-9)),
                            int(round(c1 - c0))))
    return out


def tile_series(series: np.ndarray, mask: np.ndarray, offsets: np.ndarray, row: int,
                col: int, size: int, channels: int) -> tuple[np.ndarray, np.ndarray]:
    """A tile's kept frames (T', channels, size, size) float32 and their day
    offsets, from the (T x channels, H, W) series and (T x 2, H, W) mask."""
    frames = window(series, row, col, size).reshape(-1, channels, size, size)
    keep = kept_dates(window(mask, row, col, size).reshape(-1, 2, size, size))
    return frames[keep].astype(np.float32), offsets[keep]


def pad_batch(items: list) -> tuple[np.ndarray, np.ndarray]:
    """A batch of (frames, offsets) padded with zero frames and zero
    offsets to its largest date count: (B, T, C, h, w), (B, T)."""
    t = max(len(f) for f, _ in items)
    frames = np.zeros((len(items), t, *items[0][0].shape[1:]), np.float32)
    dates = np.zeros((len(items), t), np.float32)
    for i, (f, d) in enumerate(items):
        frames[i, :len(f)] = f
        dates[i, :len(d)] = d
    return frames, dates
