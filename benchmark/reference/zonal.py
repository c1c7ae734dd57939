"""The zonal reference: which tiles a dalle is cut into, where each reads
and writes, which tile owns each output pixel, and by how much the label
the system wrote lies below the plain reference's best class.

The tile grid is a frozen copy of the arithmetic of the reference engine
(flair-for-aigle ``slicing.py:20-121``, as the port's ``zonal/slicing.py``
has it): stride ``(patch - 2 margin) * res``, edge tiles snapped back into
the raster-plus-margin frame, tiles deduplicated by their rounded inner
bounds; the read window of a tile is its box on the raster grid (floored
offsets), its inner tile lands at its inner bounds' rounded offsets, and
tiles are stitched bottom-up, left to right, the last write winning.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Tile:
    read_row: int  # offsets of the patch box on the raster grid
    read_col: int
    top: int  # offsets of the inner tile in the output raster
    left: int


def _invert(transform, x, y):
    """Column and row of (x, y) under a north-up affine transform, with
    the same operations as the engine's ``Affine.invert``."""
    a, b, c, d, e, f = transform
    det = a * e - b * d
    return (e * (x - c) - b * (y - f)) / det, (-d * (x - c) + a * (y - f)) / det


def tiles(height: int, width: int, west: float, north: float, res: float,
          patch: int, margin: int) -> list[Tile]:
    """The tiles of a raster, in the slicer's order."""
    transform = (res, 0.0, west, 0.0, -res, north)
    ref_l, ref_t = west, north
    ref_r = res * width + 0.0 * height + west
    ref_b = 0.0 * width + -res * height + north
    geo_output = patch * res
    geo_margin = margin * res
    geo_step = (patch - 2 * margin) * res
    min_x, min_y, max_x, max_y = ref_l, ref_b, ref_r, ref_t
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
                col, row = _invert(transform, box[0], box[3])
                out.append(Tile(int(math.floor(row + 1e-9)), int(math.floor(col + 1e-9)),
                                int(round((ref_t - float(top)) / res)),
                                int(round((float(left) - ref_l) / res))))
    return out


def stitch_order(ts: list[Tile]) -> np.ndarray:
    """Bottom-up, then left to right."""
    tops = np.array([t.top for t in ts])
    lefts = np.array([t.left for t in ts])
    return np.lexsort((lefts, -tops))


def owners(ts: list[Tile], height: int, width: int, inner: int) -> np.ndarray:
    """(height, width) index of the tile whose write each pixel keeps (-1:
    none), writes clamped into a canvas padded by one tile."""
    canvas = np.full((height + inner, width + inner), -1, np.int32)
    for i in stitch_order(ts):
        t = ts[i]
        oy = min(max(t.top, 0), canvas.shape[0] - inner)
        ox = min(max(t.left, 0), canvas.shape[1] - inner)
        canvas[oy:oy + inner, ox:ox + inner] = i
    return canvas[:height, :width]


def tile_batch(padded: torch.Tensor, ts: list[Tile], margin: int, patch: int) -> torch.Tensor:
    """(B, C, patch, patch) patches of a margin-padded raster, offsets
    clamped into it."""
    hmax, wmax = padded.shape[-2] - patch, padded.shape[-1] - patch
    out = []
    for t in ts:
        r = min(max(t.read_row + margin, 0), hmax)
        c = min(max(t.read_col + margin, 0), wmax)
        out.append(padded[:, r:r + patch, c:c + patch])
    return torch.stack(out)


def normalised_padded(pixels: np.ndarray, means, stds, margin: int,
                      device: torch.device) -> torch.Tensor:
    """(bands, rows + 2 margin, cols + 2 margin) float32: the raster padded
    with zero pixels, then normalised, margin and all."""
    x = torch.from_numpy(np.ascontiguousarray(pixels)).to(device)
    mean = torch.tensor(means, dtype=torch.float32, device=device)[:, None, None]
    std = torch.tensor(stds, dtype=torch.float32, device=device)[:, None, None]
    return (F.pad(x.float(), (margin, margin, margin, margin)) - mean) / std


@torch.no_grad()
def label_gaps(model, pixels: np.ndarray, labels: np.ndarray, west: float, north: float,
               res: float, patch: int, margin: int, means, stds, batch: int,
               device: torch.device) -> dict:
    """The written ``labels`` (height, width) of a dalle against the
    reference ``model`` (float32, NCHW logits at the patch's size) on its
    ``pixels`` (bands, height, width) uint8. Returns the widest gap of a
    written label below the reference's best logit, the share of labels
    that differ from the reference's argmax, and the pixels left unwritten
    though a tile owns them or written though none does."""
    bands, height, width = pixels.shape
    inner = patch - 2 * margin
    ts = tiles(height, width, west, north, res, patch, margin)
    own = owners(ts, height, width, inner)
    padded = normalised_padded(pixels, means, stds, margin, device)
    lab = torch.from_numpy(np.ascontiguousarray(labels)).to(device).long()
    own_t = torch.from_numpy(own).to(device)
    widest = torch.zeros((), device=device)
    differ = torch.zeros((), dtype=torch.long, device=device)
    checked = 0
    for s in range(0, len(ts), batch):
        chunk = ts[s:s + batch]
        logits = model(tile_batch(padded, chunk, margin, patch))[..., margin:patch - margin,
                                                                  margin:patch - margin]
        for j, t in enumerate(chunk):
            i = s + j
            oy, ox = min(max(t.top, 0), height), min(max(t.left, 0), width)
            h, w = min(inner, height - oy), min(inner, width - ox)
            if h <= 0 or w <= 0:
                continue
            mask = own_t[oy:oy + h, ox:ox + w] == i
            lg = logits[j, :, :h, :w]
            best = lg.max(dim=0).values
            got = lg.gather(0, lab[oy:oy + h, ox:ox + w][None].clamp(0, lg.shape[0] - 1))[0]
            bad_class = lab[oy:oy + h, ox:ox + w] >= lg.shape[0]
            gap = torch.where(bad_class, torch.full_like(best, float("inf")), best - got)
            widest = torch.maximum(widest, torch.where(mask, gap, 0.0).max())
            differ += (mask & (lg.argmax(dim=0) != lab[oy:oy + h, ox:ox + w])).sum()
            checked += int(mask.sum())
    unowned_written = int(((own_t < 0) & (lab != 0)).sum())
    return {"widest_gap": float(widest), "differ_share": float(differ) / max(checked, 1),
            "checked_pixels": checked, "unowned_written": unowned_written,
            "tiles": len(ts)}
