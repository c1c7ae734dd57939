"""Affine transforms, bounds and pixel windows (rasterio-surface subset).

Pure-python replacements for the affine/rasterio helpers the reference leans
on: ``Affine`` (GDAL-style geotransform), ``Window``,
``from_bounds`` (rasterio.windows.from_bounds — flair_zonal_detection/
dataset.py:98), ``array_bounds`` (rasterio.transform.array_bounds —
slicing.py:48-49) and ``from_origin``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Affine:
    """North-up affine transform: x = a*col + c ; y = e*row + f.

    Stored GDAL-style as (c, a, b, f, d, e) is confusing; we use rasterio's
    (a, b, c, d, e, f) row-major 2x3: x = a*col + b*row + c; y = d*col +
    e*row + f.
    """

    a: float  # pixel width
    b: float
    c: float  # x origin (left)
    d: float
    e: float  # pixel height (negative for north-up)
    f: float  # y origin (top)

    def __mul__(self, colrow):
        col, row = colrow
        return (self.a * col + self.b * row + self.c,
                self.d * col + self.e * row + self.f)

    def invert(self, x, y):
        det = self.a * self.e - self.b * self.d
        col = (self.e * (x - self.c) - self.b * (y - self.f)) / det
        row = (-self.d * (x - self.c) + self.a * (y - self.f)) / det
        return col, row

    @classmethod
    def from_gdal(cls, gt):
        # GDAL order: (x0, dx, rx, y0, ry, dy)
        return cls(gt[1], gt[2], gt[0], gt[4], gt[5], gt[3])

    def to_gdal(self):
        return (self.c, self.a, self.b, self.f, self.d, self.e)


def from_origin(west: float, north: float, xsize: float, ysize: float) -> Affine:
    """rasterio.transform.from_origin equivalent."""
    return Affine(xsize, 0.0, west, 0.0, -ysize, north)


@dataclass(frozen=True)
class Window:
    col_off: float
    row_off: float
    width: float
    height: float

    def round(self) -> "Window":
        return Window(
            int(math.floor(self.col_off + 1e-9)),
            int(math.floor(self.row_off + 1e-9)),
            int(round(self.width)),
            int(round(self.height)),
        )


def from_bounds(left, bottom, right, top, transform: Affine) -> Window:
    """rasterio.windows.from_bounds equivalent (north-up transforms)."""
    col_lo, row_lo = transform.invert(left, top)
    col_hi, row_hi = transform.invert(right, bottom)
    return Window(col_lo, row_lo, col_hi - col_lo, row_hi - row_lo)


def array_bounds(height: int, width: int, transform: Affine):
    """rasterio.transform.array_bounds: (left, bottom, right, top)."""
    left, top = transform * (0, 0)
    right, bottom = transform * (width, height)
    return left, bottom, right, top


def bounds_of(transform: Affine, width: int, height: int):
    return array_bounds(height, width, transform)
