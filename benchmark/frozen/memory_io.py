"""In-memory raster IO for the zonal engine, on a machine without libtiff
or GEOS (the card machine is one).

Frozen copy of ``flair_for_aigle_tpu_torch/zonal/memory_io.py``
``memory_host_io`` and of ``geo/geotiff.py MemoryRaster.read``, so that a
later change of the port cannot make the benchmark's IO faster: a
dict-backed store stands in for ``geotiff.RasterReader`` (the reader
behind ``open_raster``), ``geotiff.write_geotiff`` (called when a
``WindowedWriter`` closes) and ``geos.box`` (the tile boxes, bounds only).
Unlike the original, nothing at all is written to disk: a written raster
lives in the store until the caller takes it.
"""

from __future__ import annotations

import contextlib
from collections import namedtuple

import numpy as np

BoundingBox = namedtuple("BoundingBox", ("left", "bottom", "right", "top"))


class Store:
    """path -> (array (bands, rows, cols), transform, crs)."""

    def __init__(self):
        self.rasters: dict = {}

    def put(self, path: str, array: np.ndarray, transform, crs: str) -> None:
        self.rasters[path] = (array[None] if array.ndim == 2 else array, transform, crs)

    def take(self, path: str) -> np.ndarray:
        return self.rasters.pop(path)[0]

    def drop(self, path: str) -> None:
        self.rasters.pop(path, None)


def _window_bounds(win):
    c0 = int(np.floor(win.col_off + 1e-9))
    r0 = int(np.floor(win.row_off + 1e-9))
    return c0, r0, c0 + int(round(win.width)), r0 + int(round(win.height))


def reader_class(store: Store):
    class StoredRaster:
        def __init__(self, path: str):
            arr, transform, crs = store.rasters[path]
            self.path = path
            self.count, self.height, self.width = arr.shape
            self.dtypes = [arr.dtype] * self.count
            self.transform, self.crs = transform, crs
            self.block_rows = 1
            self._data = arr

        @property
        def shape(self):
            return (self.height, self.width)

        @property
        def res(self):
            return (abs(self.transform.a), abs(self.transform.e))

        @property
        def bounds(self):
            t = self.transform
            left, top = t * (0, 0)
            right, bottom = t * (self.width, self.height)
            return BoundingBox(left, bottom, right, top)

        def read(self, indexes=None, window=None, out_shape=None, resampling="nearest",
                 boundless=False, fill_value=0):
            if out_shape is not None:
                raise NotImplementedError("the benchmark's rasters are read at their size")
            squeeze = False
            if indexes is None:
                indexes = list(range(1, self.count + 1))
            elif isinstance(indexes, int):
                indexes = [indexes]
                squeeze = True
            bands = [i - 1 for i in indexes]
            if window is None:
                c0, r0, c1, r1 = 0, 0, self.width, self.height
            else:
                c0, r0, c1, r1 = _window_bounds(window)
            if boundless:
                out = np.full((len(bands), r1 - r0, c1 - c0), fill_value, self.dtypes[0])
                ic0, ir0 = max(0, c0), max(0, r0)
                ic1, ir1 = min(self.width, c1), min(self.height, r1)
                if ic0 < ic1 and ir0 < ir1:
                    out[:, ir0 - r0:ir1 - r0, ic0 - c0:ic1 - c0] = (
                        self._data[:, ir0:ir1, ic0:ic1][bands])
            else:
                c0, r0 = max(0, c0), max(0, r0)
                c1, r1 = min(self.width, c1), min(self.height, r1)
                out = np.ascontiguousarray(self._data[:, r0:r1, c0:c1][bands])
            if squeeze and out.shape[0] == 1:
                out = out[0]
            return out

        def close(self):
            self._data = None

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.close()

    return StoredRaster


class Box:
    """A tile box of which the engine reads the bounds alone."""

    def __init__(self, *bounds):
        self.bounds = tuple(float(v) for v in bounds)


@contextlib.contextmanager
def installed(store: Store):
    """The port's raster reader, GeoTIFF writer and tile box replaced by the
    store's for the duration."""
    from flair_for_aigle_tpu_torch.geo import geos, geotiff

    def write_geotiff(path, array, transform=None, crs=None, compress="lzw",
                      tile_size=256, overviews=0):
        store.put(path, np.ascontiguousarray(array), transform, crs)

    saved = (geotiff.RasterReader, geotiff.write_geotiff, geos.box)
    geotiff.RasterReader, geotiff.write_geotiff, geos.box = (
        reader_class(store), write_geotiff, Box)
    try:
        yield store
    finally:
        geotiff.RasterReader, geotiff.write_geotiff, geos.box = saved
