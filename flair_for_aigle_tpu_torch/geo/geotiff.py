"""GeoTIFF IO with a rasterio-like surface, backed by native libtiff.

Covers the rasterio usage of the reference stack:
* windowed reads with per-modality out_shape resampling, ``boundless=True,
  fill_value=0`` (flair_zonal_detection/dataset.py:108-115),
* whole-file reads for training patches (flair_hub/data/utils_data/io.py),
* LZW tiled GeoTIFF outputs and COG conversion
  (flair_zonal_detection/inference.py:157-208, postprocess.py:33-52).

Writers buffer a full in-memory canvas (the zonal engine stitches on device
and lands the canvas here once per raster — SURVEY.md section 7 design) and
emit a tiled compressed GeoTIFF (+ optional reduced-resolution overviews =
COG-style layout) at close.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from flair_for_aigle_tpu_torch.geo.native import load as load_native
from flair_for_aigle_tpu_torch.geo.windows import Affine, Window, array_bounds

_DTYPES = {
    0: np.uint8, 1: np.uint16, 2: np.int16, 3: np.uint32, 4: np.int32,
    5: np.float32, 6: np.float64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
_COMPRESSION = {None: 0, "none": 0, "lzw": 5, "deflate": 8}


@dataclass
class BoundingBox:
    left: float
    bottom: float
    right: float
    top: float

    def __iter__(self):
        return iter((self.left, self.bottom, self.right, self.top))


class RasterReader:
    """Windowed reader; open with ``open_raster`` (context-manager friendly).

    Thread-safe reads: libtiff TIFF* handles are single-threaded, so each
    reading thread gets its own handle (opened lazily on first read) — the
    multi-worker ``BatchedLoader`` reads tiles concurrently.
    """

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        import threading

        self._lib = load_native()
        self._handles_lock = threading.Lock()
        self._handles: list = []
        self._tls = threading.local()
        self._closed = False
        self.path = path
        self._h = self._thread_handle()
        info = (ctypes.c_int64 * 8)()
        gt = (ctypes.c_double * 6)()
        self._lib.gt_info(self._h, info, gt)
        self.width = int(info[0])
        self.height = int(info[1])
        self.count = int(info[2])
        self.dtypes = [np.dtype(_DTYPES[int(info[3])])] * self.count
        self._dtype_code = int(info[3])
        # decode granularity: tile height (tiled) or rows-per-strip. Reads
        # decode whole tiles/strips with no cache, so row-aligned consumers
        # (the zonal resident path) stripe on multiples of this to decode
        # each tile exactly once.
        self.block_rows = int(info[7]) or 1
        epsg = int(info[4])
        self.crs = f"EPSG:{epsg}" if epsg else None
        # native returns GDAL-ish (x0, dx, rx, y0, ry, dy) packed as
        # transform[0..5] = x0, dx, 0, y0, 0, dy
        t = list(gt)
        self.transform = Affine(t[1], t[2], t[0], t[4], t[5], t[3])

    def _thread_handle(self):
        if self._closed:
            raise OSError(f"raster is closed: {self.path}")
        h = getattr(self._tls, "h", None)
        if h is None:
            h = self._lib.gt_open(self.path.encode())
            if not h:
                raise OSError(f"cannot open raster: {self.path}")
            with self._handles_lock:
                self._handles.append(h)
            self._tls.h = h
        return h

    # -- rasterio-like surface -------------------------------------------
    @property
    def shape(self):
        return (self.height, self.width)

    @property
    def res(self):
        return (abs(self.transform.a), abs(self.transform.e))

    @property
    def bounds(self) -> BoundingBox:
        left, bottom, right, top = array_bounds(
            self.height, self.width, self.transform
        )
        return BoundingBox(left, bottom, right, top)

    @property
    def profile(self) -> dict:
        return {
            "driver": "GTiff",
            "width": self.width,
            "height": self.height,
            "count": self.count,
            "dtype": str(self.dtypes[0]),
            "crs": self.crs,
            "transform": self.transform,
        }

    def read(
        self,
        indexes: Sequence[int] | int | None = None,
        window: Window | None = None,
        out_shape: tuple | None = None,
        resampling: str = "nearest",
        boundless: bool = False,
        fill_value: float = 0,
    ) -> np.ndarray:
        """Read bands (1-based indexes, rasterio convention) as (C, H, W)."""
        squeeze = False
        if indexes is None:
            indexes = list(range(1, self.count + 1))
        elif isinstance(indexes, int):
            indexes = [indexes]
            squeeze = True
        bands = np.asarray([i - 1 for i in indexes], np.int32)
        if window is None:
            win = Window(0, 0, self.width, self.height).round()
        else:
            win = window.round()
        if not boundless:
            # clamp to raster
            c0 = max(0, win.col_off)
            r0 = max(0, win.row_off)
            c1 = min(self.width, win.col_off + win.width)
            r1 = min(self.height, win.row_off + win.height)
            win = Window(c0, r0, max(0, c1 - c0), max(0, r1 - r0))
        out = np.empty((len(bands), win.height, win.width),
                       dtype=self.dtypes[0])
        rc = self._lib.gt_read_window(
            self._thread_handle(),
            bands.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(bands), int(win.col_off), int(win.row_off), int(win.width),
            int(win.height), out.ctypes.data_as(ctypes.c_void_p),
            float(fill_value),
        )
        if rc != 0:
            raise OSError(f"read failed ({rc}) on {self.path}")
        if out_shape is not None and tuple(out.shape) != tuple(out_shape):
            out = _resample_chw(out, out_shape[-2], out_shape[-1], resampling)
        if squeeze and out.shape[0] == 1:
            out = out[0]
        return out

    def close(self):
        if getattr(self, "_closed", True):
            return
        self._closed = True
        with self._handles_lock:
            handles, self._handles = self._handles, []
        for h in handles:
            self._lib.gt_close(h)
        self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _resample_chw(arr: np.ndarray, out_h: int, out_w: int, method: str) -> np.ndarray:
    """Host-side resampling of (C, H, W) reads (bilinear/nearest)."""
    c, h, w = arr.shape
    if (h, w) == (out_h, out_w):
        return arr
    if method in ("nearest", 0):
        idx_h = np.minimum((np.arange(out_h) * h / out_h).astype(int), h - 1)
        idx_w = np.minimum((np.arange(out_w) * w / out_w).astype(int), w - 1)
        return np.ascontiguousarray(arr[:, idx_h][:, :, idx_w])
    # bilinear, half-pixel centers (align_corners=False)
    src_y = np.clip((np.arange(out_h) + 0.5) * h / out_h - 0.5, 0, h - 1)
    src_x = np.clip((np.arange(out_w) + 0.5) * w / out_w - 0.5, 0, w - 1)
    y0 = np.floor(src_y).astype(int)
    x0 = np.floor(src_x).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (src_y - y0)[None, :, None]
    wx = (src_x - x0)[None, None, :]
    a = arr.astype(np.float64)
    top = a[:, y0][:, :, x0] * (1 - wx) + a[:, y0][:, :, x1] * wx
    bot = a[:, y1][:, :, x0] * (1 - wx) + a[:, y1][:, :, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out.astype(arr.dtype if arr.dtype.kind == "f" else np.float64).astype(
        arr.dtype
    ) if arr.dtype.kind != "f" else out.astype(arr.dtype)


def open_raster(path: str):
    if path.lower().endswith((".jp2", ".j2k", ".j2c")):
        from flair_for_aigle_tpu_torch.geo.jp2 import Jp2Reader

        return Jp2Reader(path)
    return RasterReader(path)


def read_patch(raster_file: str, channels: Sequence[int] | None = None) -> np.ndarray:
    """flair_hub/data/utils_data/io.py:4-15 equivalent."""
    with open_raster(raster_file) as src:
        return src.read(list(channels) if channels else None)


def write_geotiff(
    path: str,
    array: np.ndarray,
    transform: Affine | None = None,
    crs: str | None = None,
    compress: str | None = "lzw",
    tile_size: int = 256,
    overviews: int = 0,
) -> None:
    """Write (C, H, W) or (H, W) as a tiled GeoTIFF (optionally COG-style)."""
    lib = load_native()
    arr = np.ascontiguousarray(array)
    if arr.ndim == 2:
        arr = arr[None]
    c, h, w = arr.shape
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    gt = (ctypes.c_double * 6)()
    if transform is not None:
        vals = (transform.c, transform.a, transform.b,
                transform.f, transform.d, transform.e)
        for i, v in enumerate(vals):
            gt[i] = float(v)
    else:
        gt[1] = 1.0
        gt[5] = -1.0
    epsg = 0
    if crs:
        try:
            epsg = int(str(crs).upper().replace("EPSG:", ""))
        except ValueError:
            epsg = 0
    tile = max(16, min(tile_size, 1 << (max(w, h) - 1).bit_length()))
    rc = lib.gt_write(
        path.encode(), arr.ctypes.data_as(ctypes.c_void_p), w, h, c, code,
        tile, _COMPRESSION.get(compress, 5), gt, epsg, overviews,
    )
    if rc != 0:
        raise OSError(f"write failed ({rc}): {path}")


class WindowedWriter:
    """In-memory canvas with rasterio-like windowed writes; lands a tiled
    GeoTIFF at close. Reproduces the reference's last-write-wins windowed
    write semantics (flair_zonal_detection/inference.py:347-352)."""

    def __init__(self, path: str, width: int, height: int, count: int,
                 dtype, transform: Affine | None = None, crs: str | None = None,
                 compress: str | None = "lzw", overviews: int = 0,
                 fill: float = 0):
        self.path = path
        self.width, self.height, self.count = width, height, count
        self.transform, self.crs = transform, crs
        self.compress, self.overviews = compress, overviews
        self.canvas = np.full((count, height, width), fill, dtype=dtype)
        self._closed = False

    def write(self, data: np.ndarray, band: int = 1, window: Window | None = None):
        data = np.asarray(data)
        if window is None:
            window = Window(0, 0, data.shape[-1], data.shape[-2])
        win = window.round()
        self.canvas[
            band - 1,
            win.row_off:win.row_off + win.height,
            win.col_off:win.col_off + win.width,
        ] = data[..., :win.height, :win.width]

    def close(self):
        if self._closed:
            return
        write_geotiff(self.path, self.canvas, self.transform, self.crs,
                      self.compress, overviews=self.overviews)
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def convert_to_cog(input_path: str, output_path: str, blocksize: int = 512) -> None:
    """Reference postprocess.convert_to_cog (:33-52): rewrite as tiled,
    LZW, overview'd GeoTIFF; delete the source."""
    with open_raster(input_path) as src:
        data = src.read()
        transform, crs = src.transform, src.crs
    levels = 0
    d = max(data.shape[-2:])
    while d > blocksize:
        levels += 1
        d //= 2
    write_geotiff(output_path, data, transform, crs, "lzw",
                  tile_size=blocksize, overviews=levels)
    os.remove(input_path)


class MemoryRaster:
    """Raster decoded once into RAM, serving the RasterReader.read surface.

    Overlapping zonal windows re-decode each compressed tile ~2-4x through
    the native reader; for rasters that fit comfortably in memory a single
    full decode is cheaper (enable with the zonal ``preload_rasters`` flag).
    """

    def __init__(self, reader: RasterReader):
        self.path = reader.path
        self.width, self.height, self.count = (
            reader.width, reader.height, reader.count
        )
        self.dtypes = reader.dtypes
        self.crs = reader.crs
        self.transform = reader.transform
        self._data = reader.read()

    shape = RasterReader.shape
    res = RasterReader.res
    bounds = RasterReader.bounds
    profile = RasterReader.profile

    def read(self, indexes=None, window=None, out_shape=None,
             resampling="nearest", boundless=False, fill_value=0):
        squeeze = False
        if indexes is None:
            indexes = list(range(1, self.count + 1))
        elif isinstance(indexes, int):
            indexes = [indexes]
            squeeze = True
        bands = [i - 1 for i in indexes]
        if window is None:
            win = Window(0, 0, self.width, self.height).round()
        else:
            win = window.round()
        c0, r0 = int(win.col_off), int(win.row_off)
        c1, r1 = c0 + int(win.width), r0 + int(win.height)
        if boundless:
            out = np.full((len(bands), r1 - r0, c1 - c0), fill_value,
                          self.dtypes[0])
            ic0, ir0 = max(0, c0), max(0, r0)
            ic1, ir1 = min(self.width, c1), min(self.height, r1)
            if ic0 < ic1 and ir0 < ir1:
                # slice the window BEFORE band fancy-indexing (band-first
                # indexing copies the whole array per read)
                out[:, ir0 - r0:ir1 - r0, ic0 - c0:ic1 - c0] = (
                    self._data[:, ir0:ir1, ic0:ic1][bands]
                )
        else:
            c0, r0 = max(0, c0), max(0, r0)
            c1, r1 = min(self.width, c1), min(self.height, r1)
            out = np.ascontiguousarray(self._data[:, r0:r1, c0:c1][bands])
        if out_shape is not None and tuple(out.shape) != tuple(out_shape):
            out = _resample_chw(out, out_shape[-2], out_shape[-1], resampling)
        if squeeze and out.shape[0] == 1:
            out = out[0]
        return out

    def close(self):
        self._data = None
