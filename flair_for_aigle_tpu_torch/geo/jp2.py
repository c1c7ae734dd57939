"""JPEG2000 raster reader (GeoJP2) with the RasterReader surface.

The reference's production inputs are .jp2 VHR aerial rasters
(scripts/run_fast_aigle_segmentation.py:88). Decode runs through
native/jp2io.cc (libopenjp2 windowed decode); georeferencing comes from the
GeoJP2 uuid box — a degenerate embedded GeoTIFF whose tags
(ModelPixelScale/ModelTiepoint/GeoKeyDirectory) are parsed here with a
minimal pure-python TIFF tag walker.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Sequence

import numpy as np

from flair_for_aigle_tpu_torch.geo.native import load as load_native
from flair_for_aigle_tpu_torch.geo.windows import Affine, Window, array_bounds

GEOTIFF_UUID = bytes.fromhex("b14bf8bd083d4b43a5ae8cd7d5a6ce03")


def _declare(lib):
    if getattr(lib, "_jp2_declared", False):
        return lib
    lib.jp2_info.restype = ctypes.c_int
    lib.jp2_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.jp2_read_window.restype = ctypes.c_int
    lib.jp2_read_window.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.jp2_available.restype = ctypes.c_int
    lib._jp2_declared = True
    return lib


def _iter_boxes(data: bytes, offset: int = 0, end: int | None = None):
    end = len(data) if end is None else end
    pos = offset
    while pos + 8 <= end:
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        btype = data[pos + 4:pos + 8]
        header = 8
        if length == 1:
            (length,) = struct.unpack(">Q", data[pos + 8:pos + 16])
            header = 16
        elif length == 0:
            length = end - pos
        yield btype, pos + header, pos + length
        pos += max(length, header)


def _parse_embedded_geotiff(buf: bytes):
    """Extract (transform, epsg) from a degenerate GeoTIFF byte blob."""
    if buf[:2] == b"II":
        e = "<"
    elif buf[:2] == b"MM":
        e = ">"
    else:
        return None, None
    (ifd_off,) = struct.unpack(e + "I", buf[4:8])
    (n_entries,) = struct.unpack(e + "H", buf[ifd_off:ifd_off + 2])
    tags = {}
    for i in range(n_entries):
        o = ifd_off + 2 + i * 12
        tag, ttype, count = struct.unpack(e + "HHI", buf[o:o + 8])
        size = {1: 1, 2: 1, 3: 2, 4: 4, 11: 4, 12: 8}.get(ttype, 1) * count
        if size <= 4:
            raw = buf[o + 8:o + 8 + size]
        else:
            (voff,) = struct.unpack(e + "I", buf[o + 8:o + 12])
            raw = buf[voff:voff + size]
        if ttype == 12:  # double
            tags[tag] = struct.unpack(e + f"{count}d", raw)
        elif ttype == 3:  # short
            tags[tag] = struct.unpack(e + f"{count}H", raw)
    transform = None
    if 33550 in tags and 33922 in tags:
        sx, sy = tags[33550][0], tags[33550][1]
        i, j, _, x, y, _ = tags[33922][:6]
        transform = Affine(sx, 0.0, x - i * sx, 0.0, -sy, y + j * sy)
    epsg = None
    keys = tags.get(34735)
    if keys and len(keys) >= 4:
        n = keys[3]
        for k in range(1, n + 1):
            if 4 * k + 3 >= len(keys):
                break
            kid, loc, _, val = keys[4 * k:4 * k + 4]
            if kid in (3072, 2048) and loc == 0 and 0 < val < 32767:
                epsg = val
                if kid == 3072:
                    break
    return transform, epsg


def read_geojp2_metadata(path: str):
    """(transform, crs) from the GeoJP2 uuid box; identity if absent."""
    with open(path, "rb") as f:
        data = f.read(4 * 1024 * 1024)  # boxes live in the header region
    for btype, start, end in _iter_boxes(data):
        if btype == b"uuid" and data[start:start + 16] == GEOTIFF_UUID:
            transform, epsg = _parse_embedded_geotiff(data[start + 16:end])
            if transform is not None:
                return transform, (f"EPSG:{epsg}" if epsg else None)
    return Affine(1.0, 0.0, 0.0, 0.0, -1.0, 0.0), None


def jp2_available() -> bool:
    return bool(_declare(load_native()).jp2_available())


class Jp2Reader:
    """RasterReader-surface reader for JPEG2000 (windowed native decode)."""

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self._lib = _declare(load_native())
        if not self._lib.jp2_available():
            raise RuntimeError("libopenjp2.so.7 unavailable; cannot read JP2")
        info = (ctypes.c_int64 * 5)()
        rc = self._lib.jp2_info(path.encode(), info)
        if rc != 0:
            raise OSError(f"cannot open JP2 ({rc}): {path}")
        self.path = path
        self.width, self.height = int(info[0]), int(info[1])
        self.count = int(info[2])
        prec, sgnd = int(info[3]), int(info[4])
        if prec <= 8:
            dt = np.int8 if sgnd else np.uint8
        elif prec <= 16:
            dt = np.int16 if sgnd else np.uint16
        else:
            dt = np.int32
        self.dtypes = [np.dtype(dt)] * self.count
        self.transform, self.crs = read_geojp2_metadata(path)

    @property
    def shape(self):
        return (self.height, self.width)

    @property
    def res(self):
        return (abs(self.transform.a), abs(self.transform.e))

    @property
    def bounds(self):
        from flair_for_aigle_tpu_torch.geo.geotiff import BoundingBox

        left, bottom, right, top = array_bounds(self.height, self.width,
                                                self.transform)
        return BoundingBox(left, bottom, right, top)

    @property
    def profile(self):
        return {"driver": "JP2OpenJPEG", "width": self.width,
                "height": self.height, "count": self.count,
                "dtype": str(self.dtypes[0]), "crs": self.crs,
                "transform": self.transform}

    def read(self, indexes: Sequence[int] | int | None = None,
             window: Window | None = None, out_shape=None,
             resampling: str = "nearest", boundless: bool = False,
             fill_value: float = 0) -> np.ndarray:
        from flair_for_aigle_tpu_torch.geo.geotiff import _resample_chw

        squeeze = False
        if indexes is None:
            indexes = list(range(1, self.count + 1))
        elif isinstance(indexes, int):
            indexes = [indexes]
            squeeze = True
        if window is None:
            win = Window(0, 0, self.width, self.height).round()
        else:
            win = window.round()
        c0, r0 = int(win.col_off), int(win.row_off)
        c1, r1 = c0 + int(win.width), r0 + int(win.height)
        ic0, ir0 = max(0, c0), max(0, r0)
        ic1, ir1 = min(self.width, c1), min(self.height, r1)
        iw, ih = max(0, ic1 - ic0), max(0, ir1 - ir0)

        full = np.zeros((self.count, ih, iw), np.int32)
        if iw > 0 and ih > 0:
            rc = self._lib.jp2_read_window(
                self.path.encode(), ic0, ir0, iw, ih,
                full.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            if rc != 0:
                raise OSError(f"JP2 decode failed ({rc}): {self.path}")
        sel = full[[i - 1 for i in indexes]].astype(self.dtypes[0])
        if boundless:
            out = np.full((len(indexes), r1 - r0, c1 - c0), fill_value,
                          self.dtypes[0])
            out[:, ir0 - r0:ir0 - r0 + ih, ic0 - c0:ic0 - c0 + iw] = sel
        else:
            out = np.ascontiguousarray(sel)
        if out_shape is not None and tuple(out.shape) != tuple(out_shape):
            out = _resample_chw(out, out_shape[-2], out_shape[-1], resampling)
        if squeeze and out.shape[0] == 1:
            out = out[0]
        return out

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_jp2(path: str, components: Sequence[np.ndarray],
              dx: Sequence[int] | None = None,
              dy: Sequence[int] | None = None, prec: int = 8,
              transform: Affine | None = None,
              crs: str | None = None) -> None:
    """Lossless JP2 encode of planar components via native/jp2io.cc.

    Each component may carry its own sampling factors (dx/dy > 1 =
    subsampled, at size ceil(H/dy) x ceil(W/dx) of the reference grid set
    by component 0). Used for test fixtures (production IGN JP2s have
    subsampled chroma) and JP2 export.
    """
    lib = _declare(load_native())
    if not lib.jp2_available():
        raise RuntimeError("libopenjp2.so.7 unavailable; cannot write JP2")
    n = len(components)
    dx = list(dx or [1] * n)
    dy = list(dy or [1] * n)
    h, w = components[0].shape
    flat = np.concatenate(
        [np.ascontiguousarray(c, np.int32).ravel() for c in components]
    ).astype(np.int32)
    dxa = np.asarray(dx, np.int32)
    dya = np.asarray(dy, np.int32)
    rc = lib.jp2_write(
        path.encode(), flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(w), int(h), n, dxa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dya.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), int(prec),
    )
    if rc != 0:
        raise OSError(f"JP2 encode failed ({rc}): {path}")
    if transform is not None and crs is not None:
        append_geojp2_box(path, transform, crs)


def append_geojp2_box(path: str, transform: Affine, crs: str) -> None:
    """Append a GeoJP2 uuid box to an existing .jp2 (test/tooling helper:
    PIL writes plain JP2s without georeferencing)."""
    import tempfile

    from flair_for_aigle_tpu_torch.geo.geotiff import write_geotiff

    with tempfile.NamedTemporaryFile(suffix=".tif", delete=False) as tmp:
        tmp_path = tmp.name
    try:
        write_geotiff(tmp_path, np.zeros((1, 1, 1), np.uint8), transform, crs,
                      compress=None, tile_size=16)
        payload = open(tmp_path, "rb").read()
    finally:
        os.remove(tmp_path)
    box = struct.pack(">I", 8 + 16 + len(payload)) + b"uuid" + GEOTIFF_UUID + payload
    with open(path, "ab") as f:
        f.write(box)
