"""Coordinate reference system transforms over libproj (ctypes).

Replaces the reference's pyproj/geopandas ``to_crs`` usage (e.g. the
EPSG:2154 -> EPSG:4326 reprojection before Aigle export,
scripts/run_fast_aigle_segmentation.py:165).
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache

import numpy as np

_lock = threading.Lock()
_lib = None
_ctx = None

_PJ_FWD = 1


def _load():
    global _lib, _ctx
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL("libproj.so.25")
            lib.proj_context_create.restype = ctypes.c_void_p
            lib.proj_create_crs_to_crs.restype = ctypes.c_void_p
            lib.proj_create_crs_to_crs.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p
            ]
            lib.proj_normalize_for_visualization.restype = ctypes.c_void_p
            lib.proj_normalize_for_visualization.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p
            ]
            lib.proj_trans_generic.restype = ctypes.c_size_t
            lib.proj_trans_generic.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
            ]
            lib.proj_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
            _ctx = lib.proj_context_create()
        return _lib, _ctx


@lru_cache(maxsize=64)
def _pipeline(src: str, dst: str):
    lib, ctx = _load()
    pj = lib.proj_create_crs_to_crs(ctx, src.encode(), dst.encode(), None)
    if not pj:
        raise ValueError(f"cannot create transform {src} -> {dst}")
    norm = lib.proj_normalize_for_visualization(ctx, pj)
    if norm:
        lib.proj_destroy(pj)
        pj = norm
    return pj


class Transformer:
    """pyproj.Transformer-like x/y array transform (always_xy semantics)."""

    def __init__(self, src_crs: str, dst_crs: str):
        self.src, self.dst = str(src_crs), str(dst_crs)
        self._pj = _pipeline(self.src, self.dst)

    def transform(self, xs, ys):
        lib, _ = _load()
        x = np.ascontiguousarray(np.asarray(xs, np.float64).ravel())
        y = np.ascontiguousarray(np.asarray(ys, np.float64).ravel())
        n = x.size
        xo = x.copy()
        yo = y.copy()
        lib.proj_trans_generic(
            self._pj, _PJ_FWD,
            xo.ctypes.data_as(ctypes.c_void_p), 8, n,
            yo.ctypes.data_as(ctypes.c_void_p), 8, n,
            None, 0, 0, None, 0, 0,
        )
        return xo, yo


def transform_geometry(geom, src_crs: str, dst_crs: str):
    """Reproject a geo.geos Geometry between CRSs."""
    if str(src_crs) == str(dst_crs):
        return geom
    tr = Transformer(src_crs, dst_crs)
    return geom.transform(lambda xs, ys: tr.transform(xs, ys))
