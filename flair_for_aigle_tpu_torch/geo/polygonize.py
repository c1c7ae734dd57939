"""Raster -> polygon extraction (native tracer + GEOS assembly).

Replaces the reference's rasterio.features.shapes/multiprocessing path
(flair_zonal_detection/inference.py:359-413): per class, the native tracer
(native/polygonize.cc) produces pixel-space boundary rings per 4-connected
region; here rings become georeferenced GEOS polygons (shell = largest
|area| ring, others = holes).
"""

from __future__ import annotations

import ctypes
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Sequence

import numpy as np

from flair_for_aigle_tpu_torch.geo import geos
from flair_for_aigle_tpu_torch.geo.native import load as load_native
from flair_for_aigle_tpu_torch.geo.windows import Affine

logger = logging.getLogger(__name__)


def _rings_for_class(data: np.ndarray, cls: int) -> list[list[np.ndarray]]:
    """Run the native tracer; returns [region -> [ring (N,2) px coords]]."""
    lib = load_native()
    arr = np.ascontiguousarray(data.astype(np.uint8))
    h, w = arr.shape
    cap = 16 + 8 * (w * h + 4 * (w + h))  # generous: boundary-bound heuristic
    buf = np.empty(cap, np.int64)
    n = lib.plg_polygonize(
        arr.ctypes.data_as(ctypes.c_void_p), w, h, cls,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
    )
    if n < 0:  # retry with exact size
        need = lib.plg_polygonize(
            arr.ctypes.data_as(ctypes.c_void_p), w, h, cls, None, 0
        )
        buf = np.empty(need, np.int64)
        n = lib.plg_polygonize(
            arr.ctypes.data_as(ctypes.c_void_p), w, h, cls,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), need,
        )
    pos = 0
    n_regions = int(buf[pos]); pos += 1
    regions = []
    for _ in range(n_regions):
        _rid = int(buf[pos]); pos += 1
        n_rings = int(buf[pos]); pos += 1
        rings = []
        for _ in range(n_rings):
            npts = int(buf[pos]); pos += 1
            pts = buf[pos:pos + 2 * npts].reshape(npts, 2).copy()
            pos += 2 * npts
            rings.append(pts)
        regions.append(rings)
    return regions


def _ring_area(pts: np.ndarray) -> float:
    x, y = pts[:, 0].astype(float), pts[:, 1].astype(float)
    return 0.5 * float(np.sum(x[:-1] * y[1:] - x[1:] * y[:-1]))


def polygons_for_class(
    data: np.ndarray,
    cls: int,
    transform: Affine,
    min_area: float = 1.0,
    simplification: float = 0.1,
) -> list[geos.Geometry]:
    """Georeferenced polygons of one class value with area/simplify filters
    (reference _extract_polygons_for_class, inference.py:359-375)."""
    out = []
    for rings in _rings_for_class(data, cls):
        if not rings:
            continue
        geo_rings = []
        for pts in rings:
            xs = transform.a * pts[:, 0] + transform.b * pts[:, 1] + transform.c
            ys = transform.d * pts[:, 0] + transform.e * pts[:, 1] + transform.f
            geo_rings.append((abs(_ring_area(pts)), list(zip(xs, ys))))
        geo_rings.sort(key=lambda t: -t[0])
        shell = geo_rings[0][1]
        holes = [r for _, r in geo_rings[1:]]
        try:
            poly = geos.polygon(shell, holes)
            if not poly.is_valid:
                poly = poly.make_valid()
        except ValueError:
            continue
        if poly.is_empty or poly.area < min_area:
            continue
        if simplification > 0:
            poly = poly.simplify(simplification, preserve_topology=True)
        out.append(poly)
    return out


def raster_to_polygons(
    data: np.ndarray,
    transform: Affine,
    ignore_background: bool = True,
    background_value: int = 18,
    min_area: float = 1.0,
    simplification: float = 0.1,
    n_jobs: int | None = None,
) -> list[dict]:
    """All classes -> [{'class_id', 'geometry'}] (reference
    raster_to_polygons, inference.py:377-413)."""
    classes = np.unique(data)
    if ignore_background:
        classes = classes[classes != background_value]
    results: list[dict] = []

    def work(cls):
        return [
            {"class_id": int(cls), "geometry": g}
            for g in polygons_for_class(data, int(cls), transform,
                                        min_area, simplification)
        ]

    if n_jobs and n_jobs > 1:
        with ThreadPoolExecutor(max_workers=n_jobs) as pool:
            for chunk in pool.map(work, classes):
                results.extend(chunk)
    else:
        for cls in classes:
            results.extend(work(cls))
    return results
