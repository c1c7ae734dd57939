"""Minimal shapely-like geometry layer over libgeos_c via ctypes.

Provides the geometry operations the reference uses through shapely/
geopandas: box/Polygon construction, area, bounds, simplify
(topology-preserving), intersects/intersection, unary_union, WKT/WKB,
contains. No headers are installed in this image; the GEOS C API is stable
and declared here directly (libgeos_c.so.1).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterable, Sequence

_lib = None
_lock = threading.Lock()

_NOTICE = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_char_p)


def _load():
    global _lib, _notice_cb, _error_cb
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL("libgeos_c.so.1")
        _notice_cb = _NOTICE(lambda fmt, lst: None)
        _error_cb = _NOTICE(lambda fmt, lst: None)
        lib.initGEOS(_notice_cb, _error_cb)

        lib.GEOSCoordSeq_create.restype = ctypes.c_void_p
        lib.GEOSCoordSeq_create.argtypes = [ctypes.c_uint, ctypes.c_uint]
        lib.GEOSCoordSeq_setX.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_double]
        lib.GEOSCoordSeq_setY.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_double]
        lib.GEOSGeom_createLinearRing.restype = ctypes.c_void_p
        lib.GEOSGeom_createLinearRing.argtypes = [ctypes.c_void_p]
        lib.GEOSGeom_createPolygon.restype = ctypes.c_void_p
        lib.GEOSGeom_createPolygon.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint
        ]
        lib.GEOSGeom_createCollection.restype = ctypes.c_void_p
        lib.GEOSGeom_createCollection.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint
        ]
        lib.GEOSGeom_destroy.argtypes = [ctypes.c_void_p]
        lib.GEOSGeom_clone.restype = ctypes.c_void_p
        lib.GEOSGeom_clone.argtypes = [ctypes.c_void_p]
        lib.GEOSArea.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
        lib.GEOSTopologyPreserveSimplify.restype = ctypes.c_void_p
        lib.GEOSTopologyPreserveSimplify.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.GEOSSimplify.restype = ctypes.c_void_p
        lib.GEOSSimplify.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.GEOSIntersects.restype = ctypes.c_char
        lib.GEOSIntersects.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.GEOSContains.restype = ctypes.c_char
        lib.GEOSContains.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.GEOSIntersection.restype = ctypes.c_void_p
        lib.GEOSIntersection.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.GEOSUnaryUnion.restype = ctypes.c_void_p
        lib.GEOSUnaryUnion.argtypes = [ctypes.c_void_p]
        lib.GEOSisEmpty.restype = ctypes.c_char
        lib.GEOSisEmpty.argtypes = [ctypes.c_void_p]
        lib.GEOSisValid.restype = ctypes.c_char
        lib.GEOSisValid.argtypes = [ctypes.c_void_p]
        lib.GEOSGeomToWKT.restype = ctypes.c_void_p  # char* we must free
        lib.GEOSGeomToWKT.argtypes = [ctypes.c_void_p]
        lib.GEOSGeomFromWKT.restype = ctypes.c_void_p
        lib.GEOSGeomFromWKT.argtypes = [ctypes.c_char_p]
        lib.GEOSGeomTypeId.restype = ctypes.c_int
        lib.GEOSGeomTypeId.argtypes = [ctypes.c_void_p]
        lib.GEOSGetNumGeometries.restype = ctypes.c_int
        lib.GEOSGetNumGeometries.argtypes = [ctypes.c_void_p]
        lib.GEOSGetGeometryN.restype = ctypes.c_void_p
        lib.GEOSGetGeometryN.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.GEOSEnvelope.restype = ctypes.c_void_p
        lib.GEOSEnvelope.argtypes = [ctypes.c_void_p]
        lib.GEOSGetExteriorRing.restype = ctypes.c_void_p
        lib.GEOSGetExteriorRing.argtypes = [ctypes.c_void_p]
        lib.GEOSGetNumInteriorRings.restype = ctypes.c_int
        lib.GEOSGetNumInteriorRings.argtypes = [ctypes.c_void_p]
        lib.GEOSGetInteriorRingN.restype = ctypes.c_void_p
        lib.GEOSGetInteriorRingN.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.GEOSGeom_getCoordSeq.restype = ctypes.c_void_p
        lib.GEOSGeom_getCoordSeq.argtypes = [ctypes.c_void_p]
        lib.GEOSCoordSeq_getSize.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)
        ]
        lib.GEOSCoordSeq_getX.argtypes = [
            ctypes.c_void_p, ctypes.c_uint, ctypes.POINTER(ctypes.c_double)
        ]
        lib.GEOSCoordSeq_getY.argtypes = [
            ctypes.c_void_p, ctypes.c_uint, ctypes.POINTER(ctypes.c_double)
        ]
        lib.GEOSWKBWriter_create.restype = ctypes.c_void_p
        lib.GEOSWKBWriter_write.restype = ctypes.POINTER(ctypes.c_ubyte)
        lib.GEOSWKBWriter_write.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
        ]
        lib.GEOSWKBReader_create.restype = ctypes.c_void_p
        lib.GEOSWKBReader_read.restype = ctypes.c_void_p
        lib.GEOSWKBReader_read.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t
        ]
        lib.GEOSWKBWriter_destroy.argtypes = [ctypes.c_void_p]
        lib.GEOSWKBReader_destroy.argtypes = [ctypes.c_void_p]
        lib.GEOSWKBWriter_create.argtypes = []
        lib.GEOSWKBReader_create.argtypes = []
        lib.GEOSFree.argtypes = [ctypes.c_void_p]
        lib.GEOSMakeValid.restype = ctypes.c_void_p
        lib.GEOSMakeValid.argtypes = [ctypes.c_void_p]
        lib.GEOSBuffer.restype = ctypes.c_void_p
        lib.GEOSBuffer.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_int]
        _lib = lib
        return _lib


class Geometry:
    """Owning wrapper around a GEOSGeometry*."""

    def __init__(self, ptr):
        if not ptr:
            raise ValueError("null geometry")
        self._g = ptr
        self._lib = _load()

    def __del__(self):
        try:
            if getattr(self, "_g", None):
                self._lib.GEOSGeom_destroy(self._g)
                self._g = None
        except Exception:
            pass

    # --- properties ----------------------------------------------------
    @property
    def area(self) -> float:
        out = ctypes.c_double()
        self._lib.GEOSArea(self._g, ctypes.byref(out))
        return out.value

    @property
    def is_empty(self) -> bool:
        return self._lib.GEOSisEmpty(self._g) == b"\x01"

    @property
    def is_valid(self) -> bool:
        return self._lib.GEOSisValid(self._g) == b"\x01"

    @property
    def geom_type(self) -> str:
        tid = self._lib.GEOSGeomTypeId(self._g)
        return {0: "Point", 1: "LineString", 2: "LinearRing", 3: "Polygon",
                4: "MultiPoint", 5: "MultiLineString", 6: "MultiPolygon",
                7: "GeometryCollection"}.get(tid, "Unknown")

    @property
    def wkt(self) -> str:
        p = self._lib.GEOSGeomToWKT(self._g)
        try:
            return ctypes.cast(p, ctypes.c_char_p).value.decode()
        finally:
            self._lib.GEOSFree(p)

    @property
    def wkb(self) -> bytes:
        w = self._lib.GEOSWKBWriter_create()
        size = ctypes.c_size_t()
        p = self._lib.GEOSWKBWriter_write(w, self._g, ctypes.byref(size))
        try:
            return bytes(bytearray(p[: size.value]))
        finally:
            self._lib.GEOSFree(p)
            self._lib.GEOSWKBWriter_destroy(w)

    @property
    def bounds(self):
        env = Geometry(self._lib.GEOSEnvelope(self._g))
        xs, ys = env.exterior_coords()
        return (min(xs), min(ys), max(xs), max(ys))

    def exterior_coords(self):
        g = self._g
        if self.geom_type == "Polygon":
            ring = self._lib.GEOSGetExteriorRing(g)
        else:
            ring = g
        seq = self._lib.GEOSGeom_getCoordSeq(ring)
        n = ctypes.c_uint()
        self._lib.GEOSCoordSeq_getSize(seq, ctypes.byref(n))
        xs, ys = [], []
        x, y = ctypes.c_double(), ctypes.c_double()
        for i in range(n.value):
            self._lib.GEOSCoordSeq_getX(seq, i, ctypes.byref(x))
            self._lib.GEOSCoordSeq_getY(seq, i, ctypes.byref(y))
            xs.append(x.value)
            ys.append(y.value)
        return xs, ys

    def interiors_coords(self):
        out = []
        n = self._lib.GEOSGetNumInteriorRings(self._g)
        for i in range(n):
            ring = self._lib.GEOSGetInteriorRingN(self._g, i)
            seq = self._lib.GEOSGeom_getCoordSeq(ring)
            cnt = ctypes.c_uint()
            self._lib.GEOSCoordSeq_getSize(seq, ctypes.byref(cnt))
            xs, ys = [], []
            x, y = ctypes.c_double(), ctypes.c_double()
            for j in range(cnt.value):
                self._lib.GEOSCoordSeq_getX(seq, j, ctypes.byref(x))
                self._lib.GEOSCoordSeq_getY(seq, j, ctypes.byref(y))
                xs.append(x.value)
                ys.append(y.value)
            out.append((xs, ys))
        return out

    @property
    def geoms(self):
        n = self._lib.GEOSGetNumGeometries(self._g)
        return [
            Geometry(self._lib.GEOSGeom_clone(
                self._lib.GEOSGetGeometryN(self._g, i)))
            for i in range(n)
        ]

    # --- operations -----------------------------------------------------
    def simplify(self, tolerance: float, preserve_topology: bool = True) -> "Geometry":
        fn = (self._lib.GEOSTopologyPreserveSimplify if preserve_topology
              else self._lib.GEOSSimplify)
        return Geometry(fn(self._g, float(tolerance)))

    def intersects(self, other: "Geometry") -> bool:
        return self._lib.GEOSIntersects(self._g, other._g) == b"\x01"

    def contains(self, other: "Geometry") -> bool:
        return self._lib.GEOSContains(self._g, other._g) == b"\x01"

    def intersection(self, other: "Geometry") -> "Geometry":
        return Geometry(self._lib.GEOSIntersection(self._g, other._g))

    def buffer(self, dist: float, quadsegs: int = 8) -> "Geometry":
        return Geometry(self._lib.GEOSBuffer(self._g, float(dist), quadsegs))

    def make_valid(self) -> "Geometry":
        return Geometry(self._lib.GEOSMakeValid(self._g))

    def clone(self) -> "Geometry":
        return Geometry(self._lib.GEOSGeom_clone(self._g))

    def transform(self, fn) -> "Geometry":
        """Apply fn(xs, ys) -> (xs', ys') to every ring (CRS reprojection)."""
        if self.geom_type == "Polygon":
            sx, sy = self.exterior_coords()
            shell = list(zip(*fn(sx, sy)))
            holes = [list(zip(*fn(hx, hy))) for hx, hy in self.interiors_coords()]
            return polygon(shell, holes)
        if self.geom_type in ("MultiPolygon", "GeometryCollection"):
            parts = [g.transform(fn) for g in self.geoms
                     if g.geom_type in ("Polygon", "MultiPolygon")]
            return multipolygon_of(parts)
        raise NotImplementedError(self.geom_type)


def _ring(coords: Sequence[tuple[float, float]]):
    lib = _load()
    pts = list(coords)
    if pts[0] != pts[-1]:
        pts.append(pts[0])
    seq = lib.GEOSCoordSeq_create(len(pts), 2)
    for i, (x, y) in enumerate(pts):
        lib.GEOSCoordSeq_setX(seq, i, float(x))
        lib.GEOSCoordSeq_setY(seq, i, float(y))
    return lib.GEOSGeom_createLinearRing(seq)


def polygon(shell: Sequence[tuple[float, float]],
            holes: Iterable[Sequence[tuple[float, float]]] = ()) -> Geometry:
    lib = _load()
    shell_ring = _ring(shell)
    holes = list(holes)
    if holes:
        arr = (ctypes.c_void_p * len(holes))(*[_ring(h) for h in holes])
        g = lib.GEOSGeom_createPolygon(shell_ring, arr, len(holes))
    else:
        g = lib.GEOSGeom_createPolygon(shell_ring, None, 0)
    return Geometry(g)


def box(x_min: float, y_min: float, x_max: float, y_max: float) -> Geometry:
    return polygon([(x_min, y_min), (x_max, y_min), (x_max, y_max),
                    (x_min, y_max)])


def multipolygon_of(polys: Sequence[Geometry]) -> Geometry:
    lib = _load()
    if not polys:
        return from_wkt("GEOMETRYCOLLECTION EMPTY")
    clones = (ctypes.c_void_p * len(polys))(
        *[lib.GEOSGeom_clone(p._g) for p in polys]
    )
    return Geometry(lib.GEOSGeom_createCollection(6, clones, len(polys)))


def unary_union(geoms: Sequence[Geometry]) -> Geometry:
    lib = _load()
    if len(geoms) == 1:
        return Geometry(lib.GEOSUnaryUnion(geoms[0]._g))
    clones = (ctypes.c_void_p * len(geoms))(
        *[lib.GEOSGeom_clone(g._g) for g in geoms]
    )
    coll = lib.GEOSGeom_createCollection(7, clones, len(geoms))
    coll_g = Geometry(coll)
    return Geometry(lib.GEOSUnaryUnion(coll_g._g))


def from_wkt(wkt: str) -> Geometry:
    lib = _load()
    return Geometry(lib.GEOSGeomFromWKT(wkt.encode()))


def from_wkb(wkb: bytes) -> Geometry:
    lib = _load()
    reader = lib.GEOSWKBReader_create()
    try:
        return Geometry(lib.GEOSWKBReader_read(reader, wkb, len(wkb)))
    finally:
        lib.GEOSWKBReader_destroy(reader)
