"""Minimal first-party ESRI Shapefile IO (polygons + attributes).

The reference loads the geozone cache with geopandas, typically from a
``.shp`` (reference flair_zonal_detection/inference.py:233-238); this image
has no geopandas/fiona, so the triplet (.shp geometry, .dbf attributes,
.prj CRS) is parsed directly. Scope is the geozone use-case: Polygon /
PolygonZ shapes, character/numeric/logical dBase fields. The writer emits
valid single-ring polygon shapefiles and exists mainly to generate
fixtures and to mirror the reference's ``gdf.to_file`` surface.

Format notes (ESRI whitepaper): .shp/.shx headers are 100 bytes, file code
9994 big-endian, lengths in 16-bit words; polygon records hold ring part
offsets and x,y doubles with outer rings clockwise and holes
counter-clockwise. .dbf is dBase III: 32-byte field descriptors, records
as fixed-width ASCII with a leading deletion flag.
"""

from __future__ import annotations

import datetime
import os
import re
import struct
from typing import Sequence

from flair_for_aigle_tpu_torch.geo import geos

_POLYGON_TYPES = {5, 15, 25}  # Polygon, PolygonZ, PolygonM (Z/M ignored)


def _signed_area(ring) -> float:
    s = 0.0
    for (x0, y0), (x1, y1) in zip(ring, ring[1:]):
        s += x0 * y1 - x1 * y0
    return 0.5 * s


def _assemble_polygons(rings):
    """Shapefile ring soup -> geos (Multi)Polygon. Outer rings are CW
    (negative shoelace), holes CCW; holes attach to the outer that
    contains their first vertex."""
    outers = [r for r in rings if _signed_area(r) <= 0]
    holes = [r for r in rings if _signed_area(r) > 0]
    if not outers:  # degenerate: treat every ring as an outer shell
        outers, holes = rings, []
    if len(outers) == 1:
        return geos.polygon(outers[0], holes)
    shells = [geos.polygon(o) for o in outers]
    hole_lists: list[list] = [[] for _ in outers]
    for h in holes:
        x, y = h[0]
        pt = geos.from_wkt(f"POINT({x!r} {y!r})")
        for i, shell in enumerate(shells):
            if shell.contains(pt):
                hole_lists[i].append(h)
                break
    return geos.multipolygon_of(
        [geos.polygon(o, hl) for o, hl in zip(outers, hole_lists)]
    )


def _read_dbf(path: str) -> list[dict]:
    with open(path, "rb") as f:
        head = f.read(32)
        n_rec = struct.unpack("<I", head[4:8])[0]
        head_size = struct.unpack("<H", head[8:10])[0]
        rec_size = struct.unpack("<H", head[10:12])[0]
        fields = []
        while f.tell() < head_size - 1:
            desc = f.read(32)
            if desc[:1] == b"\x0d":
                break
            name = desc[:11].split(b"\x00", 1)[0].decode("ascii",
                                                         "replace").strip()
            ftype = desc[11:12].decode("ascii")
            flen = desc[16]
            fdec = desc[17]
            fields.append((name, ftype, flen, fdec))
        f.seek(head_size)
        records = []
        for _ in range(n_rec):
            raw = f.read(rec_size)
            if len(raw) < rec_size or raw[:1] == b"\x1a":
                break
            if raw[:1] == b"*":
                # soft-deleted row: keep a placeholder so the .shp record
                # (which dbf deletion does NOT remove) stays index-aligned
                # with its attributes; read_shapefile drops the pair
                records.append(None)
                continue
            rec, off = {}, 1
            for name, ftype, flen, fdec in fields:
                cell = raw[off:off + flen].decode("latin-1").strip()
                off += flen
                if ftype in ("N", "F"):
                    if not cell:
                        rec[name] = None
                    elif fdec or ftype == "F" or "." in cell:
                        rec[name] = float(cell)
                    else:
                        try:
                            rec[name] = int(cell)
                        except ValueError:
                            rec[name] = float(cell)
                elif ftype == "L":
                    rec[name] = cell.upper() in ("T", "Y")
                else:
                    rec[name] = cell
            records.append(rec)
        return records


def _crs_from_prj(path: str) -> str | None:
    if not os.path.isfile(path):
        return None
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        wkt = f.read()
    codes = re.findall(r'AUTHORITY\[\s*"EPSG"\s*,\s*"?(\d+)"?\s*\]', wkt)
    if codes:
        return f"EPSG:{codes[-1]}"  # last AUTHORITY is the whole-CRS one
    # common ESRI spellings without AUTHORITY nodes
    if re.search(r"Lambert[_\- ]?93|RGF[_ ]?93.*Lambert", wkt, re.I):
        return "EPSG:2154"
    if re.search(r'GEOGCS\["(GCS_)?WGS[_ ]?(19)?84', wkt):
        return "EPSG:4326"
    return None


def read_shapefile(path: str) -> tuple[list[dict], str | None]:
    """Read polygon features. Returns (records, crs) shaped like
    geo.gpkg.read_gpkg: each record is {"geometry": geos.Geometry, **attrs}.
    """
    base = os.path.splitext(path)[0]
    with open(path, "rb") as f:
        head = f.read(100)
        if struct.unpack(">i", head[:4])[0] != 9994:
            raise ValueError(f"not a shapefile: {path}")
        file_words = struct.unpack(">i", head[24:28])[0]
        shp_type = struct.unpack("<i", head[32:36])[0]
        if shp_type not in _POLYGON_TYPES and shp_type != 0:
            raise ValueError(
                f"unsupported shapefile geometry type {shp_type} "
                f"(polygon readers only) in {path}"
            )
        geoms = []
        while f.tell() < file_words * 2:
            rec_head = f.read(8)
            if len(rec_head) < 8:
                break
            (n_words,) = struct.unpack(">i", rec_head[4:8])
            content = f.read(n_words * 2)
            (rtype,) = struct.unpack("<i", content[:4])
            if rtype == 0:  # null shape
                geoms.append(None)
                continue
            if rtype not in _POLYGON_TYPES:
                raise ValueError(f"unsupported record shape type {rtype}")
            n_parts, n_points = struct.unpack("<ii", content[36:44])
            parts = struct.unpack(f"<{n_parts}i", content[44:44 + 4 * n_parts])
            pts_off = 44 + 4 * n_parts
            flat = struct.unpack(
                f"<{2 * n_points}d",
                content[pts_off:pts_off + 16 * n_points],
            )
            pts = [(flat[2 * i], flat[2 * i + 1]) for i in range(n_points)]
            rings = [
                pts[parts[i]:(parts[i + 1] if i + 1 < n_parts else n_points)]
                for i in range(n_parts)
            ]
            geoms.append(_assemble_polygons([r for r in rings if len(r) >= 4]))

    dbf = base + ".dbf"
    attrs = _read_dbf(dbf) if os.path.isfile(dbf) else [{} for _ in geoms]
    records = []
    for geom, rec in zip(geoms, attrs):
        if geom is None or rec is None:  # null shape / dbf-deleted row
            continue
        records.append({"geometry": geom, **rec})
    return records, _crs_from_prj(base + ".prj")


_PRJ_WKT = {
    "EPSG:2154": (
        'PROJCS["RGF93 / Lambert-93",GEOGCS["RGF93",DATUM["Reseau_Geodesique'
        '_Francais_1993",SPHEROID["GRS 1980",6378137,298.257222101]],'
        'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433]],'
        'PROJECTION["Lambert_Conformal_Conic_2SP"],AUTHORITY["EPSG","2154"]]'
    ),
    "EPSG:4326": (
        'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",6378137,'
        '298.257223563]],PRIMEM["Greenwich",0],UNIT["degree",'
        '0.0174532925199433],AUTHORITY["EPSG","4326"]]'
    ),
}


def write_shapefile(path: str, records: Sequence[dict],
                    crs: str | None = None) -> None:
    """Write polygon records (shell rings only; holes preserved) with their
    attributes. Mirrors the reference's ``gdf.to_file(..)`` shapefile
    surface enough to round-trip through read_shapefile."""
    base = os.path.splitext(path)[0]

    def rings_of(geom):
        if geom.geom_type == "MultiPolygon":
            polys = list(geom.geoms)
        else:
            polys = [geom]
        rings = []
        for p in polys:
            xs, ys = p.exterior_coords()
            ext = list(zip(xs, ys))
            if _signed_area(ext) > 0:
                ext = ext[::-1]  # outer must be CW
            rings.append(ext)
            for hxs, hys in p.interiors_coords():
                h = list(zip(hxs, hys))
                if _signed_area(h) < 0:
                    h = h[::-1]  # holes must be CCW
                rings.append(h)
        return rings

    shp_records = []
    bbox = [float("inf"), float("inf"), float("-inf"), float("-inf")]
    for rec in records:
        rings = rings_of(rec["geometry"])
        pts = [pt for r in rings for pt in r]
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        rb = (min(xs), min(ys), max(xs), max(ys))
        bbox = [min(bbox[0], rb[0]), min(bbox[1], rb[1]),
                max(bbox[2], rb[2]), max(bbox[3], rb[3])]
        parts, off = [], 0
        for r in rings:
            parts.append(off)
            off += len(r)
        content = struct.pack("<i4d", 5, *rb)
        content += struct.pack("<ii", len(rings), off)
        content += struct.pack(f"<{len(parts)}i", *parts)
        for r in rings:
            for x, y in r:
                content += struct.pack("<2d", x, y)
        shp_records.append(content)

    def header(total_words, shape_type):
        h = struct.pack(">i", 9994) + b"\x00" * 20
        h += struct.pack(">i", total_words)
        h += struct.pack("<ii", 1000, shape_type)
        h += struct.pack("<4d", *(bbox if shp_records else [0, 0, 0, 0]))
        h += struct.pack("<4d", 0, 0, 0, 0)
        return h

    shp_len = 50 + sum(4 + len(c) // 2 for c in shp_records)
    with open(base + ".shp", "wb") as f:
        f.write(header(shp_len, 5))
        for i, content in enumerate(shp_records):
            f.write(struct.pack(">ii", i + 1, len(content) // 2))
            f.write(content)
    with open(base + ".shx", "wb") as f:
        f.write(header(50 + 4 * len(shp_records), 5))
        off = 50
        for content in shp_records:
            f.write(struct.pack(">ii", off, len(content) // 2))
            off += 4 + len(content) // 2

    # attributes: every non-geometry key, as text fields
    names: list[str] = []
    for rec in records:
        for k in rec:
            if k != "geometry" and k not in names:
                names.append(k)
    widths = {
        n: max(1, *(len(str(r.get(n, ""))) for r in records)) if records
        else 1
        for n in names
    }
    rec_size = 1 + sum(widths.values())
    today = datetime.date.today()
    with open(base + ".dbf", "wb") as f:
        f.write(struct.pack(
            "<B3BIHH", 0x03, today.year % 100, today.month, today.day,
            len(records), 32 + 32 * len(names) + 1, rec_size,
        ))
        f.write(b"\x00" * 20)
        for n in names:
            f.write(n.encode("ascii", "replace")[:10].ljust(11, b"\x00"))
            f.write(b"C" + b"\x00" * 4)
            f.write(struct.pack("<BB", widths[n], 0))
            f.write(b"\x00" * 14)
        f.write(b"\x0d")
        for rec in records:
            f.write(b" ")
            for n in names:
                f.write(str(rec.get(n, "")).encode("latin-1", "replace")
                        .ljust(widths[n])[:widths[n]])
        f.write(b"\x1a")
    if crs and crs in _PRJ_WKT:
        with open(base + ".prj", "w", encoding="utf-8") as f:
            f.write(_PRJ_WKT[crs])
