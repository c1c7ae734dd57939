"""GeoPackage (OGC) read/write on stdlib sqlite3.

Replaces the reference's geopandas ``to_file(driver='GPKG')`` /
``read_file`` usage (tile-grid dumps slicing.py:116-119, per-raster results
run_fast_aigle_segmentation.py:123, batch export utils/export.py:117-125,
Sentinel dates metadata sentinel_dates.py:28). Writes the standard
gpkg_contents / gpkg_geometry_columns / gpkg_spatial_ref_sys metadata and
GeoPackageBinary geometry blobs so QGIS and GDAL can read the outputs.
"""

from __future__ import annotations

import os
import sqlite3
import struct
from typing import Any, Iterable, Sequence

from flair_for_aigle_tpu_torch.geo import geos

_GPKG_APP_ID = 0x47504B47  # 'GPKG'


def _srs_rows(srs_id: int):
    name = f"EPSG:{srs_id}"
    # column order: srs_name, srs_id, organization, organization_coordsys_id,
    # definition, description
    return [
        ("Undefined cartesian SRS", -1, "NONE", -1, "undefined", None),
        ("Undefined geographic SRS", 0, "NONE", 0, "undefined", None),
        (name, srs_id, "EPSG", srs_id, name, None),
    ]


def gpkg_blob(geom: geos.Geometry, srs_id: int) -> bytes:
    """GeoPackageBinary: magic 'GP', version 0, flags (little-endian, with
    envelope), srs_id, envelope [minx maxx miny maxy], WKB."""
    minx, miny, maxx, maxy = geom.bounds
    header = struct.pack(
        "<2sBBi", b"GP", 0, 0b00000011, srs_id  # flags: env=1, little endian
    )
    env = struct.pack("<4d", minx, maxx, miny, maxy)
    return header + env + geom.wkb


def parse_gpkg_blob(blob: bytes) -> geos.Geometry:
    if blob[:2] != b"GP":
        return geos.from_wkb(blob)  # plain WKB fallback
    flags = blob[3]
    env_code = (flags >> 1) & 0b111
    env_len = {0: 0, 1: 32, 2: 48, 3: 48, 4: 64}[env_code]
    return geos.from_wkb(blob[8 + env_len:])


def write_gpkg(
    path: str,
    records: Sequence[dict],
    layer: str = "layer",
    crs: str = "EPSG:4326",
    geometry_type: str = "MULTIPOLYGON",
    append: bool = False,
) -> None:
    """records: dicts with 'geometry' (geos.Geometry) + scalar properties."""
    srs_id = int(str(crs).upper().replace("EPSG:", ""))
    fresh = not (append and os.path.exists(path))
    if fresh and os.path.exists(path):
        os.remove(path)
    con = sqlite3.connect(path)
    cur = con.cursor()
    if fresh:
        cur.execute(f"PRAGMA application_id = {_GPKG_APP_ID}")
        cur.execute("PRAGMA user_version = 10300")
        cur.execute(
            """CREATE TABLE gpkg_spatial_ref_sys (
                 srs_name TEXT NOT NULL, srs_id INTEGER PRIMARY KEY,
                 organization TEXT NOT NULL, organization_coordsys_id INTEGER
                 NOT NULL, definition TEXT NOT NULL, description TEXT)"""
        )
        cur.executemany(
            "INSERT INTO gpkg_spatial_ref_sys VALUES (?,?,?,?,?,?)",
            _srs_rows(srs_id),
        )
        cur.execute(
            """CREATE TABLE gpkg_contents (
                 table_name TEXT NOT NULL PRIMARY KEY, data_type TEXT NOT NULL,
                 identifier TEXT UNIQUE, description TEXT DEFAULT '',
                 last_change DATETIME DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ',
                 'now')), min_x DOUBLE, min_y DOUBLE, max_x DOUBLE,
                 max_y DOUBLE, srs_id INTEGER)"""
        )
        cur.execute(
            """CREATE TABLE gpkg_geometry_columns (
                 table_name TEXT NOT NULL, column_name TEXT NOT NULL,
                 geometry_type_name TEXT NOT NULL, srs_id INTEGER NOT NULL,
                 z TINYINT NOT NULL, m TINYINT NOT NULL,
                 CONSTRAINT pk_geom_cols PRIMARY KEY (table_name, column_name))"""
        )

    props = [k for k in (records[0].keys() if records else []) if k != "geometry"]
    cols = ", ".join(f'"{p}"' for p in props)
    table_exists = cur.execute(
        "SELECT name FROM sqlite_master WHERE type='table' AND name=?", (layer,)
    ).fetchone()
    if not table_exists:
        col_defs = "".join(f', "{p}"' for p in props)
        cur.execute(
            f'CREATE TABLE "{layer}" (fid INTEGER PRIMARY KEY AUTOINCREMENT, '
            f"geom BLOB{col_defs})"
        )
        bounds = None
        for r in records:
            b = r["geometry"].bounds
            bounds = b if bounds is None else (
                min(bounds[0], b[0]), min(bounds[1], b[1]),
                max(bounds[2], b[2]), max(bounds[3], b[3]),
            )
        bounds = bounds or (0, 0, 0, 0)
        cur.execute(
            "INSERT OR REPLACE INTO gpkg_contents (table_name, data_type, "
            "identifier, min_x, min_y, max_x, max_y, srs_id) VALUES "
            "(?, 'features', ?, ?, ?, ?, ?, ?)",
            (layer, layer, bounds[0], bounds[1], bounds[2], bounds[3], srs_id),
        )
        cur.execute(
            "INSERT OR REPLACE INTO gpkg_geometry_columns VALUES "
            "(?, 'geom', ?, ?, 0, 0)",
            (layer, geometry_type, srs_id),
        )
    placeholders = ", ".join(["?"] * (1 + len(props)))
    colnames = "geom" + (", " + cols if props else "")
    cur.executemany(
        f'INSERT INTO "{layer}" ({colnames}) VALUES ({placeholders})',
        [
            tuple([gpkg_blob(r["geometry"], srs_id)] +
                  [r.get(p) for p in props])
            for r in records
        ],
    )
    con.commit()
    con.close()


def read_gpkg(path: str, layer: str | None = None) -> tuple[list[dict], str]:
    """Returns (records, crs). Geometry column decoded to geos.Geometry."""
    con = sqlite3.connect(path)
    con.row_factory = sqlite3.Row
    cur = con.cursor()
    if layer is None:
        row = cur.execute(
            "SELECT table_name FROM gpkg_contents WHERE data_type='features'"
        ).fetchone()
        if row is None:
            con.close()
            raise ValueError(f"no feature layer in {path}")
        layer = row["table_name"]
    srs = cur.execute(
        "SELECT srs_id FROM gpkg_geometry_columns WHERE table_name=?", (layer,)
    ).fetchone()
    crs = f"EPSG:{srs['srs_id']}" if srs else "EPSG:0"
    geom_col = "geom"
    gc = cur.execute(
        "SELECT column_name FROM gpkg_geometry_columns WHERE table_name=?",
        (layer,),
    ).fetchone()
    if gc:
        geom_col = gc["column_name"]
    records = []
    for row in cur.execute(f'SELECT * FROM "{layer}"'):
        rec = {k: row[k] for k in row.keys() if k not in (geom_col, "fid")}
        rec["geometry"] = parse_gpkg_blob(row[geom_col])
        records.append(rec)
    con.close()
    return records, crs


def list_layers(path: str) -> list[str]:
    con = sqlite3.connect(path)
    rows = con.execute(
        "SELECT table_name FROM gpkg_contents WHERE data_type='features'"
    ).fetchall()
    con.close()
    return [r[0] for r in rows]
