"""Sentinel acquisition-dates metadata (reference utils_data/sentinel_dates.py).

Reads the GLOBAL_SENTINEL*_MTD_DATES.gpkg attribute tables (patch_id +
acquisition_dates JSON) through our sqlite3-based GPKG reader — no
geometry decoding needed.
"""

from __future__ import annotations

import datetime
import json
import logging
import sqlite3
from typing import Any, Dict, Set, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _read_attribute_table(file_path: str) -> list[dict]:
    con = sqlite3.connect(file_path)
    con.row_factory = sqlite3.Row
    cur = con.cursor()
    row = cur.execute(
        "SELECT table_name FROM gpkg_contents LIMIT 1"
    ).fetchone()
    table = row["table_name"] if row else None
    if table is None:
        # fall back to the first non-gpkg table
        row = cur.execute(
            "SELECT name FROM sqlite_master WHERE type='table' AND "
            "name NOT LIKE 'gpkg%' AND name NOT LIKE 'sqlite%' LIMIT 1"
        ).fetchone()
        table = row["name"] if row else None
    if table is None:
        con.close()
        raise ValueError(f"no table in {file_path}")
    out = [dict(r) for r in cur.execute(f'SELECT * FROM "{table}"')]
    con.close()
    return out


def prepare_sentinel_dates(config: Dict[str, Any], file_path: str,
                           patch_ids: Set[str]) -> Dict[str, Dict[str, np.ndarray]]:
    rows = _read_attribute_table(file_path)
    ref_month, ref_day = map(
        int, config["models"]["multitemp_model"]["ref_date"].split("-")
    )
    dict_dates = {}
    for row in rows:
        patch_id = row.get("patch_id")
        if patch_id not in patch_ids:
            continue
        acquisition_dates = json.loads(row["acquisition_dates"])
        dates, diffs = [], []
        for date_str in acquisition_dates.values():
            try:
                d = datetime.datetime.strptime(date_str, "%Y%m%d")
                ref = datetime.datetime(d.year, ref_month, ref_day)
                dates.append(d)
                diffs.append((d - ref).days)
            except ValueError as e:
                logger.info("Invalid date encountered: %s (%s)", date_str, e)
        dict_dates[patch_id] = {
            "dates": np.array(dates),
            "diff_dates": np.array(diffs),
        }
    return dict_dates


def get_sentinel_dates_mtd(config: dict, patch_ids: set) -> Tuple[Dict, Dict, Dict]:
    assert isinstance(config, dict)
    dates_s2, dates_s1asc, dates_s1desc = {}, {}, {}
    inputs = config["modalities"]["inputs"]
    if not any(inputs.get(k) for k in
               ("SENTINEL2_TS", "SENTINEL1-ASC_TS", "SENTINEL1-DESC_TS")):
        return dates_s2, dates_s1asc, dates_s1desc
    folder = config["paths"]["global_mtd_folder"]
    if inputs.get("SENTINEL2_TS"):
        dates_s2 = prepare_sentinel_dates(
            config, folder + "GLOBAL_SENTINEL2_MTD_DATES.gpkg", patch_ids)
    if inputs.get("SENTINEL1-ASC_TS"):
        dates_s1asc = prepare_sentinel_dates(
            config, folder + "GLOBAL_SENTINEL1-ASC_MTD_DATES.gpkg", patch_ids)
    if inputs.get("SENTINEL1-DESC_TS"):
        dates_s1desc = prepare_sentinel_dates(
            config, folder + "GLOBAL_SENTINEL1-DESC_MTD_DATES.gpkg", patch_ids)
    return dates_s2, dates_s1asc, dates_s1desc
