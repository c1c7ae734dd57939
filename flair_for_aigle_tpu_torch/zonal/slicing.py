"""Overlap tiler: grid of overlapping tiles over (raster ∩ geozone).

Exact behavioral port of the reference grid math
(flair-for-aigle: flair_zonal_detection/slicing.py:20-121): stride =
(patch - 2*margin) * resolution, edge tiles snapped back inside the
image+margin frame, dedup by rounded inner bounds, tile ids "1-row-col"
from the reference raster origin. Output is a list of tile dicts (the
reference returns a GeoDataFrame; consumers here use plain dicts +
geo.geos geometries).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np

from flair_for_aigle_tpu_torch.geo import geos
from flair_for_aigle_tpu_torch.geo.geotiff import open_raster
from flair_for_aigle_tpu_torch.geo.gpkg import write_gpkg
from flair_for_aigle_tpu_torch.geo.windows import array_bounds

logger = logging.getLogger(__name__)


def create_box_from_bounds(x_min, x_max, y_min, y_max) -> geos.Geometry:
    return geos.box(x_min, min(y_min, y_max), x_max, max(y_min, y_max))


def generate_patches_from_reference(
    config: Dict,
    img_path: str | None = None,
    geozone_contour_geometries: Optional[Sequence[geos.Geometry]] = None,
) -> list[dict]:
    """Slice the reference raster into overlapping tiles.

    Returns a list of tile dicts with keys id/input_id/output_id/job_done/
    left/bottom/right/top/left_o/bottom_o/right_o/top_o/geometry
    (slicing.py:93-112 schema).
    """
    patch_size = config["img_pixels_detection"]
    margin = config["margin"]
    output_path = config.get("output_path", ".")
    output_name = config.get("output_name", "out")
    write_dataframe = config.get("write_dataframe", False)

    ref_mod = config["reference_modality"]
    if img_path is None:
        img_path = config["modalities"][ref_mod]["input_img_path"]

    with open_raster(img_path) as src:
        crs = src.crs
        src_height, src_width = src.shape
        ref_l, ref_b, ref_r, ref_t = array_bounds(
            src_height, src_width, src.transform
        )
        if geozone_contour_geometries:
            # intersection of raster bounds with geozone (reference uses
            # rasterio.mask crop: bounding box of the intersection)
            raster_box = geos.box(ref_l, ref_b, ref_r, ref_t)
            zone = geos.unary_union(list(geozone_contour_geometries))
            inter = raster_box.intersection(zone)
            if inter.is_empty:
                return []
            left_o, bottom_o, right_o, top_o = inter.bounds
            # snap the crop window to the raster grid like rasterio.mask
            res = abs(src.transform.a)
            left_o = ref_l + np.floor((left_o - ref_l) / res) * res
            right_o = ref_l + np.ceil((right_o - ref_l) / res) * res
            top_o = ref_t - np.floor((ref_t - top_o) / res) * res
            bottom_o = ref_t - np.ceil((ref_t - bottom_o) / res) * res
        else:
            left_o, bottom_o, right_o, top_o = ref_l, ref_b, ref_r, ref_t

    resolution = config["reference_resolution"]
    geo_output = (patch_size * resolution, patch_size * resolution)
    geo_margin = (margin * resolution, margin * resolution)
    geo_step = ((patch_size - 2 * margin) * resolution,
                (patch_size - 2 * margin) * resolution)

    min_x, min_y, max_x, max_y = left_o, bottom_o, right_o, top_o

    tiles = []
    existing = set()
    for x_coord in np.arange(min_x - geo_margin[0], max_x + geo_margin[0],
                             geo_step[0]):
        for y_coord in np.arange(min_y - geo_margin[1], max_y + geo_margin[1],
                                 geo_step[1]):
            if x_coord + geo_output[0] > max_x + geo_margin[0]:
                x_coord = max_x + geo_margin[0] - geo_output[0]
            if y_coord + geo_output[1] > max_y + geo_margin[1]:
                y_coord = max_y + geo_margin[1] - geo_output[1]

            left = x_coord + geo_margin[0]
            right = min(x_coord + geo_output[0] - geo_margin[0], max_x)
            bottom = y_coord + geo_margin[1]
            top = min(y_coord + geo_output[1] - geo_margin[1], max_y)

            patch_bounds = tuple(round(v, 6) for v in (left, bottom, right, top))
            if patch_bounds in existing:
                continue
            existing.add(patch_bounds)

            col = int((x_coord - ref_l) // resolution) + 1
            row = int((y_coord - ref_b) // resolution) + 1

            if right - left > 0 and top - bottom > 0:
                tiles.append({
                    "id": f"1-{row}-{col}",
                    "input_id": img_path,
                    "output_id": output_name,
                    "job_done": 0,
                    "left": float(left), "bottom": float(bottom),
                    "right": float(right), "top": float(top),
                    "left_o": float(left_o), "bottom_o": float(bottom_o),
                    "right_o": float(right_o), "top_o": float(top_o),
                    "geometry": create_box_from_bounds(
                        float(x_coord), float(x_coord + geo_output[0]),
                        float(y_coord), float(y_coord + geo_output[1]),
                    ),
                })

    if write_dataframe and tiles:
        gpkg_path = os.path.join(output_path, output_name + "_slicing_job.gpkg")
        write_gpkg(gpkg_path, tiles, layer="slicing", crs=crs or "EPSG:0",
                   geometry_type="POLYGON")
        logger.info("[ok] Saved sliced boxes: %s", gpkg_path)

    return tiles
