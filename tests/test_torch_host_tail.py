"""The port's host tail against the JAX package's, on the CPU (where the
native library, libtiff, GEOS and libproj load):

* each framework-free module the port copies equals its JAX original once
  ``flair_for_aigle_tpu.`` reads ``flair_for_aigle_tpu_torch.``;
* ``raster_to_polygons`` of both packages on one seeded label raster with
  holes and several classes: the same class ids and the same WKB;
* ``transform_geometry`` EPSG:2154 -> EPSG:4326: the same coordinates;
* a shapefile written and read back by the port;
* the zonal host-tail functions of the port's ``zonal/inference.py``
  (``resample_prediction``, ``load_geozone_contour``,
  ``logits_to_labels_and_confidence``, ``vectorize_segmentation``) give the
  JAX package's results on the same inputs.
"""

from pathlib import Path

import numpy as np
import pytest

from flair_for_aigle_tpu.geo import geos as jgeos
from flair_for_aigle_tpu.geo.crs import transform_geometry as jax_transform
from flair_for_aigle_tpu.geo.geotiff import write_geotiff
from flair_for_aigle_tpu.geo.gpkg import write_gpkg
from flair_for_aigle_tpu.geo.windows import from_origin
from flair_for_aigle_tpu.zonal import inference as jzi
from flair_for_aigle_tpu_torch.geo import geos
from flair_for_aigle_tpu_torch.geo.crs import transform_geometry
from flair_for_aigle_tpu_torch.geo.shapefile import read_shapefile, write_shapefile
from flair_for_aigle_tpu_torch.zonal import inference as zi

REPO = Path(__file__).resolve().parents[1]
COPIES = ["geo/crs.py", "geo/polygonize.py", "geo/shapefile.py", "zonal/postprocess.py",
          "aigle/config.py", "aigle/utils.py", "aigle/logs.py", "aigle/map.py",
          "aigle/pgwire.py", "aigle/db.py", "aigle/export.py", "aigle/s3.py"]


@pytest.mark.parametrize("module", COPIES)
def test_copied_module_equals_its_original_up_to_imports(module):
    original = (REPO / "flair_for_aigle_tpu" / module).read_text()
    copy = (REPO / "flair_for_aigle_tpu_torch" / module).read_text()
    assert copy == original.replace("flair_for_aigle_tpu.", "flair_for_aigle_tpu_torch.")


def _coords(g) -> list:
    """Every ring's coordinates of a (multi)polygon, in GEOS order."""
    if g.geom_type == "MultiPolygon":
        return [c for part in g.geoms for c in _coords(part)]
    return [np.asarray(g.exterior_coords())] + [np.asarray(r) for r in g.interiors_coords()]


def _labels() -> np.ndarray:
    """A 40 x 48 label raster: blocks of four classes from a seeded draw,
    class 3 blocks with a class 1 hole each, and background (18) around."""
    rng = np.random.default_rng(3)
    data = np.kron(rng.integers(0, 4, (5, 6)), np.ones((8, 8), np.int64)).astype(np.uint8)
    data[data == 0] = 18
    for y, x in zip(*np.nonzero(data[::8, ::8] == 3)):
        data[8 * y + 3:8 * y + 5, 8 * x + 3:8 * x + 5] = 1
    return data


def test_raster_to_polygons_matches_the_jax_package(tmp_path):
    data = _labels()
    path = str(tmp_path / "labels.tif")
    write_geotiff(path, data[None], from_origin(650000.0, 6860000.0, 0.5, 0.5), "EPSG:2154")
    got = zi.raster_to_polygons(path, n_jobs=2)
    want = jzi.raster_to_polygons(path, n_jobs=2)
    assert len(got) == len(want) > 4
    assert sorted({r["class_id"] for r in got}) == [1, 2, 3]
    assert any(r["geometry"].interiors_coords() for r in got)  # the holes survive
    for g, w in zip(got, want):
        assert (g["class_id"], g["crs"]) == (w["class_id"], w["crs"])
        assert g["geometry"].wkb == w["geometry"].wkb


def test_transform_geometry_matches_the_jax_package():
    shell = [(650000.0, 6860000.0), (651000.0, 6860000.0), (651000.0, 6861000.0),
             (650000.0, 6861000.0), (650000.0, 6860000.0)]
    hole = [(650400.0, 6860400.0), (650600.0, 6860400.0), (650600.0, 6860600.0),
            (650400.0, 6860600.0), (650400.0, 6860400.0)]
    got = transform_geometry(geos.polygon(shell, [hole]), "EPSG:2154", "EPSG:4326")
    want = jax_transform(jgeos.polygon(shell, [hole]), "EPSG:2154", "EPSG:4326")
    minx, miny, _, _ = got.bounds
    assert 2.0 < minx < 3.0 and 48.0 < miny < 49.5
    for g, w in zip(_coords(got), _coords(want), strict=True):
        np.testing.assert_array_equal(g, w)


def test_shapefile_round_trip(tmp_path):
    sq = [(0.0, 0.0), (10.0, 0.0), (10.0, 10.0), (0.0, 10.0), (0.0, 0.0)]
    hole = [(2.0, 2.0), (4.0, 2.0), (4.0, 4.0), (2.0, 4.0), (2.0, 2.0)]
    recs = [{"geometry": geos.polygon(sq, [hole]), "iso_code": "29019", "name": "Brest"},
            {"geometry": geos.box(100.0, 100.0, 120.0, 110.0), "iso_code": "35238",
             "name": "Rennes"}]
    path = str(tmp_path / "zones.shp")
    write_shapefile(path, recs, crs="EPSG:2154")
    got, crs = read_shapefile(path)
    assert crs == "EPSG:2154"
    assert [(r["iso_code"], r["name"]) for r in got] == [("29019", "Brest"), ("35238", "Rennes")]
    assert [r["geometry"].area for r in got] == [96.0, 200.0]
    assert type(got[0]["geometry"]).__module__ == "flair_for_aigle_tpu_torch.geo.geos"


@pytest.mark.parametrize("scale", [0.5, 1.0, 2.5, 4.0 / 3.0])
def test_resample_prediction_matches_the_jax_package(scale):
    pred = np.random.default_rng(1).integers(0, 19, (2, 37, 45)).astype(np.uint8)
    got = zi.resample_prediction(pred, scale)
    np.testing.assert_array_equal(got, np.asarray(jzi.resample_prediction(pred, scale)))
    assert got.shape == (2, round(37 * scale), round(45 * scale))


@pytest.mark.parametrize("cache", ["zones.gpkg", "zones.shp"])
def test_load_geozone_contour_matches_the_jax_package(tmp_path, monkeypatch, cache):
    """A geozone cache in EPSG:4326 filtered by iso code and moved to the
    run's EPSG:2154, as the JAX package loads it."""
    zones = [(jgeos.box(2.30, 48.80, 2.32, 48.82), "75056"),
             (jgeos.box(2.40, 48.85, 2.41, 48.86), "93001"),
             (jgeos.box(2.50, 48.90, 2.52, 48.91), "94001")]
    recs = [{"geometry": g, "iso_code": code} for g, code in zones]
    if cache.endswith(".shp"):
        from flair_for_aigle_tpu.geo.shapefile import write_shapefile as jax_write_shapefile

        jax_write_shapefile(str(tmp_path / cache), recs, crs="EPSG:4326")
    else:
        write_gpkg(str(tmp_path / cache), recs, layer="geozones", crs="EPSG:4326")
    monkeypatch.setenv("GEOZONES_SHAPEFILE", cache)

    class Cfg:
        db_sources = str(tmp_path)
        geozones_codes = "75056,94001"
        input_crs = "EPSG:2154"

    got, want = zi.load_geozone_contour(Cfg()), jzi.load_geozone_contour(Cfg())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert 640000 < g.bounds[0] < 670000
        for a, b in zip(_coords(g), _coords(w), strict=True):
            np.testing.assert_array_equal(a, b)


def test_vectorize_segmentation_matches_the_jax_package():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(4, 4, 5)).repeat(6, axis=1).repeat(6, axis=2)
    e = np.exp(logits - logits.max(0))
    probs = (e / e.sum(0)).astype(np.float32)
    labels, conf = zi.logits_to_labels_and_confidence(probs)
    jl, jc = jzi.logits_to_labels_and_confidence(probs)
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_array_equal(conf, jc)
    tr = from_origin(650000.0, 6860000.0, 0.5, 0.5)
    got = zi.vectorize_segmentation(labels, conf, tr, crs="EPSG:2154")
    want = jzi.vectorize_segmentation(labels, conf, tr, crs="EPSG:2154")
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert (g["class_id"], g["confidence"], g["crs"]) == \
            (w["class_id"], w["confidence"], w["crs"])
        assert g["geometry"].wkb == w["geometry"].wkb
