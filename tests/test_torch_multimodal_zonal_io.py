"""The port's multimodal zonal run against the JAX package's, on the CPU
(the inputs and helpers of ``tests/test_torch_multimodal_zonal.py``):

* With ``fixed_time_steps`` 4, fewer than the 5 cloud-free dates, both
  packages keep the same dates (the reference caveat: a fixed T drops the
  worst cloud-covered dates first, by the mask's per-date coverage) and
  the port's labels are the JAX run's, except at near-ties (top-2 gap of
  the JAX logits below 1e-4).
* Both packages' zonal datasets give the same Sentinel-2 patches and date
  offsets for every tile, at fixed T 8 (padded with zero frames) and 4
  (a date dropped where 5 are cloud-free).
* ``MemoryRaster`` (the preload path and the card's in-memory stand-ins)
  reads a 41 x 41 px, 12-band raster like the native reader: windowed,
  boundless, bilinear ``out_shape`` resampling, for windows inside, across
  and outside the raster's edge.
"""

import copy

import numpy as np
import pytest

from flair_for_aigle_tpu.zonal import inference as jzi
from flair_for_aigle_tpu_torch.geo import geotiff as tgeotiff
from flair_for_aigle_tpu_torch.geo.windows import Window, from_bounds, from_origin
from flair_for_aigle_tpu_torch.zonal import inference as zi
from flair_for_aigle_tpu_torch.zonal.memory_io import memory_host_io
from tests.test_torch_multimodal_zonal import (  # noqa: F401 (env: a fixture)
    compare_run_inference,
    env,
    jax_model_and_weights,
    zonal_config,
)


def test_fewer_time_steps_than_dates_match_jax_run_inference(env, tmp_path):
    compare_run_inference(env, tmp_path, "fewer_steps")


@pytest.mark.parametrize("fixed_t", [8, 4])
def test_datasets_keep_the_same_dates(env, tmp_path, fixed_t):
    d, paths = env
    cfg = zonal_config(d, paths, str(tmp_path / "w.safetensors"), fixed_t=fixed_t)
    jax_model_and_weights(cfg, cfg["model_weights"])
    sets = {}
    for name, z in (("jax", jzi), ("torch", zi)):
        c = z.prep_config(copy.deepcopy(cfg))
        tiles = z.generate_patches_from_reference(c)
        ds = z.prep_dataset(c, tiles, z.compute_patch_sizes(c))
        sets[name] = [ds[i] for i in range(len(tiles))]
        ds.close()
    n_frames = set()
    for a, b in zip(sets["jax"], sets["torch"]):
        for k in ("SENTINEL2_TS", "SENTINEL2_DATES", "AERIAL_RGBI"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
        assert a["SENTINEL2_TS"].shape == (fixed_t, 3, 8, 8)
        n = int((np.abs(a["SENTINEL2_TS"]).reshape(fixed_t, -1).max(1) > 0).sum())
        assert (a["SENTINEL2_TS"][n:] == 0).all()
        n_frames.add(n)
    # date 2 is cloudy everywhere and date 4 over part of the raster, so
    # tiles keep 4 or 5 dates; a fixed T of 4 drops one where 5 are clear
    assert n_frames == ({4, 5} if fixed_t == 8 else {4})


def test_memory_raster_reads_like_the_native_reader(tmp_path):
    side, res = 41, 409.6 / 41
    arr = np.random.default_rng(5).integers(0, 10000, (12, side, side)).astype(np.uint16)
    path = str(tmp_path / "s2.tif")
    tr = from_origin(700000.0, 6600000.0, res, res)
    tgeotiff.write_geotiff(path, arr, tr, "EPSG:2154")
    native = tgeotiff.open_raster(path)
    memory = tgeotiff.MemoryRaster(native)
    with memory_host_io() as write:
        write(path + ".mem", arr, tr, "EPSG:2154")
        stored = tgeotiff.open_raster(path + ".mem")
    windows = [from_bounds(700000.0 + x0, 6600000.0 - y0 - 102.4, 700000.0 + x0 + 102.4,
                           6600000.0 - y0, transform=tr)
               for x0, y0 in ((0, 0), (86.4, 172.8), (345.6, 345.6), (-40.0, 380.0),
                              (500.0, 0.0))]
    windows.append(Window(3.4, 7.6, 10.25, 10.25))
    for win in windows:
        for out_shape, method in (((12, 10, 10), "bilinear"), ((12, 20, 20), "bilinear"),
                                  ((12, 5, 5), "nearest")):
            kw = dict(indexes=list(range(1, 13)), window=win, out_shape=out_shape,
                      resampling=method, boundless=True, fill_value=0)
            want = native.read(**kw)
            np.testing.assert_array_equal(memory.read(**kw), want)
            np.testing.assert_array_equal(stored.read(**kw), want)
    native.close()
