"""Host raster IO for machines that lack the native geo libraries.

The zonal engine reads and writes GeoTIFFs through the framework-free
``flair_for_aigle_tpu_torch.geo`` modules, which need ``native/libflairgeo.so``
(built against libtiff) and ``libgeos_c.so.1`` for the tile boxes. Where
those libraries are missing, :func:`host_io` swaps in a dict-backed raster
store with the ``open_raster`` / ``WindowedWriter`` surface and a
bounds-only tile box, so ``run_inference`` and its whole device path run
unchanged. Rasters written under the stand-ins live only in this process
(the file on disk is an empty marker); leaving the context restores the
native IO.
"""

from __future__ import annotations

import contextlib
import subprocess

import numpy as np

from flair_for_aigle_tpu_torch.geo import geos, geotiff, native


def native_io_error() -> Exception | None:
    """The error that keeps the native GeoTIFF IO or GEOS from loading, or
    None when both load."""
    try:
        native.load()
        geos._load()
    except (OSError, subprocess.CalledProcessError) as e:
        return e
    return None


@contextlib.contextmanager
def memory_host_io():
    """Install the in-memory stand-ins; yields their ``write_geotiff``."""
    store: dict = {}

    class StoredRaster(geotiff.MemoryRaster):
        def __init__(self, path: str):
            arr, transform, crs = store[path]
            self.path = path
            self.count, self.height, self.width = arr.shape
            self.dtypes = [arr.dtype] * self.count
            self.transform, self.crs = transform, crs
            self.block_rows = 1
            self._data = arr

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.close()

    def write_geotiff(path, array, transform=None, crs=None, compress="lzw",
                      tile_size=256, overviews=0):
        arr = np.ascontiguousarray(array)
        store[path] = (arr[None] if arr.ndim == 2 else arr, transform, crs)
        with open(path, "wb"):
            pass

    class Box:
        def __init__(self, *bounds):
            self.bounds = tuple(float(v) for v in bounds)

    saved = (geotiff.RasterReader, geotiff.write_geotiff, geos.box)
    geotiff.RasterReader, geotiff.write_geotiff, geos.box = (
        StoredRaster, write_geotiff, Box)
    try:
        yield write_geotiff
    finally:
        geotiff.RasterReader, geotiff.write_geotiff, geos.box = saved


@contextlib.contextmanager
def host_io():
    """Yields ``(write_geotiff, description)``: the native GeoTIFF IO when
    libtiff and GEOS load, else the in-memory stand-ins."""
    err = native_io_error()
    if err is None:
        yield geotiff.write_geotiff, "native GeoTIFF IO (libtiff) and GEOS"
        return
    with memory_host_io() as write_geotiff:
        yield write_geotiff, (
            f"in-memory raster reader/writer and tile boxes "
            f"({type(err).__name__}: libtiff / libgeos unavailable here); "
            f"device path unchanged")
