"""Mean ``finalize_s`` of ``zonal/stripes.py LAST_TIMINGS`` over the
window's dalles: the last stripes' wait, unpack and the raster write."""

from benchmark import readers


def read(ctx):
    return readers.mean_timing_ms(ctx, "finalize_s")
