"""Mean ``put_s`` of ``zonal/stripes.py LAST_TIMINGS`` over the window's
dalles: the host-to-device copy of the resident raster's stripes."""

from benchmark import readers


def read(ctx):
    return readers.mean_timing_ms(ctx, "put_s")
