"""Host ms of the series route a dalle: the mean ``series_s`` of the port's
per-call record (``zonal/stripes.py LAST_TIMINGS``, tracing off) over the
window's dalles, the loader's span ``zonal.series`` around each tile's
series read, cloud and snow filter, date selection and cast. None where
the record has no such key (no time series, or a program without it)."""

from benchmark import readers


def read(ctx):
    return readers.mean_timing_ms(ctx, "series_s")
