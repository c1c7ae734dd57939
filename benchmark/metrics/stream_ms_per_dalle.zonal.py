"""Mean ``stream_s`` of the port's per-call record (``zonal/stripes.py
LAST_TIMINGS``, tracing off) over the window's dalles: the span
``stripes.stream`` in each batch, the stripe codec's host work (the
encodes of the rows a batch made final and their asynchronous D2H)."""

from benchmark import readers


def read(ctx):
    return readers.mean_timing_ms(ctx, "stream_s")
