"""Mean ``blocked_s`` of the port's per-call record (``zonal/stripes.py
LAST_TIMINGS``, tracing off) over the window's dalles: the host seconds of
the calls on the zonal path that wait for the card (a stripe's D2H
landing, the codec's run counts, copies from pageable memory to the
card)."""

from benchmark import readers


def read(ctx):
    return readers.mean_timing_ms(ctx, "blocked_s")
