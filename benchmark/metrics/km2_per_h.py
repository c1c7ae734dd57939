"""km2/h: the area of every dalle written in the window over the
window's wall time (host clock)."""

from benchmark import readers


def read(ctx):
    return 3600.0 * readers.per_window(ctx, "area_km2")
