"""The 90th percentile of every dalle's time in the window, from the
start of its host set-up to its label raster written (host clock)."""

from benchmark import readers, stats


def read(ctx):
    return stats.percentile(readers.unit_seconds(ctx), 90)
