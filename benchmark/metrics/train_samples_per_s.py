"""Samples of every step completed in the window (each ended by a
synchronise) over the window's wall time (host clock)."""

from benchmark import readers


def read(ctx):
    return readers.per_window(ctx, "samples")
