"""Model operations of the tiles of the window's dalles over the window
times the card's peak at the configuration's precision, in %."""

from benchmark import readers


def read(ctx):
    return readers.mfu_pct(ctx)
