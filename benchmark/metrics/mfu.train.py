"""Model operations of the window's steps (3 x the forward of their
samples) over the window times the card's peak at the configuration's
precision (float32: TF32's rate, the fastest the card multiplies float32
inputs), in %."""

from benchmark import readers


def read(ctx):
    return readers.mfu_pct(ctx)
