"""Share of the traced window in which no kernel, copy or set ran on the
card: 1 - (union of the device intervals) / window, in %."""

from benchmark import readers


def read(ctx):
    return readers.device_idle_pct(ctx)
