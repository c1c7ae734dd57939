"""Share of their roofline that the port's kernels reach over the
traced steps (``readers.port_kernels_roofline_pct``)."""

from benchmark import readers


def read(ctx):
    return readers.port_kernels_roofline_pct(ctx)
