"""Device time of the kernels that are not the port's own (cuDNN,
cuBLAS, eager PyTorch) per tile, over the traced dalles."""

from benchmark import readers


def read(ctx):
    if ctx.summary is None:
        return None
    return readers.traced_ms_per_unit(ctx, ctx.summary.library_us) / ctx.per_unit["tiles"]
