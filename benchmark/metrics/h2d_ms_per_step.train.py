"""Device time of the host-to-device copies (``Memcpy HtoD``) per traced
step: the batch that ``train_step`` copies to the card."""

from benchmark import readers


def read(ctx):
    if ctx.summary is None:
        return None
    return readers.traced_ms_per_unit(ctx, ctx.summary.memcpy_us.get("HtoD", 0.0))
