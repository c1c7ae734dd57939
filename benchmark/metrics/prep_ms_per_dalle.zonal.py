"""Mean host time of a dalle's set-up in the window: geometry,
slicing, dataset and output writers (the benchmark's span ``bench.prep``)."""

from benchmark import stats


def read(ctx):
    vals = [u["prep_s"] for u in ctx.units if "prep_s" in u]
    return 1e3 * stats.mean(vals) if vals else None
