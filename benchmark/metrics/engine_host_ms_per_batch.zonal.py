"""Host ms of the engine's own work a batch: the mean over the window's
dalles of ``(gather_s + stitch_s) / batches`` in the port's per-call
record (``zonal/stripes.py LAST_TIMINGS``, tracing off), the spans
``zonal.gather`` (the tiles sliced out of the resident raster) and
``zonal.stitch`` (each tile written into the canvas)."""

from benchmark import stats


def read(ctx):
    vals = [(t["gather_s"] + t["stitch_s"]) / t["batches"]
            for t in (u.get("timings", {}) for u in ctx.units)
            if "gather_s" in t and "stitch_s" in t and t.get("batches")]
    return 1e3 * stats.mean(vals) if vals else None
