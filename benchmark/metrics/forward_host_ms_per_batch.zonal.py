"""Host ms of the forward a batch: the mean over the window's dalles of
``forward_s`` over ``batches`` in the port's per-call record
(``zonal/stripes.py LAST_TIMINGS``, tracing off), the span ``zonal.forward``
around ``ZonalStep.forward_convert``: normalisation, encoder, decoder and
epilogue as the host issues them, and any wait for the card inside."""

from benchmark import stats


def read(ctx):
    vals = [t["forward_s"] / t["batches"] for t in (u.get("timings", {}) for u in ctx.units)
            if "forward_s" in t and t.get("batches")]
    return 1e3 * stats.mean(vals) if vals else None
