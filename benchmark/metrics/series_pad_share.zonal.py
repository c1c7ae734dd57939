"""Share of the frames U-TAE ran that pad a batch to its largest date
count, in %: the port's counters ``series_frames_padded`` over
``series_frames`` summed over the window's dalles (tracing off). None
where the record has no such counters."""


def read(ctx):
    recs = [u.get("timings", {}) for u in ctx.units]
    if not recs or not all("series_frames" in t and "series_frames_padded" in t for t in recs):
        return None
    frames = sum(t["series_frames"] for t in recs)
    return 100.0 * sum(t["series_frames_padded"] for t in recs) / frames if frames else None
