"""Device ms of U-TAE a batch in the traced dalles: the union of the
device intervals launched inside the port's span ``model.encoder.utae``
(one a batch), read from the trace by ``drivers/zonal_mm.py
span_device_us`` and summed over the traced dalles, over the spans' count.
The card's own time: the host's gaps between U-TAE's launches, which the
span's CUDA events would hold, do not count. None without a trace or
without such spans (a program without the span)."""


def read(ctx):
    ms, spans = ctx.info.get("span_device_ms", {}).get("model.encoder.utae", (0.0, 0))
    return ms / spans if spans else None
