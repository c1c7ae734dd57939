"""Arithmetic shared by the metric readers (``metrics/<name>.py``). Each
returns None where its cell gives it nothing to read."""

from __future__ import annotations

from benchmark import stats
from benchmark.context import Context


def per_window(ctx: Context, key: str) -> float:
    """``ctx.per_unit[key]`` of every unit of the window per second."""
    return stats.rate(ctx.per_unit[key] * len(ctx.units), ctx.window_s)


def unit_seconds(ctx: Context) -> list[float]:
    return [u["end"] - u["start"] for u in ctx.units]


def mean_timing_ms(ctx: Context, key: str) -> float | None:
    """Mean of a ``zonal/stripes.py LAST_TIMINGS`` phase over the window's
    dalles, in ms."""
    vals = [u["timings"][key] for u in ctx.units if key in u.get("timings", {})]
    return 1e3 * stats.mean(vals) if vals else None


def traced_ms_per_unit(ctx: Context, us: float) -> float | None:
    if ctx.summary is None or not ctx.traced_units:
        return None
    return us / 1e3 / ctx.traced_units


def device_idle_pct(ctx: Context) -> float | None:
    return None if ctx.summary is None else 100.0 * ctx.summary.idle_share


def port_kernels_roofline_pct(ctx: Context) -> float | None:
    """The least time of the port kernels' work in the traced units
    (``kernels/<name>.py``, counted from shapes) over the device time of
    every kernel of the port's ``csrc/`` in them, in %."""
    if ctx.summary is None or ctx.summary.port_us <= 0:
        return None
    bound = ctx.kernel_bound_s(ctx.traced_units * ctx.per_unit["batches"])
    if bound is None:
        return None
    return 100.0 * bound / (ctx.summary.port_us / 1e6)


def mfu_pct(ctx: Context) -> float | None:
    """Model operations of the window's units over the window times the
    card's peak at the configuration's precision, in %."""
    peak = ctx.peak_flops()
    if peak is None:
        return None
    return 100.0 * ctx.flops_per_unit * len(ctx.units) / ctx.window_s / peak
