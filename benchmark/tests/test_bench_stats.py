"""Rate and percentile arithmetic of the window, stall included."""

import pytest

from benchmark import readers, stats
from benchmark.context import Context


def window(durations):
    units, t = [], 100.0
    for d in durations:
        units.append({"start": t, "end": t + d})
        t += d
    return units, t - 100.0


def ctx_of(units, window_s, per_unit):
    c = Context(bench={}, cell={"name": "x", "chips": 1}, config={}, traffic={}, limits={},
                seed=0, seconds=0, trace=False, device=None)
    c.units, c.window_s, c.per_unit = units, window_s, per_unit
    return c


def test_percentile_matches_numpy_linear():
    assert stats.percentile(range(1, 11), 90) == pytest.approx(9.1)
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2


def test_rate_covers_the_whole_window_with_a_stall():
    durations = [0.4] * 99 + [6.0]
    units, w = window(durations)
    assert w == pytest.approx(45.6)
    c = ctx_of(units, w, {"area_km2": 1.0})
    # 100 dalles of 1 km2 in 45.6 s, the stall counted in the window
    assert readers.per_window(c, "area_km2") * 3600 == pytest.approx(100 / 45.6 * 3600)
    # one stall in 100 sits above the 90th percentile
    p90 = stats.percentile(readers.unit_seconds(c), 90)
    assert p90 == pytest.approx(0.4)
    assert sum(s > p90 for s in readers.unit_seconds(c)) == 1


def test_tail_shows_stalls_beyond_a_tenth():
    units, w = window([0.4] * 85 + [2.0] * 15)
    c = ctx_of(units, w, {"area_km2": 1.0})
    assert stats.percentile(readers.unit_seconds(c), 90) == pytest.approx(2.0)


def test_rate_refuses_an_empty_window():
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)
