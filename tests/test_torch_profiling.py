"""The port's ``utils/profiling.py`` on the CPU.

* ``profile_trace(None)`` and ``profile_trace("")`` are no-ops like the JAX
  hook, and ``profile_trace(logdir)`` writes a Chrome trace of the block's
  operators into ``logdir``.
* With no profiler session on, a span enters no ``record_function`` and
  still adds its host seconds to the current call's record; counters and
  ``blocked`` add to it; outside ``recording`` nothing is kept.
* Under ``torch.profiler`` every span lies in the exported Chrome trace as
  a ``user_annotation``, each child inside its parent's interval, a
  decorated function once a call; a span that raises is still timed.
* Device times: a span given a CPU device records no event, so
  ``device_times`` holds nothing for it.
"""

import glob
import json
import os

import pytest
import torch

from flair_for_aigle_tpu.utils import profiling as jprof
from flair_for_aigle_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("logdir", [None, ""])
def test_profile_trace_without_a_logdir_is_a_no_op(logdir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with tprof.profile_trace(logdir):
        torch.ones(2) + 1
    with jprof.profile_trace(logdir):
        pass
    assert not os.listdir(tmp_path)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with tprof.profile_trace(str(logdir)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = glob.glob(str(logdir / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names


def _annotations(logdir) -> list:
    """The user annotations of the one trace in ``logdir``: (name, start
    us, end us), in start order."""
    files = glob.glob(os.path.join(str(logdir), "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") == "user_annotation"),
                  key=lambda a: a[1])


def _within(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def test_spans_off_enter_no_record_function_and_add_host_seconds(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with the profiler off")

    monkeypatch.setattr(tprof.torch.profiler, "record_function", refuse)
    assert not tprof.tracing()
    record = {"stale": 1}
    with tprof.recording(record) as rec:
        assert rec is record and not record  # cleared on entry
        for _ in range(3):
            with tprof.span("t.outer", "outer_s"):
                with tprof.span("t.inner"):
                    sum(range(1000))
        tprof.count("tiles", 16)
        tprof.count("tiles", 3)
        with tprof.blocked():
            sum(range(1000))
    assert set(record) == {"outer_s", "t.inner", "tiles", "blocked_s"}
    assert record["outer_s"] > record["t.inner"] > 0 and record["blocked_s"] > 0
    assert record["tiles"] == 19
    # outside a recording, nothing is kept
    with tprof.span("t.outer", "outer_s"):
        tprof.count("tiles")
    assert record["tiles"] == 19


def test_recording_restores_the_outer_record():
    outer, inner = {}, {}
    with tprof.recording(outer):
        with tprof.recording(inner):
            tprof.count("n")
        tprof.count("n", 2)
    assert inner == {"n": 1} and outer == {"n": 2}


def test_spans_nest_in_the_chrome_trace(tmp_path):
    @tprof.span("t.leaf", "leaf_s")
    def leaf(x):
        return x @ x

    record = {}
    with tprof.recording(record), tprof.profile_trace(str(tmp_path)):
        with tprof.span("t.outer"):
            with tprof.span("t.mid", "mid_s"):
                for _ in range(3):
                    leaf(torch.ones(16, 16))
            with tprof.span("t.tail"):
                torch.ones(4) + 1
    ann = [a for a in _annotations(tmp_path) if a[0].startswith("t.")]
    names = [a[0] for a in ann]
    assert names == ["t.outer", "t.mid", "t.leaf", "t.leaf", "t.leaf", "t.tail"]
    outer, mid, tail = ann[0], ann[1], ann[5]
    assert all(_within(a, mid) for a in ann[2:5])
    assert _within(mid, outer) and _within(tail, outer) and tail[1] >= mid[2]
    # the host seconds are those of the spans the trace shows
    assert 0 < record["leaf_s"] <= record["mid_s"] <= (mid[2] - mid[1]) / 1e6 + 1e-4


def test_a_span_that_raises_is_timed_and_closed(tmp_path):
    record = {}
    with tprof.recording(record), tprof.profile_trace(str(tmp_path)):
        with pytest.raises(ValueError):
            with tprof.span("t.fails", "fails_s"):
                raise ValueError("a span that raises is still timed")
        with tprof.span("t.after"):
            pass
    ann = _annotations(tmp_path)
    fails = [a for a in ann if a[0] == "t.fails"]
    after = [a for a in ann if a[0] == "t.after"]
    assert len(fails) == len(after) == 1 and not _within(after[0], fails[0])
    assert record["fails_s"] > 0


def test_device_times_stay_empty_without_a_card(tmp_path):
    with tprof.profile_trace(str(tmp_path)):
        with tprof.span("t.cpu_device", device=torch.device("cpu")):
            torch.ones(8) * 2
    assert "t.cpu_device" not in tprof.device_times()
    assert [a[0] for a in _annotations(tmp_path)] == ["t.cpu_device"]
