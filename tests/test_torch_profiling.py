"""The port's ``utils/profiling.py`` against the JAX package's, on the CPU:
``StageTimers`` accumulates and reports as the JAX class does (same counts,
same report layout), ``profile_trace(None)`` and ``profile_trace("")`` are
no-ops like the JAX hook, and ``profile_trace(logdir)`` writes a Chrome
trace of the block's operators into ``logdir``.
"""

import glob
import json
import os

import pytest
import torch

from flair_for_aigle_tpu.utils import profiling as jprof
from flair_for_aigle_tpu_torch.utils import profiling as tprof


def _drive(timers) -> str:
    for _ in range(2):
        with timers.stage("io"):
            pass
    with timers.stage("device"):
        sum(range(10000))
    with pytest.raises(ValueError):
        with timers.stage("fails"):
            raise ValueError("a stage that raises is still timed")
    return timers.report()


def test_stage_timers_report_as_jax():
    got, want = tprof.StageTimers(), jprof.StageTimers()
    rep_got, rep_want = _drive(got), _drive(want)
    assert dict(got.counts) == dict(want.counts) == {"io": 2, "device": 1, "fails": 1}
    assert set(got.totals) == set(want.totals)
    lines_got, lines_want = rep_got.splitlines(), rep_want.splitlines()
    assert lines_got[0] == lines_want[0]
    assert len(lines_got) == len(lines_want) == 4
    # same columns and calls per stage (times differ run to run)
    assert sorted((ln[:24].strip(), ln.split()[2]) for ln in lines_got[1:]) == \
        sorted((ln[:24].strip(), ln.split()[2]) for ln in lines_want[1:])


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
