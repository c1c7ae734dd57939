"""The readers of the port's spans and counters (``metrics/*.py``) on
synthetic contexts, and a small traced zonal run on the CPU.

The zonal readers average the per-dalle record (``u["timings"]``) over the
window's dalles, per batch where they say so, and read nothing from a
program whose record lacks the key. The training readers divide the device
time of ``train.forward`` and ``train.backward`` by their spans' count,
and read nothing without a trace, without device spans (the CPU) or from a
program whose ``utils/profiling.py`` has no ``device_times``.
"""

import pytest

from benchmark import registry
from benchmark.context import Context
from benchmark.tests import small

ZONAL = ["forward_host_ms_per_batch.zonal", "engine_host_ms_per_batch.zonal",
         "stream_ms_per_dalle.zonal", "host_blocked_ms_per_dalle.zonal"]
TRAIN = ["forward_device_ms_per_step.train", "backward_device_ms_per_step.train"]


def ctx_with(timings: list, summary=None) -> Context:
    c = Context(bench={}, cell={"name": "x", "chips": 1}, config={}, traffic={}, limits={},
                seed=0, seconds=0, trace=True, device=None)
    c.units = [{"start": 0.0, "end": 1.0, "timings": t} for t in timings]
    c.summary = summary
    return c


DALLES = [{"forward_s": 0.36, "gather_s": 0.009, "stitch_s": 0.018, "stream_s": 0.004,
           "blocked_s": 0.030, "batches": 9},
          {"forward_s": 0.45, "gather_s": 0.018, "stitch_s": 0.027, "stream_s": 0.006,
           "blocked_s": 0.050, "batches": 9}]


@pytest.mark.parametrize("name,want", [
    ("forward_host_ms_per_batch.zonal", 1e3 * (0.04 + 0.05) / 2),
    ("engine_host_ms_per_batch.zonal", 1e3 * (0.003 + 0.005) / 2),
    ("stream_ms_per_dalle.zonal", 5.0),
    ("host_blocked_ms_per_dalle.zonal", 40.0)])
def test_zonal_readers_average_the_window_dalles(name, want):
    assert registry.metric_reader(name).read(ctx_with(DALLES)) == pytest.approx(want)


@pytest.mark.parametrize("name", ZONAL)
def test_zonal_readers_read_nothing_from_an_older_record(name):
    old = [{"put_s": 0.015, "finalize_s": 0.02, "dispatch_s": 0.4}] * 2
    assert registry.metric_reader(name).read(ctx_with(old)) is None
    assert registry.metric_reader(name).read(ctx_with([])) is None


@pytest.mark.parametrize("name,span", [(TRAIN[0], "train.forward"),
                                       (TRAIN[1], "train.backward")])
def test_training_readers_divide_device_time_by_spans(monkeypatch, name, span):
    from flair_for_aigle_tpu_torch.utils import profiling

    reader = registry.metric_reader(name)
    monkeypatch.setattr(profiling, "device_times",
                        lambda: {span: (480.0, 6), "train.other": (1.0, 1)})
    assert reader.read(ctx_with([], summary=object())) == pytest.approx(80.0)
    assert reader.read(ctx_with([], summary=None)) is None
    monkeypatch.setattr(profiling, "device_times", lambda: {})
    assert reader.read(ctx_with([], summary=object())) is None
    monkeypatch.delattr(profiling, "device_times")
    assert reader.read(ctx_with([], summary=object())) is None


def test_the_span_metrics_are_declared_for_their_cells():
    b = registry.load_benchmark()
    per_layer = {m["name"]: m for m in b["per_layer"]}
    for name in ZONAL + TRAIN:
        m = per_layer[name]
        assert m["unit"] == "ms" and m["better"] == "lower"
        assert m["source"] == ("program_counter" if "blocked" in name else "program_span")
        kind = "zonal" if name.endswith(".zonal") else "train"
        assert m["workloads"] == [w["name"] for w in b["workloads"]
                                  if registry.traffic(w["traffic"])["kind"] == kind]


def test_a_small_traced_zonal_run_reads_the_zonal_spans():
    out = small.run("zonal-swinb-dalle-b16", 26, trace=True, traffic=small.FLAT)
    assert out["correct"] is True
    for name in ZONAL:
        assert out["metrics"][name]["value"] >= 0, name
    assert out["metrics"]["forward_host_ms_per_batch.zonal"]["value"] > 0
