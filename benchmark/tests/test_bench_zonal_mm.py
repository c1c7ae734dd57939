"""The aerial + Sentinel-2 cell (``zonal-mm-swinb-utae``, traffic kind
``zonal_mm``) at a small size on the CPU: the registry finds its parts, its
FLOP counter agrees with torch's own on the reference, a sound run is
correct and each planted fault of the series route is not, its readers
read the port's new spans and counters and nothing from a program without
them, and a whole run loads neither JAX nor the JAX package."""

import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import context, control_mm, registry
from benchmark.reference import utae as uref
from benchmark.tests import small, small_mm

CELL = small_mm.WORKLOAD
NEW = ["series_host_ms_per_dalle.zonal", "utae_device_ms_per_batch.zonal",
       "series_pad_share.zonal"]


def test_registry_finds_the_cell_parts():
    bench = registry.load_benchmark()
    cell = registry.workload(bench, CELL)
    cfg = registry.config(bench, cell["config"])
    assert cell["chips"] == 1 and cfg["entry"]["reduced"] == [] and cfg["reduced"] == []
    tr = registry.traffic(cell["traffic"])
    assert tr["kind"] == "zonal_mm" and registry.driver(tr["kind"]).run
    assert registry.limits(CELL)["unowned_written"] == 0
    fam = registry.family(cfg["family"])
    assert fam.modalities(cfg) == ("AERIAL_RGBI", "SENTINEL2_TS", "AERIAL_LABEL-COSIA", 10)
    # the published widths
    assert cfg["encoder"]["embed_dim"] == 128 and cfg["encoder"]["depths"] == [2, 2, 18, 2]
    assert cfg["encoder"]["num_heads"] == [4, 8, 16, 32] and cfg["encoder"]["window_size"] == 12
    assert fam.widths(cfg) == cfg["utae"]["adjusted_widths"] == [64, 64, 128, 128]
    u = cfg["utae"]
    assert (u["d_model"], u["n_head"], u["d_k"], u["out_conv"]) == (256, 16, 4, [32, 19])
    assert (u["str_conv_k"], u["str_conv_s"], u["str_conv_p"]) == (3, 1, 1)
    assert cfg["kernels"]["zonal"] == cfg["kernels"]["zonal_mm"]
    names = {m["name"] for m in registry.per_layer_for(bench, CELL)}
    assert set(NEW) <= names and "dalle_p90_s" not in {
        m["name"] for m in registry.end_to_end_for(bench, CELL)}
    for name in NEW:
        spec = next(m for m in bench["per_layer"] if m["name"] == name)
        assert spec["workloads"] == [CELL]


def test_flop_counter_matches_torch_on_the_reference():
    cfg = registry.config(registry.load_benchmark(), "swinb-upernet-utae")
    cfg["encoder"] = dict(cfg["encoder"], embed_dim=8, depths=[1, 1, 1, 1],
                          num_heads=[1, 1, 2, 2], window_size=2)
    cfg["decoder"] = {"name": "upernet", "pyramid_channels": 8, "segmentation_channels": 4}
    fam = registry.family(cfg["family"])
    model = fam.build(cfg, 3).eval()
    frames = torch.rand((1, 5, 10, 6, 6)) + 1  # no padding frame
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.randn(1, 3, 64, 64), frames, torch.arange(5.0)[None])
    assert counter.get_total_flops() == fam.forward_flops(cfg, 64, 3, dates=5, series_px=6)


def test_published_size():
    """Swin-B UPerNet at 512 px about 190 GFLOP a tile; U-TAE on 37 dates of
    10 x 10 and the fusion add a few percent."""
    cfg = registry.config(registry.load_benchmark(), "swinb-upernet-utae")
    fam = registry.family(cfg["family"])
    base = registry.family("swin").forward_flops(cfg, 512, 3)
    full = fam.forward_flops(cfg, 512, 3, dates=37, series_px=10)
    assert 1.0 < full / base < 1.1 and fam.utae_flops(cfg, 37, 10, 10) > 0


def test_a_sound_small_run_is_correct():
    out = small_mm.run(21, traffic=small.FLAT)
    assert out["correct"] is True, out["checks"]
    assert out["info"]["codec_modes"] == {"rle": out["attempted"]}


@pytest.mark.parametrize("fault", sorted(control_mm.FAULTS))
def test_each_planted_fault_is_not_correct(fault):
    out = small_mm.run(59, fault=control_mm.FAULTS[fault])
    assert out["correct"] is False
    assert out["checks"]["label_gap"]["value"] > out["checks"]["label_gap"]["limit"]


def test_a_traced_run_reads_the_new_spans_and_counters():
    out = small_mm.run(24, trace=True)
    m = out["metrics"]
    assert m["series_host_ms_per_dalle.zonal"]["value"] > 0
    assert 0 < m["series_pad_share.zonal"]["value"] < 100
    # U-TAE's device time comes from the trace's device intervals: none on
    # the CPU
    assert "utae_device_ms_per_batch.zonal" not in m
    assert out["info"]["series_frames_per_dalle"] > 0
    assert 1 <= out["info"]["kept_dates_per_tile"] <= 73


def _ctx(timings):
    c = context.Context(bench={}, cell={"name": CELL, "chips": 1}, config={}, traffic={},
                        limits={}, seed=0, seconds=0, trace=True, device=None)
    c.units = [{"start": 0.0, "end": 1.0, "timings": t} for t in timings]
    return c


def test_readers_on_records_with_and_without_the_series():
    with_series = [{"series_s": 0.2, "series_frames": 600, "series_frames_padded": 60},
                   {"series_s": 0.4, "series_frames": 400, "series_frames_padded": 40}]
    ctx = _ctx(with_series)
    assert registry.metric_reader(NEW[0]).read(ctx) == pytest.approx(300.0)
    assert registry.metric_reader(NEW[2]).read(ctx) == pytest.approx(10.0)
    assert registry.metric_reader(NEW[1]).read(ctx) is None  # no trace summary
    ctx.info["span_device_ms"] = {"model.encoder.utae": [30.0, 6]}
    assert registry.metric_reader(NEW[1]).read(ctx) == pytest.approx(5.0)
    older = _ctx([{"forward_s": 0.3, "batches": 9}])  # a program without them
    assert all(registry.metric_reader(n).read(older) is None for n in NEW)


def test_span_device_time_is_the_union_of_its_launches():
    """``span_device_us``: per span, the union of the device intervals of
    the launches made from its thread while it was open; a launch on
    another thread, or after the span, does not count, nor the host's
    gaps between the kernels."""
    from benchmark.drivers import zonal_mm as dmm

    def ev(name, cat, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    trace = {"traceEvents": [
        ev("model.encoder.utae", "user_annotation", 100, 50),
        ev("cudaLaunchKernel", "cuda_runtime", 110, 2, corr=1),
        ev("cudaLaunchKernel", "cuda_runtime", 120, 2, corr=2),
        ev("cudaMemcpyAsync", "cuda_runtime", 130, 2, tid=2, corr=3),  # another thread
        ev("cudaLaunchKernel", "cuda_runtime", 160, 2, corr=4),  # after the span
        ev("k1", "kernel", 200, 10, tid=9, corr=1),
        ev("k2", "kernel", 205, 10, tid=9, corr=2),  # overlaps k1: union 15
        ev("Memcpy DtoH", "gpu_memcpy", 300, 40, tid=9, corr=3),
        ev("k4", "kernel", 400, 10, tid=9, corr=4),
        ev("model.encoder.utae", "user_annotation", 500, 50),
        ev("cuLaunchKernel", "cuda_driver", 510, 2, corr=5),
        ev("k5", "kernel", 600, 7, tid=9, corr=5),
        ev("k6", "kernel", 700, 7, tid=9, corr=6),  # launch not traced
    ]}
    assert dmm.span_device_us(trace, "model.encoder.utae") == [15.0, 7.0]
    assert dmm.span_device_us(trace, "model.fusion") == []


def test_reference_selection_keeps_clear_dates_and_falls_back():
    import numpy as np

    mask = np.zeros((4, 2, 10, 10), np.uint8)
    mask[1, 1, :, :1] = 50  # 10 % cloudy: dropped
    mask[2, 1, 0, :5] = 50  # 5 % cloudy: kept
    mask[3, 0, :, :] = 2  # snowy: dropped
    assert uref.kept_dates(mask).tolist() == [True, False, True, False]
    cloudy = np.full((2, 2, 4, 4), 9, np.uint8)
    cloudy[1, 0] = 0  # snow clear on date 1 alone: snow decides
    assert uref.kept_dates(cloudy).tolist() == [False, True]
    assert uref.kept_dates(np.full((2, 2, 4, 4), 9, np.uint8)).tolist() == [True, True]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import json, torch\n"
        "from benchmark import context, isolation\n"
        "from benchmark.tests import small_mm\n"
        "out = small_mm.run(3)\n"
        "print(json.dumps(isolation.forbidden_loaded()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
