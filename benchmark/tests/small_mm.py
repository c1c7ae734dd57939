"""A small version of the aerial + Sentinel-2 cell for the CPU tests: the
same harness, the port's plain versions, a one-block-a-stage Swin at the
published widths with the published U-TAE, tiles of 96 px on dalles of
200 px at batch 8, and a series at 2 m (10 px a tile) whose clouds and
fields shrink alike."""

from __future__ import annotations

import copy

import torch

from benchmark import context, registry

WORKLOAD = "zonal-mm-swinb-utae"
#: the fusion's gain on U-TAE's maps at this size: a tile of 96 px and a
#: one-block Swin give smaller logits and far fewer pixels than the cell's,
#: so a fault in the series route moves the widest label gap less; 12 in
#: place of the cell's 4 lifts the faults' readings above the cell's limit
#: while the sound runs' stay within half of it
SMALL_GAIN = 12.0


def overrides() -> tuple[dict, dict]:
    bench = registry.load_benchmark()
    cfg = registry.config(bench, registry.workload(bench, WORKLOAD)["config"])
    zonal = copy.deepcopy(cfg["zonal"])
    zonal.update(img_pixels_detection=96, margin=8)
    over = {"encoder": dict(cfg["encoder"], depths=[1, 1, 1, 1]),
            "arch": "swin_micro_patch4_window12_384-upernet", "zonal": zonal,
            "utae": dict(cfg["utae"], series_fusion_gain=SMALL_GAIN)}
    tr = registry.traffic(registry.workload(bench, WORKLOAD)["traffic"])
    series = dict(tr["series"], res_m=2.0, field_px=4, cloud_px=6)
    traffic = {"side_px": 200, "fields_px": 80, "plots_px": 8, "warmup_px": 100, "pool": 2,
               "check_dalles": 2, "batch_size": 8, "trace_dalles": 1, "series": series}
    return over, traffic


def context_for(seed: int, trace: bool = False, seconds: float = 0.5,
                traffic: dict | None = None) -> context.Context:
    over, small = overrides()
    return context.make(registry.load_benchmark(), WORKLOAD, seed, seconds, trace,
                        torch.device("cpu"), over, dict(small, **(traffic or {})))


def run(seed: int, fault=None, **kw) -> dict:
    ctx = context_for(seed, **kw)
    registry.driver(ctx.traffic["kind"]).run(ctx, fault=fault)
    return context.result(ctx)
