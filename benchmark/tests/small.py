"""Small versions of the cells for the CPU tests: the same harness, the
port's plain versions, shallow encoders at the published widths' family,
tiles of 96 px and dalles of 200 px, their fields and plots shrunk alike."""

from __future__ import annotations

import copy

import torch

from benchmark import context, registry


def overrides(workload: str, compute_dtype: str | None = None) -> tuple[dict, dict]:
    bench = registry.load_benchmark()
    cfg = registry.config(bench, registry.workload(bench, workload)["config"])
    if cfg["family"] == "swin":
        over = {"encoder": dict(cfg["encoder"], depths=[1, 1, 1, 1]),
                "arch": "swin_micro_patch4_window12_384-upernet"}
    else:
        over = {"encoder": dict(cfg["encoder"], dims=[16, 32, 64, 128], depths=[1, 1, 1, 1]),
                "arch": "convnext_micro-upernet"}
    zonal = copy.deepcopy(cfg["zonal"])
    zonal.update(img_pixels_detection=96, margin=8)
    if compute_dtype:
        zonal["compute_dtype"] = compute_dtype
    over["zonal"] = zonal
    traffic = {"side_px": 200, "fields_px": 80, "plots_px": 8,
               "warmup_px": 96, "pool": 2, "check_dalles": 2,
               "check_batch": 4, "batch_size": 4, "trace_dalles": 1,
               "px": 64, "trace_steps": 1}
    if registry.traffic(registry.workload(bench, workload)["traffic"])["kind"] == "train":
        traffic["batch_size"] = 2
    return over, traffic


#: one flat field a dalle: the small encoders' label maps are noise-like on
#: shrunk parcels, so their runs reach the stripe codec's run-length tier
#: only where the whole dalle is one colour
FLAT = {"fields_px": 6000, "built_share": 0.0, "shade": 0, "texture": 0}


def context_for(workload: str, seed: int, trace: bool = False, seconds: float = 0.5,
                compute_dtype: str | None = None,
                traffic: dict | None = None) -> context.Context:
    over, small_traffic = overrides(workload, compute_dtype)
    return context.make(registry.load_benchmark(), workload, seed, seconds, trace,
                        torch.device("cpu"), over, dict(small_traffic, **(traffic or {})))


def run(workload: str, seed: int, **kw) -> dict:
    ctx = context_for(workload, seed, **kw)
    registry.driver(ctx.traffic["kind"]).run(ctx)
    return context.result(ctx)

