"""Traced units: run a driver's units under ``torch.profiler`` and sum
the trace (``trace.py``). Spans are the benchmark's own
``record_function`` annotations around its calls into the port."""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import torch

from benchmark import trace as tracing
from benchmark.context import Context


def sync(ctx: Context) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def unit_quartiles(units: list) -> list[float]:
    """Min, quartiles and max of the units' seconds (for the record)."""
    import statistics

    secs = sorted(u["end"] - u["start"] for u in units)
    qs = statistics.quantiles(secs, n=4) if len(secs) > 1 else secs * 3
    return [secs[0], *qs, secs[-1]]


def port_kernel_names() -> frozenset[str]:
    from flair_for_aigle_tpu_torch.ops import _build

    return tracing.port_kernel_names(_build.CSRC)


def trace_units(ctx: Context, run_unit, count: int, start: int) -> tuple[int, object]:
    """``count`` units (``run_unit(index)``) under ``torch.profiler`` with
    CPU and CUDA activity, synchronised at the end: their number and the
    summary of their trace over the span ``bench.traced``. The trace is written to a temporary directory
    (``TMPDIR``) and removed once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("bench.traced"):
            for k in range(count):
                run_unit(start + k)
            sync(ctx)
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return count, tracing.summarize(trace, port_kernel_names(), window="bench.traced")
