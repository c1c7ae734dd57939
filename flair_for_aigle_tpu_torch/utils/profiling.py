"""Profiling / tracing hooks (torch.profiler + stage timers).

Port of ``flair_for_aigle_tpu/utils/profiling.py``: ``StageTimers``
accumulates per-stage wall time (slicing, IO, device step, stitch, write),
and ``profile_trace(logdir)`` captures a ``torch.profiler`` trace (the host's
operators, and the card's kernels and copies when a CUDA device is present)
written as a Chrome trace, viewable in Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict

logger = logging.getLogger(__name__)


class StageTimers:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{'stage':<24} {'total_s':>10} {'calls':>8} {'mean_ms':>10}"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:<24} {total:>10.3f} {n:>8} {1000 * total / n:>10.2f}"
            )
        report = "\n".join(lines)
        logger.info("\n%s", report)
        return report


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """Profile the block with ``torch.profiler`` when ``logdir`` is set (the
    host's operators, and the card's kernels when a CUDA device is
    present), a no-op otherwise; on exit the Chrome trace is written to
    ``<logdir>/trace_<pid>_<time ns>.json``."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        logger.info("torch profiler trace written to %s", path)
