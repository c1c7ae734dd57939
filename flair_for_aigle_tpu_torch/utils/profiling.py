"""Spans, counters and the Chrome trace of the port.

Port of ``flair_for_aigle_tpu/utils/profiling.py``, whose ``StageTimers``
it replaces with spans inside the program:

* ``span(name, key)`` times one phase of a call on the host and adds its
  seconds to the current call's record (``recording``) under ``key`` (its
  name by default). While a ``torch.profiler`` session is on (the
  benchmark's traced units, or ``profile_trace(logdir)``) it also enters
  ``torch.profiler.record_function(name)``, so that the phase lies in the
  Chrome trace as a ``user_annotation`` inside its parent's, on the clock
  of the card's kernels and copies. With the profiler off a span costs a
  flag read and two clock reads. A span given a CUDA ``device`` also
  records a ``torch.cuda.Event`` at each edge while the profiler is on;
  ``device_times()`` sums their intervals by span name.
* ``count(key, n)`` adds to the current call's record, and ``blocked()``
  adds the host seconds of a call that waits for the card to its
  ``blocked_s``.
* ``profile_trace(logdir)`` profiles a block and writes its Chrome trace,
  viewable in Perfetto or ``chrome://tracing``.

The record and the device sums are the process's: spans are entered from
the thread that drives the card.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from typing import Dict, Tuple

import torch

logger = logging.getLogger(__name__)

#: whether a ``torch.profiler`` session is on (the flag that
#: ``torch.autograd.profiler._is_profiler_enabled`` mirrors)
tracing = torch._C._autograd._profiler_enabled

_clock = time.perf_counter
_record: Dict | None = None
#: (span name, start event, end event) not yet read; name -> [ms, count]
_pending: list = []
_device_ms: Dict[str, list] = {}


@contextlib.contextmanager
def recording(record: Dict):
    """Make ``record`` the current call's record for the block: cleared on
    entry; the block's spans and counters add to it."""
    global _record
    outer, _record = _record, record
    record.clear()
    try:
        yield record
    finally:
        _record = outer


def count(key: str, n: float = 1) -> None:
    """Add ``n`` to ``key`` of the current call's record, if any."""
    rec = _record
    if rec is not None:
        rec[key] = rec.get(key, 0) + n


class span:
    """A phase of a call: ``with span(name, key, device):``, or
    ``@span(name, key)`` over a function for a span per call."""

    __slots__ = ("name", "key", "device", "_t0", "_rf", "_start")

    def __init__(self, name: str, key: str | None = None,
                 device: torch.device | None = None):
        self.name = name
        self.key = key or name
        self.device = device

    def __enter__(self) -> "span":
        self._rf = None
        if tracing():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
            self._start = None
            if self.device is not None and self.device.type == "cuda":
                self._start = torch.cuda.Event(enable_timing=True)
                self._start.record(torch.cuda.current_stream(self.device))
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dt = _clock() - self._t0
        if self._rf is not None:
            if self._start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(self.device))
                _pending.append((self.name, self._start, end))
            self._rf.__exit__(exc_type, exc, tb)
        rec = _record
        if rec is not None:
            key = self.key
            rec[key] = rec.get(key, 0.0) + dt

    def __call__(self, fn):
        name, key, device = self.name, self.key, self.device

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, key, device):
                return fn(*args, **kwargs)

        return spanned


class blocked:
    """``with blocked():`` around a call that waits for the card: its host
    seconds add to ``blocked_s`` of the current call's record."""

    __slots__ = ("_t0",)

    def __enter__(self) -> None:
        self._t0 = _clock()

    def __exit__(self, exc_type, exc, tb) -> None:
        count("blocked_s", _clock() - self._t0)


def device_times() -> Dict[str, Tuple[float, int]]:
    """{span name: (device ms, spans)} of the device-timed spans entered
    while a profiler session was on, summed since the process started.
    Waits for the spans' last events: read it after a synchronise."""
    while _pending:
        name, start, end = _pending.pop()
        end.synchronize()
        acc = _device_ms.setdefault(name, [0.0, 0])
        acc[0] += start.elapsed_time(end)
        acc[1] += 1
    return {k: (ms, n) for k, (ms, n) in _device_ms.items()}


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """Profile the block with ``torch.profiler`` when ``logdir`` is set (the
    host's operators and the port's spans, and the card's kernels when a
    CUDA device is present), a no-op otherwise; on exit the Chrome trace
    is written to ``<logdir>/trace_<pid>_<time ns>.json``."""
    if not logdir:
        yield
        return
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
