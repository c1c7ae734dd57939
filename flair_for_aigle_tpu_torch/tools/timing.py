"""Two ways to time one call on the card, shared by ``chip_smoke.py`` and
``tools/time_ffn.py``:

- ``cuda_ms``: CUDA events around each call, the median of 20. Where a
  call's host work (the wrapper's Python, the library's dispatch) outlasts
  its device work, this times the host.
- ``device_ms``: calls queued behind a spin of the card, so the host's work
  is hidden, between two CUDA events: the call's device time.
"""

from __future__ import annotations

import time

import torch


def cuda_ms(fn, reps: int = 20) -> float:
    """Median device time of fn() in ms (CUDA events around each call)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one fn() in ms: ``reps`` calls queued behind a spin of
    the card twice as long as the host takes to enqueue them (at least 20
    ms), so the host's work (the wrapper's Python, the library's dispatch)
    is hidden, between two CUDA events; the median of 3 such runs. For
    calls whose device work is shorter than their host work, where cuda_ms
    times the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    spin = int(max(20.0, 2 * reps * host_ms) * 2e6)  # cycles: >= 1 ms per 2e6 up to 2 GHz
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / reps)
    runs.sort()
    return runs[1]
