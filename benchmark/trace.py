"""Summaries of a ``torch.profiler`` Chrome trace: the device's busy time
as the union of its kernel, copy and set intervals, idle gaps and what the
host did in them, device time by kernel name, and the split between the
port's own kernels (``__global__`` functions of its ``csrc/``) and the
library's (cuDNN, cuBLAS, eager PyTorch)."""

from __future__ import annotations

import bisect
import os
import re
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: gaps shorter than this are launch gaps: counted, not attributed one by one
ATTRIBUTE_GAP_US = 20.0

_GLOBAL = re.compile(r"__global__\s+(?:static\s+)?(?:inline\s+)?void\s+(\w+)\s*\(")


def _strip_launch_bounds(text: str) -> str:
    """The source without its ``__launch_bounds__(...)`` qualifiers
    (their arguments may hold parentheses)."""
    out, i = [], 0
    while True:
        j = text.find("__launch_bounds__", i)
        if j < 0:
            return "".join(out) + text[i:]
        out.append(text[i:j])
        k = text.index("(", j)
        depth = 0
        for k in range(k, len(text)):
            depth += {"(": 1, ")": -1}.get(text[k], 0)
            if depth == 0:
                break
        i = k + 1


def port_kernel_names(csrc_dir: str) -> frozenset[str]:
    """Names of every ``__global__`` function in the port's CUDA sources."""
    names = set()
    for name in sorted(os.listdir(csrc_dir)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc_dir, name)) as f:
                text = _strip_launch_bounds(f.read())
            names.update(_GLOBAL.findall(text))
    return frozenset(names)


def base_name(kernel: str) -> str:
    """The function's identifier: no ``void``, template arguments,
    parameters or namespace."""
    name = kernel.strip()
    if name.startswith("void "):
        name = name[5:]
    name = re.split(r"[<(]", name, 1)[0]
    return name.rsplit("::", 1)[-1].strip()


@dataclass
class Event:
    name: str
    cat: str
    start: float  # microseconds
    end: float


@dataclass
class Summary:
    window_us: float
    busy_us: float
    device_by_name: dict = field(default_factory=dict)  # name -> [us, calls]
    port_us: float = 0.0
    library_us: float = 0.0
    memcpy_us: dict = field(default_factory=dict)  # "HtoD" ... -> us
    idle_gaps: list = field(default_factory=list)  # [label, us], longest first

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_us / self.window_us

    def sum_matching(self, predicate) -> float:
        """Device microseconds of the kernels whose name satisfies it."""
        return sum(us for name, (us, _) in self.device_by_name.items() if predicate(name))


def events(trace: dict) -> list[Event]:
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start = float(e["ts"])
        out.append(Event(e.get("name", ""), e.get("cat", ""), start, start + float(e["dur"])))
    return out


def merge(intervals) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def memcpy_kind(name: str) -> str:
    m = re.search(r"Memcpy (\w+)", name)
    return m.group(1) if m else name


def summarize(trace: dict, port_names, window: str | None = None) -> Summary:
    """The trace's summary over the host span of the user annotation named
    ``window`` (its first occurrence), or over the first to the last
    device event when ``window`` is None or absent."""
    evs = events(trace)
    dev = [e for e in evs if e.cat in DEVICE_CATS]
    lo = hi = None
    if window is not None:
        for e in evs:
            if e.cat == "user_annotation" and e.name == window:
                lo, hi = e.start, e.end
                break
    if lo is None:
        if not dev:
            raise ValueError("the trace holds no device event")
        lo, hi = min(e.start for e in dev), max(e.end for e in dev)
    dev = [e for e in dev if e.end > lo and e.start < hi]
    busy = clip(merge((e.start, e.end) for e in dev), lo, hi)
    s = Summary(window_us=hi - lo, busy_us=sum(e - b for b, e in busy))
    for e in dev:
        dur = min(e.end, hi) - max(e.start, lo)
        if e.cat == "gpu_memcpy":
            kind = memcpy_kind(e.name)
            s.memcpy_us[kind] = s.memcpy_us.get(kind, 0.0) + dur
        if e.cat != "kernel":
            continue
        us_calls = s.device_by_name.setdefault(e.name, [0.0, 0])
        us_calls[0] += dur
        us_calls[1] += 1
        if base_name(e.name) in port_names:
            s.port_us += dur
        else:
            s.library_us += dur
    host = [e for e in evs if e.cat in HOST_CATS and e.name != window]
    s.idle_gaps = attribute_gaps(host, busy, lo, hi)
    return s


def gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    out, t = [], lo
    for b, e in busy:
        if b > t:
            out.append((t, b))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def attribute_gaps(host_events, busy, lo: float, hi: float) -> list[list]:
    """Idle time summed by what the host was doing: the innermost host
    event covering each gap's middle; gaps under ``ATTRIBUTE_GAP_US`` are
    summed as launch gaps. Longest total first."""
    host = sorted(host_events, key=lambda e: e.start)
    starts = [e.start for e in host]
    totals: dict[str, float] = {}
    for b, e in gaps(busy, lo, hi):
        dur = e - b
        if dur < ATTRIBUTE_GAP_US:
            label = f"launch gaps under {ATTRIBUTE_GAP_US:g} us"
        else:
            mid = (b + e) / 2
            best = None
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - 4000), -1):
                h = host[j]
                if h.end >= mid and (best is None or h.end - h.start < best.end - best.start):
                    best = h
            label = best.name if best is not None else "host, no traced op"
        totals[label] = totals.get(label, 0.0) + dur
    return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])
