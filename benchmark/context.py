"""One run of one cell: what its driver records, and the assembly of the
result line from the metric readers."""

from __future__ import annotations

import os
import subprocess
from dataclasses import dataclass, field

import torch

from benchmark import registry


def process_age_s() -> float:
    """Seconds since this process started (``/proc``, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])  # field 22, starttime
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.strip().splitlines()[0]


@dataclass
class Context:
    bench: dict
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    #: units of work in the window (dalles, steps): dicts with start, end (s)
    units: list = field(default_factory=list)
    window_s: float = 0.0
    setup_s: float = 0.0
    #: work of one unit: "area_km2", "tiles", "batches", "samples"
    per_unit: dict = field(default_factory=dict)
    #: model operations of one unit (the forward of its tiles, or 3 x the
    #: forward of a step's samples)
    flops_per_unit: float = 0.0
    #: "bf16" or "tf32": the tensor-core rate of the configuration's dtype
    precision: str = "bf16"
    elem_bytes: int = 2
    #: kernels/<name>.py the configuration launches on this path, and the
    #: geometry their work is counted at
    port_kernels: list = field(default_factory=list)
    geo: dict = field(default_factory=dict)
    #: the traced units' trace summary (benchmark.trace.Summary) and count
    summary: object = None
    traced_units: int = 0
    peak_mem_bytes: int = 0
    peaks: dict | None = None
    card: str = "cpu"
    checks: list = field(default_factory=list)
    info: dict = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.cell["name"]

    def peak_flops(self) -> float | None:
        return None if self.peaks is None else self.peaks[self.precision + "_flops"]

    def kernel_bound_s(self, batches: float) -> float | None:
        """The least time of the port kernels' work over ``batches``
        batches: per kernel, the larger of its operations at the tensor
        rate and its bytes at the memory rate."""
        if self.peaks is None or not self.port_kernels:
            return None
        per_batch = 0.0
        for name in self.port_kernels:
            flops, nbytes = registry.kernel(name).work(self.geo, self.per_unit["batch_size"],
                                                       self.elem_bytes)
            per_batch += max(flops / self.peak_flops(), nbytes / self.peaks["hbm_bytes_per_s"])
        return per_batch * batches

    def add_check(self, name: str, value: float, limit: float) -> None:
        self.checks.append({"name": name, "value": value, "limit": limit})


def make(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
         device: torch.device, config_override: dict | None = None,
         traffic_override: dict | None = None) -> Context:
    cell = registry.workload(bench, workload)
    cfg = registry.config(bench, cell["config"])
    tr = registry.traffic(cell["traffic"])
    cfg.update(config_override or {})
    tr.update(traffic_override or {})
    ctx = Context(bench, cell, cfg, tr, registry.limits(workload), int(seed), float(seconds),
                  bool(trace), device)
    if device.type == "cuda":
        ctx.card = card_line()
        name = torch.cuda.get_device_name(device)
        ctx.peaks = registry.peaks().get(name)
        ctx.info["card"] = ctx.card
    return ctx


def result(ctx: Context) -> dict:
    """The result line: end-to-end metrics (untraced runs) or per-layer
    metrics (traced runs) from their readers, the device, the checks
    that decide ``correct`` last."""
    specs = (registry.per_layer_for(ctx.bench, ctx.name) if ctx.trace
             else registry.end_to_end_for(ctx.bench, ctx.name))
    metrics = {}
    for spec in specs:
        value = registry.metric_reader(spec["name"]).read(ctx)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                       else "cpu"),
              "count": ctx.cell["chips"], "memory_peak_bytes": ctx.peak_mem_bytes}
    # a unit that raises ends the run without a result, so none failed here
    out = {"correct": bool(ctx.checks) and all(c["value"] <= c["limit"] for c in ctx.checks),
           "attempted": len(ctx.units), "failed": 0, "metrics": metrics, "device": device}
    if ctx.trace and ctx.summary is not None:
        device["busy_s"] = ctx.summary.busy_us / 1e6
        device["window_s"] = ctx.summary.window_us / 1e6
        ops = sorted(ctx.summary.device_by_name.items(), key=lambda kv: -kv[1][0])
        out["breakdown"] = {
            "device_ops": [[k[:120], us / 1e6] for k, (us, _) in ops[:10]],
            "idle_gaps": [[k[:120], us / 1e6] for k, us in ctx.summary.idle_gaps[:10]]}
    out["info"] = ctx.info
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in ctx.checks}
    return out
