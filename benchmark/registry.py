"""Find the benchmark's parts by name: the cell in ``BENCHMARK.json``, its
configuration, traffic, limits, drivers, metric readers, kernels and
architecture families. A later cell, configuration, metric or kernel is a
new file here and a new entry in ``BENCHMARK.json``; no file is edited.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType

#: the benchmark's directory and the checkout's root (read at each call)
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

_modules: dict[str, ModuleType] = {}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str | None = None) -> dict:
    return load_json(os.path.join(root or ROOT, "BENCHMARK.json"))


def _named(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: str | None = None) -> dict:
    """The configuration's file, with its ``BENCHMARK.json`` entry under
    ``entry``."""
    entry = _named(bench["configs"], name, "configuration")
    cfg = load_json(os.path.join(root or ROOT, entry["file"]))
    cfg["entry"] = entry
    return cfg


def traffic(name: str, base: str | None = None) -> dict:
    return load_json(os.path.join(base or HERE, "traffic", f"{name}.json"))


def limits(workload_name: str, base: str | None = None) -> dict:
    return load_json(os.path.join(base or HERE, "limits", f"{workload_name}.json"))


def peaks(base: str | None = None) -> dict:
    return load_json(os.path.join(base or HERE, "peaks.json"))


def _load_module(path: str) -> ModuleType:
    """The module at ``path``, loaded once (file names may hold dots)."""
    path = os.path.abspath(path)
    mod = _modules.get(path)
    if mod is None:
        key = "benchmark._by_path." + os.path.relpath(path, HERE).replace(
            os.sep, "__").replace(".", "_")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return mod


def driver(kind: str, base: str | None = None) -> ModuleType:
    return _load_module(os.path.join(base or HERE, "drivers", f"{kind}.py"))


def family(name: str, base: str | None = None) -> ModuleType:
    return _load_module(os.path.join(base or HERE, "families", f"{name}.py"))


def kernel(name: str, base: str | None = None) -> ModuleType:
    return _load_module(os.path.join(base or HERE, "kernels", f"{name}.py"))


def kernel_names(base: str | None = None) -> list[str]:
    return sorted(f[:-3] for f in os.listdir(os.path.join(base or HERE, "kernels"))
                  if f.endswith(".py") and not f.startswith("_"))


def metric_reader(name: str, base: str | None = None) -> ModuleType:
    return _load_module(os.path.join(base or HERE, "metrics", f"{name}.py"))


def reports(metric: dict, workload_name: str) -> bool:
    """Whether a cell reports an end-to-end metric."""
    return "workloads" not in metric or workload_name in metric["workloads"]


def per_layer_for(bench: dict, workload_name: str) -> list[dict]:
    """The cell's per-layer metrics: those that list it, and those without
    a list whose end-to-end metric the cell reports."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if workload_name in m["workloads"]:
                out.append(m)
        elif reports(e2e[m["moves"]], workload_name):
            out.append(m)
    return out


def end_to_end_for(bench: dict, workload_name: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if reports(m, workload_name)]
