"""The harness is driven by data: a configuration, a cell and a metric are
added as new files and new ``BENCHMARK.json`` entries alone, and
``BENCHMARK.json`` keeps to the benchmark's contract."""

import json
import os
import re
import shutil

import pytest

from benchmark import context, registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture()
def copy_of_benchmark(tmp_path, monkeypatch):
    """The benchmark and its BENCHMARK.json copied to a fresh root, the
    registry pointed at the copy."""
    root = tmp_path / "checkout"
    shutil.copytree(registry.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    monkeypatch.setattr(registry, "HERE", str(root / "benchmark"))
    monkeypatch.setattr(registry, "ROOT", str(root))
    return root


def test_new_configuration_cell_and_metric_need_no_edit(copy_of_benchmark):
    root = copy_of_benchmark
    files_before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    # a new configuration: a file of its own
    cfg = json.loads((root / "benchmark/configs/swinb-upernet.json").read_text())
    cfg["name"] = "swint-upernet"
    cfg["encoder"].update(embed_dim=96, depths=[2, 2, 6, 2], num_heads=[3, 6, 12, 24])
    (root / "benchmark/configs/swint-upernet.json").write_text(json.dumps(cfg))
    # a new metric: a reader of its own
    (root / "benchmark/metrics/tiles_per_dalle.zonal.py").write_text(
        "def read(ctx):\n    return float(ctx.per_unit['tiles'])\n")
    # a new cell: its limits
    (root / "benchmark/limits/zonal-swint-dalle-b16.json").write_text(
        json.dumps({"label_gap": 1.0, "unowned_written": 0}))
    bench["configs"].append({"name": "swint-upernet", "source": "https://arxiv.org/abs/2103.14030",
                             "file": "benchmark/configs/swint-upernet.json", "reduced": [],
                             "why": "a smaller Swin"})
    bench["workloads"].append({"name": "zonal-swint-dalle-b16", "config": "swint-upernet",
                               "traffic": "dalle-b16", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "tiles_per_dalle.zonal", "unit": "tiles",
                               "better": "higher", "source": "program_counter",
                               "layer": "engine", "moves": "km2_per_h",
                               "workloads": ["zonal-swint-dalle-b16"]})
    for m in bench["end_to_end"]:
        if m["name"] == "km2_per_h":
            m["workloads"].append("zonal-swint-dalle-b16")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = registry.load_benchmark()
    found = registry.config(bench, "swint-upernet")
    assert found["encoder"]["embed_dim"] == 96
    fam = registry.family(found["family"])
    assert fam.forward_flops(found, 512, 3) < fam.forward_flops(
        registry.config(bench, "swinb-upernet"), 512, 3)
    ctx = context.Context(bench, registry.workload(bench, "zonal-swint-dalle-b16"), found,
                          registry.traffic("dalle-b16"),
                          registry.limits("zonal-swint-dalle-b16"), 1, 1.0, True, None)
    ctx.per_unit = {"tiles": 144, "area_km2": 1.0, "batches": 9, "batch_size": 16}
    ctx.units = [{"start": 0.0, "end": 0.5}]
    ctx.window_s = 0.5
    names = [m["name"] for m in registry.per_layer_for(bench, ctx.name)]
    assert "tiles_per_dalle.zonal" in names
    assert registry.metric_reader("tiles_per_dalle.zonal").read(ctx) == 144.0
    # no file that was there changed
    for p, data in files_before.items():
        assert p.read_bytes() == data, p


def test_new_kernel_is_found_by_name(copy_of_benchmark):
    root = copy_of_benchmark
    (root / "benchmark/kernels/k9_new.py").write_text(
        'NAME = "k9_new"\nPATTERNS = ()\n\n\ndef work(geo, batch, elem_bytes):\n'
        '    return 2.0 * batch, 4.0 * batch\n')
    assert "k9_new" in registry.kernel_names()
    assert registry.kernel("k9_new").work({}, 16, 2) == (32.0, 64.0)


def test_benchmark_json_keeps_to_the_contract():
    path = os.path.join(registry.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    b = registry.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        assert registry.config(b, c["name"])["name"] == c["name"]
        assert os.path.exists(os.path.join(registry.HERE, "families",
                                           registry.config(b, c["name"])["family"] + ".py"))
    cells = {w["name"]: w for w in b["workloads"]}
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        tr = registry.traffic(w["traffic"])
        assert os.path.exists(os.path.join(registry.HERE, "drivers", tr["kind"] + ".py"))
        assert registry.limits(w["name"])
        cfg = registry.config(b, w["config"])
        for k in cfg["kernels"][tr["kind"]]:
            assert k in registry.kernel_names()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert os.path.exists(os.path.join(registry.HERE, "metrics", m["name"] + ".py"))
        assert set(m.get("workloads", [])) <= set(cells)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        for cell in m.get("workloads", cells):
            assert registry.reports(e2e[m["moves"]], cell)
    for cell in cells:
        reported = [m["name"] for m in registry.end_to_end_for(b, cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert registry.per_layer_for(b, cell)
