"""The port's bench (``python -m flair_for_aigle_tpu_torch.bench``) on the
CPU, at a toy size: the module's arch, patch, margin, batch and side
patched to swin_micro-upernet on a 64 x 64 raster (four 64 px tiles with
an 8 px margin, two batches of 2), two timed runs. Its one JSON line has
bench.py's keys and metric name, a positive km²/h, the tile count of the
port's tiling and ``detail.io`` naming the host IO it ran through: the
native GeoTIFF IO here, the in-memory stand-ins where libtiff or GEOS do
not load (as on the card machine).
"""

import json

import pytest

from flair_for_aigle_tpu_torch import bench
from flair_for_aigle_tpu_torch.zonal import memory_io

KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
DETAIL = {"elapsed_s", "all_runs_s", "tiles", "tiles_per_s", "patch", "margin", "batch", "arch",
          "best_run_phases", "card", "io"}


@pytest.fixture
def toy(monkeypatch):
    for name, value in (("ARCH", "swin_micro_patch4_window12_384-upernet"), ("PATCH", 64),
                        ("MARGIN", 8), ("BATCH", 2), ("KM2_SIDE_PX", 64), ("MIN_RUNS", 2),
                        ("MAX_RUNS", 2)):
        monkeypatch.setattr(bench, name, value)


def _check(result, out: str, io: str):
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert set(result) == KEYS and set(result["detail"]) == DETAIL
    assert result["metric"] == "km2_per_hour_zonal_20cm_vhr_per_chip"
    assert result["unit"] == "km2/h"
    assert result["value"] > 0
    assert result["vs_baseline"] == result["value"] / 900.0
    d = result["detail"]
    assert d["tiles"] == 4 and len(d["all_runs_s"]) == 2
    assert d["elapsed_s"] == min(d["all_runs_s"])
    assert result["value"] == (64 * 0.2 / 1000) ** 2 / (d["elapsed_s"] / 3600)
    assert (d["patch"], d["margin"], d["batch"], d["card"]) == (64, 8, 2, "cpu")
    assert {"read_s", "dispatch_s", "finalize_s", "total_s"} <= set(d["best_run_phases"])
    assert d["io"].startswith(io), d["io"]


def test_bench_prints_its_line_on_the_cpu(toy, tmp_path, capsys):
    result = bench.main(["--device", "cpu", "--work", str(tmp_path)])
    _check(result, capsys.readouterr().out, "native")


def test_bench_names_the_memory_stand_ins(toy, tmp_path, capsys, monkeypatch):
    def missing():
        return OSError("libtiff.so.6: cannot open shared object file")

    monkeypatch.setattr(memory_io, "native_io_error", missing)
    monkeypatch.setattr(bench, "native_io_error", missing)
    result = bench.main(["--device", "cpu", "--work", str(tmp_path)])
    _check(result, capsys.readouterr().out, "memory stand-ins: libtiff.so.6")
