"""Benchmark: km²/h of 20 cm VHR zonal inference on one CUDA card, through
the port's zonal engine.

    python -m flair_for_aigle_tpu_torch.bench [--device cuda|cpu]

End to end, as the JAX package's ``bench.py`` measures it: read -> tile ->
normalise -> forward -> epilogue -> stitch -> D2H -> write of 1 km² of
synthetic 20 cm imagery (a 5000 x 5000 3-band uint8 raster) with
swin_base_patch4_window12_384-upernet (512 px patches, 40 px margin, the
reference zonal defaults; batch 16), bf16 with ``attn_f32: False`` and
device normalisation, random weights from a seeded generator (throughput
does not depend on the weights). A warm-up raster of 2 x 512 px builds the
model and warms the kernels first; then the best of at least 5 and at most
12 timed runs, stopping once 5 are done and 150 s have passed.

Prints one JSON line: ``metric``, ``value`` (km²/h), ``unit``,
``vs_baseline`` (against the 900 km²/h A100 estimate derived in
BASELINE.md) and ``detail``: the runs' seconds, the tile geometry, the
best run's phase timings (``zonal/stripes.py LAST_TIMINGS``), the card's
name and power limit, and ``io``: ``"native"`` where libtiff and GEOS load,
else ``"memory stand-ins: <why>"`` (``zonal/memory_io.py``: an in-memory
raster reader and writer; the device path is the same). Runs on the card
and raises without one; ``--device cpu`` runs the plain versions (tests).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import time

import numpy as np
import torch

from flair_for_aigle_tpu_torch.device import resolve_device
from flair_for_aigle_tpu_torch.geo.geotiff import open_raster
from flair_for_aigle_tpu_torch.geo.windows import from_origin
from flair_for_aigle_tpu_torch.zonal import inference as zi
from flair_for_aigle_tpu_torch.zonal.dataset import BatchedLoader
from flair_for_aigle_tpu_torch.zonal.memory_io import host_io, native_io_error
from flair_for_aigle_tpu_torch.zonal.model_utils import (
    build_inference_model,
    compute_patch_sizes,
)
from flair_for_aigle_tpu_torch.zonal.slicing import generate_patches_from_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC = "km2_per_hour_zonal_20cm_vhr_per_chip"
A100_BASELINE_KM2_PER_H = 900.0  # derived in BASELINE.md (not a measurement)

PATCH = 512
MARGIN = 40
BATCH = 16
RES = 0.2  # m/px
KM2_SIDE_PX = 5000  # 1 km at 0.2 m/px
N_CLASSES = 19
ARCH = "swin_base_patch4_window12_384-upernet"
MIN_RUNS, MAX_RUNS, BUDGET_S = 5, 12, 150.0


def make_raster(path: str, side: int, write_geotiff, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 255, (3, side, side), dtype=np.int64).astype(np.uint8)
    write_geotiff(path, arr, from_origin(700000.0, 6600000.0, RES, RES), "EPSG:2154",
                  compress="lzw", tile_size=512)


def make_cfg(img_path: str, out_dir: str) -> dict:
    return {
        "output_path": out_dir,
        "output_name": "bench_zonal",
        "write_dataframe": False,
        "output_type": "argmax",
        "cog_conversion": False,
        "model_weights": "",
        "batch_size": BATCH,
        "num_worker": 4,
        "img_pixels_detection": PATCH,
        "margin": MARGIN,
        "output_px_meters": RES,
        "compute_dtype": "bfloat16",
        "attn_f32": False,
        "normalize_on_device": True,
        "emit_label_placeholders": False,
        "preload_rasters": "auto",
        "monotemp_arch": ARCH,
        "multitemp_model_ref_date": "05-15",
        "modalities": {
            "inputs": {"AERIAL_RGBI": True, "AERIAL-RLT_PAN": False,
                       "DEM_ELEV": False, "SPOT_RGBI": False,
                       "SENTINEL2_TS": False, "SENTINEL1-ASC_TS": False,
                       "SENTINEL1-DESC_TS": False},
            "AERIAL_RGBI": {
                "input_img_path": img_path,
                "channels": [1, 2, 3],
                "normalization": {"type": "custom",
                                  "means": [105.66, 111.35, 102.18],
                                  "stds": [52.23, 45.62, 44.30]},
            },
        },
        "tasks": [{"name": "AERIAL_LABEL-COSIA", "active": True,
                   "class_names": {i: f"c{i}" for i in range(N_CLASSES)}}],
    }


def run_zonal(cfg: dict, device: torch.device, model=None, devices=None):
    """One zonal pass (geometry, tiling, dataset, inference, stitch, write)
    at the config's ``batch_size`` (the bench's BATCH where it has none)
    with a prebuilt model, built here on the first call; ``devices``, a
    data-parallel mesh for ``inference_and_write`` (the bench itself runs
    on one card). Returns (model, tiles, {task: label raster path})."""
    cfg = zi.initialize_geometry_and_resolutions(dict(cfg))
    cfg["output_type"] = cfg.get("output_type", "argmax")
    zi._set_labels(cfg)
    tiles = generate_patches_from_reference(cfg)
    patch_sizes = compute_patch_sizes(cfg)
    if model is None:
        model, _ = build_inference_model(cfg, device=device, seed=0)
    dataset = zi.prep_dataset(cfg, tiles, patch_sizes)
    loader = BatchedLoader(dataset, batch_size=cfg.get("batch_size", BATCH),
                           num_workers=cfg.get("num_worker", 1))
    ref_img = open_raster(cfg["modalities"][cfg["reference_modality"]]["input_img_path"])
    output_files, paths = zi.init_outputs(cfg, ref_img)
    zi.inference_and_write(model, loader, tiles, cfg, output_files, ref_img, device, devices)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ref_img.close()
    dataset.close()
    return model, len(tiles), paths


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def measure(device: torch.device, work: str, write_geotiff, before_timed=None):
    """The benchmark under the current host IO (``write_geotiff`` writes
    its rasters): warm-up, then the timed runs, ``before_timed()`` called
    just before the first. Returns (result line as a dict, label raster
    path of the last run)."""
    out_dir = os.path.join(work, "out")
    os.makedirs(out_dir, exist_ok=True)
    warm_path, big_path = os.path.join(work, "warmup.tif"), os.path.join(work, "km2.tif")
    make_raster(warm_path, 2 * PATCH, write_geotiff)
    make_raster(big_path, KM2_SIDE_PX, write_geotiff)
    model, _, _ = run_zonal(make_cfg(warm_path, out_dir), device)
    if before_timed is not None:
        before_timed()
    runs, phases = [], []
    deadline = time.time() + BUDGET_S
    for _ in range(MAX_RUNS):
        t0 = time.perf_counter()
        _, n_tiles, paths = run_zonal(make_cfg(big_path, out_dir), device, model)
        runs.append(time.perf_counter() - t0)
        phases.append(dict(zi.LAST_TIMINGS))
        if len(runs) >= MIN_RUNS and time.time() > deadline:
            break
    best = int(np.argmin(runs))
    km2 = (KM2_SIDE_PX * RES / 1000.0) ** 2
    km2_per_hour = km2 / (runs[best] / 3600.0)
    err = native_io_error()
    result = {
        "metric": METRIC,
        "value": km2_per_hour,
        "unit": "km2/h",
        "vs_baseline": km2_per_hour / A100_BASELINE_KM2_PER_H,
        "detail": {
            "elapsed_s": runs[best],
            "all_runs_s": runs,
            "tiles": n_tiles,
            "tiles_per_s": n_tiles / runs[best],
            "patch": PATCH, "margin": MARGIN, "batch": BATCH, "arch": ARCH,
            "best_run_phases": phases[best],
            "card": card(device),
            "io": "native" if err is None else f"memory stand-ins: {err}",
        },
    }
    return result, paths["AERIAL_LABEL-COSIA"]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="km2/h of zonal inference on one card")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Run on the CUDA card (default) or on the CPU")
    parser.add_argument("--work", default=os.path.join(REPO, ".tmp", "bench"),
                        help="Folder of the synthetic rasters and the outputs")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.WARNING)
    with host_io() as (write_geotiff, _):
        result, _ = measure(device, args.work, write_geotiff)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
