"""Zonal traffic: one client segmenting aerial dalles one after the other,
as the Aigle raster loop does (``aigle/run_fast_aigle_segmentation.py``,
up to ``inference_and_write``; polygonising is left out).

Each dalle is a ``side_px`` x ``side_px`` raster of 3-band uint8 pixels at
``res_m`` metres a pixel, with its own path and its own Lambert-93 corner
on a department's km grid; its pixels are one array of a pool made from the
seed in set-up: fields, plots and their texture (``frozen/raster.py``). A dalle's time runs from the start of its host set-up
(geometry, slicing, dataset, output writers) to its label raster written.
The window runs dalles until ``--seconds`` have passed and ends when the
last one started is written. With ``--trace 1`` a further
``trace_dalles`` dalles run under ``torch.profiler``.

Correctness: once the window has closed and the program is freed,
``check_dalles`` dalles drawn from the seed among those written are
compared with the plain float32 reference on their pixels: the widest gap
by which a written label's reference logit lies below the reference's best
(``reference/zonal.py``); and the dalles of the window have to have sent
their labels through the stripe codec that the configuration expects on
this label structure (``codec_mode``): the share of them that committed to
another may not pass its limit.
"""

from __future__ import annotations

import copy
import gc
import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import registry, weights
from benchmark.context import Context, process_age_s
from benchmark.profiling import sync, trace_units, unit_quartiles
from benchmark.frozen import memory_io, raster
from benchmark.reference import precision
from benchmark.reference import zonal as zref


def zonal_config(ctx: Context, work: str) -> dict:
    z = copy.deepcopy(ctx.config["zonal"])
    z["batch_size"] = ctx.traffic["batch_size"]
    z["output_path"] = work
    z["output_name"] = ctx.config["name"]
    z["monotemp_arch"] = ctx.config["arch"]
    z["model_weights"] = ""
    return z


def modality_and_task(z: dict) -> tuple[str, str]:
    mods = [m for m, on in z["modalities"]["inputs"].items() if on]
    tasks = [t["name"] for t in z["tasks"] if t["active"]]
    if len(mods) != 1 or len(tasks) != 1:
        raise ValueError("the zonal driver runs one modality and one task")
    return mods[0], tasks[0]


def in_channels(z: dict, mod: str) -> int:
    return len(z["modalities"][mod]["channels"])


def reference_state(ctx: Context, fam, cin: int) -> dict:
    spec = weights.reference_layout(fam, ctx.config, cin, ctx.device)
    return weights.make(spec, ctx.seed, ctx.device)


def build_model(ctx: Context, z: dict, fam, mod: str, task: str):
    from flair_for_aigle_tpu_torch.models.flair_model import FlairHubModel
    from flair_for_aigle_tpu_torch.zonal.model_utils import (
        prepare_model_config,
        use_stride4_epilogue,
    )

    mc = prepare_model_config(z)
    if use_stride4_epilogue(z, ctx.device):
        mc["zonal_stride4_logits"] = True
    with torch.device(ctx.device):
        model = FlairHubModel(mc)
    state = reference_state(ctx, fam, in_channels(z, mod))
    model.load_state_dict(weights.port_state(state, mod, task), strict=True)
    return model.to(ctx.device).eval()


class Dalles:
    """The loop's per-dalle sequence over the port's zonal engine."""

    def __init__(self, ctx: Context, z: dict, model, store: memory_io.Store, pool, work: str):
        from flair_for_aigle_tpu_torch.zonal import inference as zi

        self.zi = zi
        self.ctx, self.z, self.model, self.store, self.pool = ctx, z, model, store, pool
        self.work = work
        self.mod, self.task = modality_and_task(z)
        self.res = ctx.traffic["res_m"]
        self.patch_sizes = None  # once, from the first raster, as the Aigle loop

    def put(self, index: int, pixels: np.ndarray) -> tuple[str, float, float]:
        from flair_for_aigle_tpu_torch.geo.windows import from_origin

        west, north = raster.dalle_origin(index, self.ctx.traffic)
        path = os.path.join(self.work, f"dalle_{index:05d}_{int(west)}_{int(north)}.tif")
        self.store.put(path, pixels, from_origin(west, north, self.res, self.res), "EPSG:2154")
        return path, west, north

    def run(self, index: int, pixels: np.ndarray) -> dict:
        """One dalle through the engine; the record of its times and its
        label raster."""
        from flair_for_aigle_tpu_torch.geo.geotiff import open_raster
        from flair_for_aigle_tpu_torch.zonal.dataset import BatchedLoader
        from flair_for_aigle_tpu_torch.zonal.model_utils import compute_patch_sizes
        from flair_for_aigle_tpu_torch.zonal.slicing import generate_patches_from_reference

        zi, z = self.zi, self.z
        path, west, north = self.put(index, pixels)
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.prep"):
            z["modalities"][self.mod]["input_img_path"] = path
            z.pop("image_shape_px", None)
            z = zi.initialize_geometry_and_resolutions(z)
            if self.patch_sizes is None:
                self.patch_sizes = compute_patch_sizes(z)
                zi._set_labels(z)
            tiles = generate_patches_from_reference(z, path, None)
            dataset = zi.prep_dataset(z, tiles, self.patch_sizes)
            loader = BatchedLoader(dataset, batch_size=z["batch_size"],
                                   num_workers=z.get("num_worker", 1))
            ref_img = open_raster(path)
            output_files, out_paths = zi.init_outputs(z, ref_img, index)
        t1 = time.perf_counter()
        with torch.profiler.record_function("bench.inference_and_write"):
            zi.inference_and_write(self.model, loader, tiles, z, output_files, ref_img,
                                   self.ctx.device)
            ref_img.close()
            dataset.close()
        t2 = time.perf_counter()
        self.store.drop(path)
        labels = self.store.take(out_paths[self.task])
        return {"start": t0, "end": t2, "prep_s": t1 - t0, "index": index,
                "west": west, "north": north, "tiles": len(tiles),
                "timings": dict(zi.LAST_TIMINGS), "labels": labels[0]}


def run(ctx: Context) -> None:
    tr = ctx.traffic
    fam = registry.family(ctx.config["family"])
    store = memory_io.Store()
    work = tempfile.mkdtemp(prefix="bench_zonal_")  # a name only: nothing lands there
    try:
        with memory_io.installed(store):
            _run(ctx, tr, fam, store, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(ctx: Context, tr: dict, fam, store: memory_io.Store, work: str) -> None:
    z = zonal_config(ctx, work)
    mod, task = modality_and_task(z)
    cin = in_channels(z, mod)
    side, px, margin = tr["side_px"], z["img_pixels_detection"], z["margin"]
    ages = ctx.info["setup_ages_s"] = {"driver": process_age_s()}
    pool = raster.pixel_pool(ctx.seed, tr, cin, ctx.device)
    ages["pool"] = process_age_s()
    model = build_model(ctx, z, fam, mod, task)
    ages["model"] = process_age_s()
    loop = Dalles(ctx, z, model, store, pool, work)
    warm = tr["warmup_px"]
    loop.run(-1, np.ascontiguousarray(pool[0][:, :warm, :warm]))
    sync(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)

    def run_unit(i: int) -> dict:
        return loop.run(i, pool[i % len(pool)])

    gc.collect()
    gc.freeze()  # set-up's objects are not scanned again in the window
    t_w0 = time.perf_counter()
    ctx.setup_s = process_age_s()
    i = 0
    while True:
        ctx.units.append(run_unit(i))
        i += 1
        if time.perf_counter() - t_w0 >= ctx.seconds:
            break
    ctx.window_s = ctx.units[-1]["end"] - t_w0
    if ctx.trace:
        ctx.traced_units, ctx.summary = trace_units(ctx, run_unit, tr["trace_dalles"], i)
    if ctx.device.type == "cuda":
        ctx.peak_mem_bytes = torch.cuda.max_memory_allocated(ctx.device)

    tiles = ctx.units[0]["tiles"]
    bsz = z["batch_size"]
    ctx.per_unit = {"area_km2": (side * tr["res_m"] / 1000.0) ** 2, "tiles": tiles,
                    "batches": math.ceil(tiles / bsz), "batch_size": bsz}
    ctx.flops_per_unit = tiles * fam.forward_flops(ctx.config, px, cin)
    ctx.precision = "bf16" if z["compute_dtype"] == "bfloat16" else "tf32"
    ctx.elem_bytes = 2 if z["compute_dtype"] == "bfloat16" else 4
    ctx.port_kernels = list(ctx.config["kernels"]["zonal"])
    ctx.geo = {"stages": fam.stages(ctx.config, px), "px": px, "margin": margin,
               "classes": ctx.config["num_classes"],
               "mlp_ratio": ctx.config["encoder"].get("mlp_ratio", 4)}
    modes = [str(u["timings"].get("d2h_codec_mode")) for u in ctx.units]
    ctx.info["codec_modes"] = {m: modes.count(m) for m in sorted(set(modes))}
    ctx.add_check("codec_off_share", sum(m != ctx.config["codec_mode"] for m in modes)
                  / len(modes), ctx.limits["codec_off_share"])
    ctx.info["dalles"] = len(ctx.units)
    ctx.info["dalle_s_quartiles"] = unit_quartiles(ctx.units)

    # the check: the program freed, the reference on a sample of the dalles
    del model, loop
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng([ctx.seed % (2 ** 63), 7])
    n = min(tr["check_dalles"], len(ctx.units))
    picks = sorted(int(k) for k in rng.choice(len(ctx.units), size=n, replace=False))
    check_dalles(ctx, z, fam, mod, pool, [ctx.units[k] for k in picks])


def reference_model(ctx: Context, fam, cin: int):
    with torch.device(ctx.device):
        ref = fam.build(ctx.config, cin)
    ref.load_state_dict(weights.make(weights.layout(ref), ctx.seed, ctx.device), strict=True)
    return ref.eval()


def gaps_of(ctx: Context, z: dict, ref, mod: str, pool, record: dict) -> dict:
    norm = z["modalities"][mod]["normalization"]
    return zref.label_gaps(ref, pool[record["index"] % len(pool)], record["labels"],
                           record["west"], record["north"], ctx.traffic["res_m"],
                           z["img_pixels_detection"], z["margin"], norm["means"],
                           norm["stds"], ctx.traffic["check_batch"], ctx.device)


def run_px(labels: np.ndarray) -> float:
    """Mean length of the runs of a label raster read row-major, as the
    stripe codec's run-length coding splits it."""
    flat = labels.reshape(-1)
    return flat.size / (1 + int(np.count_nonzero(flat[1:] != flat[:-1])))


def check_dalles(ctx: Context, z: dict, fam, mod: str, pool, records: list) -> None:
    t0 = time.perf_counter()
    ref = reference_model(ctx, fam, in_channels(z, mod))
    with precision.tf32(False):
        found = [gaps_of(ctx, z, ref, mod, pool, r) for r in records]
    ctx.add_check("label_gap", max(f["widest_gap"] for f in found), ctx.limits["label_gap"])
    ctx.add_check("unowned_written", max(f["unowned_written"] for f in found),
                  ctx.limits["unowned_written"])
    ctx.info["checked_dalles"] = [r["index"] for r in records]
    ctx.info["label_differ_share"] = [f["differ_share"] for f in found]
    ctx.info["label_run_px"] = [run_px(r["labels"]) for r in records]
    ctx.info["check_s"] = time.perf_counter() - t0
