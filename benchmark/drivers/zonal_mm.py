"""Zonal traffic with a Sentinel-2 series: one client segmenting aerial
dalles one after the other with FLAIR-HUB's aerial + Sentinel-2 model, as
the Aigle raster loop does with ``SENTINEL2_TS`` on (up to
``inference_and_write``; polygonising is left out).

The aerial dalles are ``drivers/zonal.py``'s (``frozen/raster.py``). Each
dalle also gets a Sentinel-2 series over its own km and its cloud and snow
mask (``frozen/series.py``), put in the same memory store, and the dates
file ``datesSEN2.txt``, the one file written to the run's work directory.
With a time series the engine takes its host windowed-read route: the
loader reads each tile's aerial window, its series window with the mask,
keeps the dates the mask leaves clear and pads each batch to its largest
date count. A dalle's time, the window and the traced dalles are as in
``drivers/zonal.py``.

Correctness: once the window has closed and the program is freed,
``check_dalles`` dalles drawn from the seed are recomputed by the plain
float32 reference (``reference/utae.py``), in the program's batches (tiles
bottom-up, ``batch_size`` at a time), each tile's dates selected by the
reference from its own mask window and each batch padded to its largest
date count: ``label_gap``, ``unowned_written`` and ``codec_off_share`` as in
``drivers/zonal.py``.
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import json
import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import registry, weights
from benchmark import trace as tracing
from benchmark.context import Context, process_age_s
from benchmark.drivers import zonal as dz
from benchmark.frozen import memory_io, raster, series as fseries
from benchmark.profiling import port_kernel_names, sync, unit_quartiles
from benchmark.reference import precision
from benchmark.reference import utae as uref
from benchmark.reference import zonal as zref


def reader_class(store: memory_io.Store):
    """The benchmark's stored raster, reading a window at the size asked
    for when that is its own size (every read of this traffic's
    geometry)."""
    base = memory_io.reader_class(store)

    class StoredRaster(base):
        def read(self, indexes=None, window=None, out_shape=None, resampling="nearest",
                 boundless=False, fill_value=0):
            if out_shape is not None:
                c0, r0, c1, r1 = (memory_io._window_bounds(window) if window is not None
                                  else (0, 0, self.width, self.height))
                if (r1 - r0, c1 - c0) != tuple(out_shape[-2:]):
                    raise NotImplementedError("the benchmark's rasters are read at their size")
            return super().read(indexes, window, None, resampling, boundless, fill_value)

    return StoredRaster


@contextlib.contextmanager
def installed(store: memory_io.Store):
    """``memory_io.installed`` with this traffic's reader in its place."""
    from flair_for_aigle_tpu_torch.geo import geotiff

    with memory_io.installed(store):
        saved, geotiff.RasterReader = geotiff.RasterReader, reader_class(store)
        try:
            yield store
        finally:
            geotiff.RasterReader = saved


def port_state(ref_state: dict) -> dict:
    """The port's ``FlairHubModel`` state of the reference's: the same
    names (FLAIR-HUB's checkpoint keys), L-TAE's kernel-1 ``Conv1d`` as the
    port's linear layer, no BatchNorm counters."""
    out = {}
    for k, v in ref_state.items():
        if k.endswith("num_batches_tracked"):
            continue
        out[k] = v[..., 0] if k.endswith("temporal_encoder.inconv.weight") else v
    return out


def reference_state(ctx: Context, fam, cin: int) -> dict:
    """``weights.make``'s draw, with the fusion's weights on U-TAE's maps
    scaled by the configuration's ``series_fusion_gain`` (so that the
    series reaches the labels; ``assumed``)."""
    state = weights.make(weights.reference_layout(fam, ctx.config, cin, ctx.device), ctx.seed,
                         ctx.device)
    gain = ctx.config["utae"].get("series_fusion_gain", 1.0)
    for i, st in enumerate(fam.stages(ctx.config, ctx.config["zonal"]["img_pixels_detection"])):
        state[f"fusion_handler.conv_f.{i}.weight"][:, st.c:] *= gain
    return state


def build_model(ctx: Context, z: dict, fam, cin: int):
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
    model.load_state_dict(port_state(reference_state(ctx, fam, cin)), strict=True)
    return model.to(ctx.device).eval()


def reference_model(ctx: Context, fam, cin: int):
    with torch.device(ctx.device):
        ref = fam.build(ctx.config, cin)
    ref.load_state_dict(reference_state(ctx, fam, cin), strict=True)
    return ref.eval()


class Dalles:
    """The loop's per-dalle sequence over the port's zonal engine, each
    dalle with its series and mask."""

    def __init__(self, ctx: Context, z: dict, model, store: memory_io.Store, work: str):
        from flair_for_aigle_tpu_torch.zonal import inference as zi

        self.zi = zi
        self.ctx, self.z, self.model, self.store, self.work = ctx, z, model, store, work
        self.mono, self.series, self.task, _ = registry.family(
            ctx.config["family"]).modalities(ctx.config)
        self.res = ctx.traffic["res_m"]
        self.series_res = ctx.traffic["series"]["res_m"]
        self.patch_sizes = None  # once, from the first raster, as the Aigle loop

    def put(self, index: int, pixels: np.ndarray, series: tuple) -> tuple:
        from flair_for_aigle_tpu_torch.geo.windows import from_origin

        west, north = raster.dalle_origin(index, self.ctx.traffic)
        stem = os.path.join(self.work, f"dalle_{index:05d}_{int(west)}_{int(north)}")
        paths = (stem + ".tif", stem + "_SEN2.tif", stem + "_SEN2_MSK-SC.tif")
        self.store.put(paths[0], pixels, from_origin(west, north, self.res, self.res),
                       "EPSG:2154")
        s2 = from_origin(west, north, self.series_res, self.series_res)
        self.store.put(paths[1], series[0], s2, "EPSG:2154")
        self.store.put(paths[2], series[1], s2, "EPSG:2154")
        return paths, west, north

    def run(self, index: int, pixels: np.ndarray, series: tuple) -> dict:
        """One dalle through the engine; the record of its times and its
        label raster."""
        from flair_for_aigle_tpu_torch.geo.geotiff import open_raster
        from flair_for_aigle_tpu_torch.zonal.dataset import BatchedLoader
        from flair_for_aigle_tpu_torch.zonal.model_utils import compute_patch_sizes
        from flair_for_aigle_tpu_torch.zonal.slicing import generate_patches_from_reference

        zi, z = self.zi, self.z
        paths, west, north = self.put(index, pixels, series)
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.prep"):
            z["modalities"][self.mono]["input_img_path"] = paths[0]
            z["modalities"][self.series]["input_img_path"] = paths[1]
            z["modalities"][self.series]["filter_clouds_img_path"] = paths[2]
            z.pop("image_shape_px", None)
            z = zi.initialize_geometry_and_resolutions(z)
            if self.patch_sizes is None:
                self.patch_sizes = compute_patch_sizes(z)
                zi._set_labels(z)
            tiles = generate_patches_from_reference(z, paths[0], None)
            dataset = zi.prep_dataset(z, tiles, self.patch_sizes)
            loader = BatchedLoader(dataset, batch_size=z["batch_size"],
                                   num_workers=z.get("num_worker", 1))
            ref_img = open_raster(paths[0])
            output_files, out_paths = zi.init_outputs(z, ref_img, index)
        t1 = time.perf_counter()
        with torch.profiler.record_function("bench.inference_and_write"):
            zi.inference_and_write(self.model, loader, tiles, z, output_files, ref_img,
                                   self.ctx.device)
            ref_img.close()
            dataset.close()
        t2 = time.perf_counter()
        for p in paths:
            self.store.drop(p)
        labels = self.store.take(out_paths[self.task])
        return {"start": t0, "end": t2, "prep_s": t1 - t0, "index": index,
                "west": west, "north": north, "tiles": len(tiles),
                "timings": dict(zi.LAST_TIMINGS), "labels": labels[0]}


def run(ctx: Context, fault=None) -> None:
    """The cell's run; ``fault``, a context manager factory taking the
    zonal settings, wraps the program's window and traced dalles (the
    planted faults of ``control_mm.py``)."""
    fam = registry.family(ctx.config["family"])
    store = memory_io.Store()
    work = tempfile.mkdtemp(prefix="bench_zonal_mm_")
    try:
        with installed(store):
            _run(ctx, ctx.traffic, fam, store, work, fault)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def zonal_config(ctx: Context, work: str) -> dict:
    """``drivers/zonal.py``'s settings, the dates file written to ``work``."""
    z = dz.zonal_config(ctx, work)
    _, series, _, _ = registry.family(ctx.config["family"]).modalities(ctx.config)
    path = os.path.join(work, "datesSEN2.txt")
    with open(path, "w") as f:
        f.write("\n".join(fseries.date_strings(ctx.traffic["series"])) + "\n")
    z["modalities"][series]["dates_txt"] = path
    return z


def _run(ctx: Context, tr: dict, fam, store: memory_io.Store, work: str, fault) -> None:
    z = zonal_config(ctx, work)
    mono = fam.modalities(ctx.config)[0]
    cin = dz.in_channels(z, mono)
    side, px, margin = tr["side_px"], z["img_pixels_detection"], z["margin"]
    ages = ctx.info["setup_ages_s"] = {"driver": process_age_s()}
    pool = raster.pixel_pool(ctx.seed, tr, cin, ctx.device)
    spool = fseries.series_pool(ctx.seed, tr, ctx.device)
    ages["pool"] = process_age_s()
    model = build_model(ctx, z, fam, cin)
    ages["model"] = process_age_s()
    loop = Dalles(ctx, z, model, store, work)
    warm = tr["warmup_px"]
    warm_s2 = int(round(warm * tr["res_m"] / tr["series"]["res_m"]))
    with fault(z) if fault else contextlib.nullcontext():
        loop.run(-1, np.ascontiguousarray(pool[0][:, :warm, :warm]),
                 tuple(np.ascontiguousarray(a[:, :warm_s2, :warm_s2]) for a in spool[0]))
        sync(ctx)
        if ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(ctx.device)

        def run_unit(i: int) -> dict:
            return loop.run(i, pool[i % len(pool)], spool[i % len(spool)])

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
            ctx.traced_units, ctx.summary = trace_dalles(ctx, run_unit, tr["trace_dalles"], i)
    if ctx.device.type == "cuda":
        ctx.peak_mem_bytes = torch.cuda.max_memory_allocated(ctx.device)

    tiles = ctx.units[0]["tiles"]
    bsz = z["batch_size"]
    series_px = int(round(px * tr["res_m"] / tr["series"]["res_m"]))
    offsets = uref.day_offsets(fseries.date_strings(tr["series"]),
                               z["multitemp_model_ref_date"])
    kept = kept_per_tile(ctx, spool, px, margin)
    dates = float(np.mean([kept[u["index"] % len(spool)] for u in ctx.units]))
    ctx.per_unit = {"area_km2": (side * tr["res_m"] / 1000.0) ** 2, "tiles": tiles,
                    "batches": math.ceil(tiles / bsz), "batch_size": bsz}
    ctx.flops_per_unit = tiles * fam.forward_flops(ctx.config, px, cin, dates, series_px)
    ctx.precision = "bf16" if z["compute_dtype"] == "bfloat16" else "tf32"
    ctx.elem_bytes = 2 if z["compute_dtype"] == "bfloat16" else 4
    ctx.port_kernels = list(ctx.config["kernels"][tr["kind"]])
    ctx.geo = {"stages": fam.stages(ctx.config, px), "px": px, "margin": margin,
               "classes": ctx.config["num_classes"],
               "mlp_ratio": ctx.config["encoder"].get("mlp_ratio", 4)}
    modes = [str(u["timings"].get("d2h_codec_mode")) for u in ctx.units]
    ctx.info["codec_modes"] = {m: modes.count(m) for m in sorted(set(modes))}
    ctx.add_check("codec_off_share", sum(m != ctx.config["codec_mode"] for m in modes)
                  / len(modes), ctx.limits["codec_off_share"])
    ctx.info["dalles"] = len(ctx.units)
    ctx.info["dalle_s_quartiles"] = unit_quartiles(ctx.units)
    ctx.info["kept_dates_per_tile"] = dates
    frames = [u["timings"].get("series_frames") for u in ctx.units]
    if None not in frames:  # a program with the counter
        ctx.info["series_frames_per_dalle"] = float(np.mean(frames))

    # the check: the program freed, the reference on a sample of the dalles
    del model, loop
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng([ctx.seed % (2 ** 63), 7])
    n = min(tr["check_dalles"], len(ctx.units))
    picks = sorted(int(k) for k in rng.choice(len(ctx.units), size=n, replace=False))
    check_dalles(ctx, z, fam, pool, spool, offsets, [ctx.units[k] for k in picks])


#: the port's spans whose device work the traced dalles report
#: (``info["span_device_ms"]``)
DEVICE_SPANS = ("model.encoder.utae",)


def span_device_us(trace: dict, name: str) -> list[float]:
    """Per occurrence of the host span ``name`` in a Chrome trace: the
    microseconds of the union of the device intervals (kernels, copies,
    sets) launched from its thread while it was open, found through each
    launch's correlation id. The card's time alone: the host's gaps
    between the launches do not count."""
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in evs if e.get("cat") == "user_annotation" and e.get("name") == name]
    launches = sorted((float(e["ts"]), e.get("pid"), e.get("tid"), e["args"]["correlation"])
                      for e in evs if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and "correlation" in e.get("args", {}))
    device: dict = {}
    for e in evs:
        if e.get("cat") in tracing.DEVICE_CATS and "correlation" in e.get("args", {}):
            start = float(e["ts"])
            device.setdefault(e["args"]["correlation"], []).append(
                (start, start + float(e["dur"])))
    at = [launch[0] for launch in launches]
    out = []
    for sp in spans:
        lo = float(sp["ts"])
        hi = lo + float(sp["dur"])
        owned = [iv for _, pid, tid, c in launches[bisect.bisect_left(at, lo):
                                                    bisect.bisect_right(at, hi)]
                 if (pid, tid) == (sp.get("pid"), sp.get("tid")) for iv in device.get(c, ())]
        out.append(sum(e - b for b, e in tracing.merge(owned)))
    return out


def trace_dalles(ctx: Context, run_unit, count: int, start: int) -> tuple[int, object]:
    """``benchmark/profiling.py trace_units``, the trace read besides for
    the device work of ``DEVICE_SPANS``: ``info["span_device_ms"]`` maps
    each span found to [ms, occurrences]."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("bench.traced"):
            for k in range(count):
                run_unit(start + k)
            sync(ctx)
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if ctx.device.type == "cuda":  # a trace of the CPU alone holds no device work
        found = {}
        for name in DEVICE_SPANS:
            us = span_device_us(trace, name)
            if us:
                found[name] = [sum(us) / 1000.0, len(us)]
        ctx.info["span_device_ms"] = found
    return count, tracing.summarize(trace, port_kernel_names(), window="bench.traced")


def kept_per_tile(ctx: Context, spool, px: int, margin: int) -> list:
    """Mean dates a tile keeps, per series pool entry (the reference's own
    selection, on the first dalle's tiles)."""
    tr = ctx.traffic
    west, north = raster.dalle_origin(0, tr)
    windows = uref.series_windows(tr["side_px"], tr["side_px"], west, north, tr["res_m"], px,
                                  margin, tr["series"]["res_m"])
    return [float(np.mean([uref.kept_dates(uref.window(mask, r, c, s).reshape(-1, 2, s, s)).sum()
                           for r, c, s in windows])) for _, mask in spool]


def reference_batches(ctx: Context, pixels: np.ndarray, series: tuple, offsets: np.ndarray,
                      west: float, north: float, means, stds, channels: int):
    """The tiles of a dalle (``reference/zonal.py``'s grid) and, in the
    program's batches (bottom-up, ``batch_size`` at a time), each batch's
    tile indices with the reference's inputs: normalised aerial patches,
    the series each tile keeps by its own mask window padded to the batch's
    largest date count, and the day offsets."""
    tr, z = ctx.traffic, ctx.config["zonal"]
    patch, margin, device = z["img_pixels_detection"], z["margin"], ctx.device
    geometry = (pixels.shape[1], pixels.shape[2], west, north, tr["res_m"], patch, margin)
    ts = zref.tiles(*geometry)
    windows = uref.series_windows(*geometry, tr["series"]["res_m"])
    padded = zref.normalised_padded(pixels, means, stds, margin, device)
    order = zref.stitch_order(ts)

    def batches():
        for s in range(0, len(ts), tr["batch_size"]):
            idx = [int(i) for i in order[s:s + tr["batch_size"]]]
            chunk = [ts[i] for i in idx]
            frames, dates = uref.pad_batch([
                uref.tile_series(series[0], series[1], offsets, *windows[i], channels)
                for i in idx])
            yield idx, (zref.tile_batch(padded, chunk, margin, patch),
                        torch.from_numpy(frames).to(device), torch.from_numpy(dates).to(device))

    return ts, batches()


@torch.no_grad()
def label_gaps(ctx: Context, model, pixels: np.ndarray, series: tuple, offsets: np.ndarray,
               labels: np.ndarray, west: float, north: float, means, stds,
               channels: int) -> dict:
    """``reference/zonal.py label_gaps`` with the series, the reference run
    on ``reference_batches``."""
    z, device = ctx.config["zonal"], ctx.device
    patch, margin = z["img_pixels_detection"], z["margin"]
    height, width = pixels.shape[1:]
    inner = patch - 2 * margin
    ts, batches = reference_batches(ctx, pixels, series, offsets, west, north, means, stds,
                                    channels)
    own = torch.from_numpy(zref.owners(ts, height, width, inner)).to(device)
    lab = torch.from_numpy(np.ascontiguousarray(labels)).to(device).long()
    widest = torch.zeros((), device=device)
    differ = torch.zeros((), dtype=torch.long, device=device)
    checked = 0
    for idx, inputs in batches:
        logits = model(*inputs)[..., margin:patch - margin, margin:patch - margin]
        for j, i in enumerate(idx):
            t = ts[i]
            oy, ox = min(max(t.top, 0), height), min(max(t.left, 0), width)
            h, w = min(inner, height - oy), min(inner, width - ox)
            if h <= 0 or w <= 0:
                continue
            mask = own[oy:oy + h, ox:ox + w] == i
            lg = logits[j, :, :h, :w]
            written = lab[oy:oy + h, ox:ox + w]
            best = lg.max(dim=0).values
            got = lg.gather(0, written[None].clamp(0, lg.shape[0] - 1))[0]
            gap = torch.where(written >= lg.shape[0], torch.full_like(best, float("inf")),
                              best - got)
            widest = torch.maximum(widest, torch.where(mask, gap, 0.0).max())
            differ += (mask & (lg.argmax(dim=0) != written)).sum()
            checked += int(mask.sum())
    unowned_written = int(((own < 0) & (lab != 0)).sum())
    return {"widest_gap": float(widest), "differ_share": float(differ) / max(checked, 1),
            "unowned_written": unowned_written, "tiles": len(ts)}


def check_dalles(ctx: Context, z: dict, fam, pool, spool, offsets, records: list) -> None:
    t0 = time.perf_counter()
    mono, _, _, channels = fam.modalities(ctx.config)
    ref = reference_model(ctx, fam, dz.in_channels(z, mono))
    norm = z["modalities"][mono]["normalization"]
    with precision.tf32(False):
        found = [label_gaps(ctx, ref, pool[r["index"] % len(pool)],
                            spool[r["index"] % len(spool)], offsets, r["labels"], r["west"],
                            r["north"], norm["means"], norm["stds"], channels)
                 for r in records]
    ctx.add_check("label_gap", max(f["widest_gap"] for f in found), ctx.limits["label_gap"])
    ctx.add_check("unowned_written", max(f["unowned_written"] for f in found),
                  ctx.limits["unowned_written"])
    ctx.info["checked_dalles"] = [r["index"] for r in records]
    ctx.info["label_differ_share"] = [f["differ_share"] for f in found]
    ctx.info["label_run_px"] = [dz.run_px(r["labels"]) for r in records]
    ctx.info["check_s"] = time.perf_counter() - t0
