"""Controls of the numbers that decide ``correct`` in the aerial +
Sentinel-2 cell (traffic kind ``zonal_mm``): what they read when a lower
precision, or a fault in the series route, takes the system's place. The
benchmark's own runs never run these.

    python3 -m benchmark.control_mm --workload zonal-mm-swinb-utae --seeds 1,2 \\
        [--controls fp8,pad_mask,positional,clouds,other_dates] [--seconds 3] [--dalles 2]

prints one JSON line a seed and control with the cell's checks:

* ``fp8``: the plain reference with every product's inputs rounded to
  float8 e4m3 (one step below the configuration's bfloat16) writes the
  labels through the reference's own tiles and batches, checked as the
  system's labels are;
* the planted faults, each a whole run of the cell (a window of
  ``--seconds``) with the port broken underneath: ``pad_mask``, L-TAE
  attending to the frames that pad a batch; ``positional``, L-TAE without
  its day-offset encoding; ``clouds``, the cloud and snow filter off (every
  date kept); ``other_dates``, each tile keeping the dates another tile's
  mask window keeps (the tile half a dalle east);

and ``sound``, the same run with nothing planted.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch
from torch import nn

from benchmark import context, registry
from benchmark.drivers import zonal as dz
from benchmark.drivers import zonal_mm as dmm
from benchmark.frozen import raster, series as fseries
from benchmark.reference import precision
from benchmark.reference import utae as uref


@contextlib.contextmanager
def _ltae_called_with(**over):
    from flair_for_aigle_tpu_torch.models import utae

    forward = utae.LTAE2d.forward

    def broken(self, x, batch_positions=None, pad_mask=None, generator=None):
        kw = {"batch_positions": batch_positions, "pad_mask": pad_mask, **over}
        return forward(self, x, generator=generator, **kw)

    utae.LTAE2d.forward = broken
    try:
        yield
    finally:
        utae.LTAE2d.forward = forward


def pad_mask(z: dict):
    return _ltae_called_with(pad_mask=None)


def positional(z: dict):
    return _ltae_called_with(batch_positions=None)


@contextlib.contextmanager
def clouds(z: dict):
    series = next(m for m, on in z["modalities"]["inputs"].items() if on and m.endswith("_TS"))
    z["modalities"][series]["filter_clouds"] = False
    try:
        yield
    finally:
        z["modalities"][series]["filter_clouds"] = True


@contextlib.contextmanager
def other_dates(z: dict):
    from flair_for_aigle_tpu_torch.geo.windows import Window
    from flair_for_aigle_tpu_torch.zonal.dataset import MultiModalSlicedDataset

    process = MultiModalSlicedDataset._process_time_series_patch

    def broken(self, mod_name, patch, window, cfg):
        width = self.readers[mod_name].width
        col = window.col_off + width // 2
        if col + window.width > width:
            col -= width
        return process(self, mod_name, patch,
                       Window(col, window.row_off, window.width, window.height), cfg)

    MultiModalSlicedDataset._process_time_series_patch = broken
    try:
        yield
    finally:
        MultiModalSlicedDataset._process_time_series_patch = process


FAULTS = {"pad_mask": pad_mask, "positional": positional, "clouds": clouds,
          "other_dates": other_dates}


@contextlib.contextmanager
def fp8_products(model: nn.Module):
    """``reference/precision.py fp8_products`` over every product of the
    fused model: linear layers and 1-d, 2-d and transposed convolutions."""
    saved, hooks = {}, []
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)):
            saved[mod] = mod.weight.data
            mod.weight.data = precision.fp8(mod.weight.data)
            hooks.append(mod.register_forward_pre_hook(
                lambda _m, args: (precision.fp8(args[0]),) + tuple(args[1:])))
    try:
        yield model
    finally:
        for h in hooks:
            h.remove()
        for mod, w in saved.items():
            mod.weight.data = w


@torch.no_grad()
def stitched_labels(ctx: context.Context, model, pixels, series, offsets, west, north,
                    means, stds, channels) -> np.ndarray:
    """The label raster ``model`` writes for a dalle through the reference's
    own tiles, batches and stitch."""
    z = ctx.config["zonal"]
    patch, margin = z["img_pixels_detection"], z["margin"]
    height, width = pixels.shape[1:]
    inner = patch - 2 * margin
    ts, batches = dmm.reference_batches(ctx, pixels, series, offsets, west, north, means,
                                        stds, channels)
    canvas = torch.zeros((height + inner, width + inner), dtype=torch.uint8,
                         device=ctx.device)
    for idx, inputs in batches:
        lab = model(*inputs)[..., margin:patch - margin, margin:patch - margin].argmax(dim=1)
        for j, i in enumerate(idx):
            oy = min(max(ts[i].top, 0), canvas.shape[0] - inner)
            ox = min(max(ts[i].left, 0), canvas.shape[1] - inner)
            canvas[oy:oy + inner, ox:ox + inner] = lab[j].to(torch.uint8)
    return canvas[:height, :width].cpu().numpy()


def fp8_control(ctx: context.Context, dalles: int) -> dict:
    """The float8 reference in the system's place on ``dalles`` dalles of
    the cell's traffic: its ``label_gap`` and the share of its labels that
    differ from the float32 reference's."""
    tr = ctx.traffic
    fam = registry.family(ctx.config["family"])
    mono, _, _, channels = fam.modalities(ctx.config)
    z = ctx.config["zonal"]
    cin = dz.in_channels(z, mono)
    pool = raster.pixel_pool(ctx.seed, tr, cin, ctx.device)
    spool = fseries.series_pool(ctx.seed, tr, ctx.device)
    offsets = uref.day_offsets(fseries.date_strings(tr["series"]), z["multitemp_model_ref_date"])
    ref = dmm.reference_model(ctx, fam, cin)
    norm = z["modalities"][mono]["normalization"]
    gaps, differ = [], []
    for index in range(dalles):
        west, north = raster.dalle_origin(index, tr)
        args = (pool[index % len(pool)], spool[index % len(spool)], offsets)
        with precision.tf32(False), fp8_products(ref):
            labels = stitched_labels(ctx, ref, *args, west, north, norm["means"], norm["stds"],
                                     channels)
        with precision.tf32(False):
            found = dmm.label_gaps(ctx, ref, *args, labels, west, north, norm["means"],
                                   norm["stds"], channels)
        gaps.append(found["widest_gap"])
        differ.append(found["differ_share"])
    return {"label_gap": max(gaps), "differ_share": differ}


def fault_run(ctx: context.Context, name: str) -> dict:
    """The cell's whole run with the fault ``name`` planted (``sound``:
    none): its checks."""
    dmm.run(ctx, fault=FAULTS.get(name))
    out = context.result(ctx)
    return {"checks": {k: v["value"] for k, v in out["checks"].items()},
            "correct": out["correct"], "dalles": out["attempted"],
            "differ_share": ctx.info.get("label_differ_share")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="zonal-mm-swinb-utae")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default=",".join(["fp8", *FAULTS]))
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--dalles", type=int, default=2)
    ap.add_argument("--gain", type=float, default=None,
                    help="another series_fusion_gain than the configuration's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the controls are read on the card", file=sys.stderr)
        return 2
    bench = registry.load_benchmark()
    for seed in (int(s) for s in args.seeds.split(",")):
        for name in args.controls.split(","):
            ctx = context.make(bench, args.workload, seed, args.seconds, False,
                               torch.device("cuda", 0))
            if args.gain is not None:
                ctx.config["utae"] = dict(ctx.config["utae"], series_fusion_gain=args.gain)
            out = fp8_control(ctx, args.dalles) if name == "fp8" else fault_run(ctx, name)
            print(json.dumps({"workload": args.workload, "seed": seed, "control": name,
                              "gain": ctx.config["utae"].get("series_fusion_gain", 1.0),
                              "card": ctx.card, **out}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
