"""Controls of the numbers that decide ``correct``: what they read when a
lower precision, or a fault, takes the system's place. The benchmark's own
runs never run these.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 [--dalles 2]
    python3 -m benchmark.control --workload <name> --seeds 1,...,12 --program 1.0

prints one JSON line a seed with the cell's numbers for each control, or,
with ``--program <seconds>``, the numbers of the system's own runs (the
cell's whole run with a window that short, every seed in one process: the
lower readings the limits are set from):

* zonal cells: ``fp8``, the plain reference with every product's inputs
  rounded to float8 e4m3 (one step below the configuration's bfloat16)
  writing the labels, checked as the system's labels are;
* training cells: ``tf32``, the reference with TF32 on in cuBLAS and cuDNN
  (one step below the configuration's float32) in the system's place, and
  ``half_batch``, the reference taking the loss over the first half of
  each batch. A step that leaves the state unchanged reads 1 on
  ``update_norm_gap`` by construction (every leaf's change is 0).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from benchmark import context, registry
from benchmark.drivers import train as dtrain
from benchmark.drivers import zonal as dzonal
from benchmark.frozen import raster
from benchmark.reference import precision
from benchmark.reference import zonal as zref


def stitched_labels(model, pixels: np.ndarray, west: float, north: float, res: float,
                    patch: int, margin: int, means, stds, batch: int,
                    device: torch.device) -> np.ndarray:
    """The label raster ``model`` writes for a dalle through the reference's
    own tiling and stitch."""
    bands, height, width = pixels.shape
    inner = patch - 2 * margin
    ts = zref.tiles(height, width, west, north, res, patch, margin)
    padded = zref.normalised_padded(pixels, means, stds, margin, device)
    canvas = torch.zeros((height + inner, width + inner), dtype=torch.uint8, device=device)
    order = zref.stitch_order(ts)
    with torch.no_grad():
        for s in range(0, len(ts), batch):
            chunk = [ts[i] for i in order[s:s + batch]]
            lab = model(zref.tile_batch(padded, chunk, margin, patch))[
                ..., margin:patch - margin, margin:patch - margin].argmax(dim=1)
            for j, t in enumerate(chunk):
                oy = min(max(t.top, 0), canvas.shape[0] - inner)
                ox = min(max(t.left, 0), canvas.shape[1] - inner)
                canvas[oy:oy + inner, ox:ox + inner] = lab[j].to(torch.uint8)
    return canvas[:height, :width].cpu().numpy()


def zonal_control(ctx: context.Context, dalles: int) -> dict:
    """The fp8 reference in the system's place on ``dalles`` dalles of the
    cell's traffic: its ``label_gap`` and the share of its labels that
    differ from the float32 reference's."""
    tr = ctx.traffic
    z = dzonal.zonal_config(ctx, "")
    mod, _ = dzonal.modality_and_task(z)
    cin = dzonal.in_channels(z, mod)
    fam = registry.family(ctx.config["family"])
    pool = raster.pixel_pool(ctx.seed, tr, cin, ctx.device)
    ref = dzonal.reference_model(ctx, fam, cin)
    norm = z["modalities"][mod]["normalization"]
    gaps, differ = [], []
    for index in range(dalles):
        west, north = raster.dalle_origin(index, tr)
        pixels = pool[index % len(pool)]
        with precision.tf32(False), precision.fp8_products(ref):
            labels = stitched_labels(ref, pixels, west, north, tr["res_m"],
                                     z["img_pixels_detection"], z["margin"], norm["means"],
                                     norm["stds"], tr["check_batch"], ctx.device)
        with precision.tf32(False):
            found = zref.label_gaps(ref, pixels, labels, west, north, tr["res_m"],
                                    z["img_pixels_detection"], z["margin"], norm["means"],
                                    norm["stds"], tr["check_batch"], ctx.device)
        gaps.append(found["widest_gap"])
        differ.append(found["differ_share"])
    return {"fp8": {"label_gap": max(gaps), "differ_share": differ}}


def half_batch_loss(logits, onehot, weights):
    half = logits.shape[0] // 2
    from benchmark.reference import train as tref

    return tref.weighted_cross_entropy(logits[:half], onehot[:half], weights)


def train_control(ctx: context.Context, emulate_tf32: bool = False) -> dict:
    """TF32 and the half-batch fault in the system's place, each against
    the float32 reference."""
    tr = ctx.traffic
    cfg = dtrain.train_config(ctx)
    fam = registry.family(ctx.config["family"])
    mod, task = dtrain.modality_and_task(cfg)
    cin = len(cfg["modalities"]["inputs_channels"][mod])
    classes = len(cfg["labels_configs"][task]["value_name"])
    batches = dtrain.batch_pool(ctx, cin, classes, mod, task)
    lr = dtrain.schedule(ctx, cfg)
    n = tr["check_steps"]

    def steps(tf32: bool, loss_fn=None) -> dict:
        with precision.tf32(tf32):
            return dtrain.reference_steps(ctx, cfg, fam, cin, mod, task, batches, lr, n,
                                          loss_fn=loss_fn)

    exact = steps(False)
    if emulate_tf32:
        with precision.tf32_emulated():
            lower = steps(False)
    else:
        lower = steps(True)
    half = steps(False, loss_fn=half_batch_loss)
    keys = ("loss_gap", "grad_norm_gap", "update_norm_gap")
    return {"tf32": {k: v for k, v in dtrain.compare(lower, exact).items() if k in keys},
            "half_batch": {k: v for k, v in dtrain.compare(half, exact).items() if k in keys}}


def program_reading(ctx: context.Context) -> dict:
    """The cell's numbers in one run of the system on ``ctx``'s seed."""
    registry.driver(ctx.traffic["kind"]).run(ctx)
    keys = ("codec_modes", "label_differ_share", "label_run_px")
    return {"program": {c["name"]: c["value"] for c in ctx.checks},
            "units": len(ctx.units), **{k: ctx.info[k] for k in keys if k in ctx.info}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dalles", type=int, default=2)
    ap.add_argument("--program", type=float, default=None,
                    help="read the system's own runs with a window of this many seconds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the controls are read on the card", file=sys.stderr)
        return 2
    bench = registry.load_benchmark()
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = context.make(bench, args.workload, seed, args.program or 0, False,
                           torch.device("cuda", 0))
        kind = ctx.traffic["kind"]
        if args.program is not None:
            out = program_reading(ctx)
        elif kind == "zonal":
            out = zonal_control(ctx, args.dalles)
        else:
            out = train_control(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed, "card": ctx.card, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
