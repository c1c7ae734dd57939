#!/usr/bin/env python3
"""Smoke run of the PyTorch port (flair_for_aigle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one printed line each (any failure raises and exits non-zero):

1. environment: the card (name and power limit from nvidia-smi), TF32 off;
2. build: compile the CUDA kernels under flair_for_aigle_tpu_torch/csrc/;
3. kernels: each kernel against its plain PyTorch version on the card at
   the swin-base@512 shapes of the zonal main path (batch 2), max and median
   error against the stated bound, kernel and plain times (CUDA events,
   median of 20);
4. slice: the port's zonal ``run_inference`` on a synthetic, spatially
   correlated 2048 x 2048 3-band uint8 raster at 0.2 m/px (25 tiles of
   512 px, margin 40, batch 16,
   bf16, attn_f32 False, device normalisation, random seeded weights):
   output geometry, labels < 19, every kernel's launch count during the run,
   argmax agreement of one batch with a forward built from the plain
   versions (float32 and bf16), and the warm wall time, tiles/s and km2/h.

The line before the last is the per-kernel JSON summary, the last line
``{"ok": true, "device": {...}}``. Needs one card, the CUDA toolkit (nvcc)
and the repository checkout; exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TMP = os.path.join(REPO, ".tmp", "chip_smoke")

# swin-base@512 stage geometries: (H = W, C, heads); window 12, shift 6
STAGES = [(128, 128, 4), (64, 256, 8), (32, 512, 16), (16, 1024, 32)]
WS, SS = 12, 6
N_CLASSES = 19
RES = 0.2
SIDE = 2048
BATCH = 16

KERNELS = {
    # name -> (source, TPU kernel it replaces)
    "prep": ("flair_for_aigle_tpu_torch/csrc/prep.cu",
             "flair_for_aigle_tpu/ops/pallas/prep.py:40"),
    "window_attn": ("flair_for_aigle_tpu_torch/csrc/window_attn.cu",
                    "flair_for_aigle_tpu/ops/pallas/window_attn.py:290"),
    "ffn": ("flair_for_aigle_tpu_torch/csrc/ffn.cu",
            "flair_for_aigle_tpu/ops/pallas/ffn.py:152"),
    "epilogue": ("flair_for_aigle_tpu_torch/csrc/epilogue.cu",
                 "flair_for_aigle_tpu/ops/pallas/epilogue.py:119"),
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median device time of fn() in ms (CUDA events around each call)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_env() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # the plain versions stand for the reference's float32-accumulated
    # products: no TF32, no reduced-precision bf16 split-K reductions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    say("env", f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    return {"card": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from flair_for_aigle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    say("build", f"{os.path.relpath(path, REPO)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.LAST_BUILD_SECONDS:.1f} s)")


def _compare(name, case, got, want, bound, t_k, t_p, stats):
    import torch

    err = (got.float() - want.float()).abs()
    mx, med = err.max().item(), err.median().item()
    ok = mx <= bound
    say("kernel", f"{name} {case}: max_abs_err {mx:.3e} median {med:.3e} "
        f"bound {bound:.3e} {'ok' if ok else 'FAIL'}; kernel {t_k:.4f} ms, "
        f"plain {t_p:.4f} ms")
    s = stats.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
    s["max_abs_err"] = max(s["max_abs_err"], mx)
    if not ok:
        raise AssertionError(f"{name} {case}: max_abs_err {mx} > bound {bound}")
    torch.cuda.synchronize()


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns per-kernel stats
    (main-path times: bf16 cases summed over the four stages)."""
    import torch

    from flair_for_aigle_tpu_torch.ops import epilogue, ffn, prep, window_attn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    stats: dict = {}

    def randn(*shape, dtype=bf, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    def bound(ref, dtype, bf16_ulps, f32_rel):
        # bf16: a few units in the last place at the reference's largest
        # magnitude (sums run in another order, so single roundings flip);
        # float32: a relative bound at that magnitude
        scale = max(1.0, ref.float().abs().max().item())
        return (bf16_ulps * 2.0 ** -7 if dtype == bf else f32_rel) * scale

    for (hw, c, nh) in STAGES:
        geom = f"B2 {hw}x{hw}x{c}"
        for dtype in ([bf, f32] if hw == 128 else [bf]):
            tag = f"{geom} {'bf16' if dtype == bf else 'f32'}"
            # K1: LN + shift + pad + partition
            x = randn(2, hw, hw, c, dtype=dtype)
            s, b = randn(c, dtype=f32) * 0.1 + 1, randn(c, dtype=f32) * 0.1
            kw = dict(ws=WS, ss=SS)
            got = prep.fused_ln_shift_partition(x, s, b, **kw)
            want = prep.fused_ln_shift_partition_reference(x, s, b, **kw)
            t_k = cuda_ms(lambda: prep.fused_ln_shift_partition(x, s, b, **kw))
            t_p = cuda_ms(lambda: prep.fused_ln_shift_partition_reference(x, s, b, **kw))
            _compare("prep", tag, got, want, bound(want, dtype, 1, 1e-5), t_k, t_p, stats)
            if dtype == bf:
                stats["prep"]["ms"] += t_k
                stats["prep"]["plain_ms"] += t_p

            # K2: window attention, both softmax modes
            hp = hw + (WS - hw % WS) % WS
            nwh = hp // WS
            win = prep.fused_ln_shift_partition(x, s, b, **kw)
            bound_c = c ** -0.5
            params = (randn(3 * c, c, dtype=f32, std=bound_c), randn(3 * c, dtype=f32, std=0.02),
                      randn(c, c, dtype=f32, std=bound_c), randn(c, dtype=f32, std=0.02),
                      randn(nh, WS * WS, WS * WS, dtype=f32, std=0.02))
            for attn_f32 in (True, False):
                akw = dict(num_heads=nh, window_size=WS, shift_size=SS,
                           grid_hw=(nwh, nwh), attn_f32=attn_f32)
                got = window_attn.fused_window_attention(win, *params, **akw)
                want = window_attn.fused_window_attention_reference(win, *params, **akw)
                t_k = cuda_ms(lambda: window_attn.fused_window_attention(win, *params, **akw))
                t_p = cuda_ms(lambda: window_attn.fused_window_attention_reference(win, *params, **akw))
                _compare("window_attn", f"{tag} attn_f32={attn_f32}", got, want,
                         bound(want, dtype, 4, 1e-4), t_k, t_p, stats)
                if dtype == bf and not attn_f32:  # the slice's configuration
                    stats["window_attn"]["ms"] += t_k
                    stats["window_attn"]["plain_ms"] += t_p

            # K3: residual + LN + MLP + residual
            a = randn(2, hw, hw, c, dtype=dtype, std=0.5)
            fp = (s, b, randn(4 * c, c, dtype=f32, std=bound_c), randn(4 * c, dtype=f32, std=0.02),
                  randn(c, 4 * c, dtype=f32, std=(4 * c) ** -0.5), randn(c, dtype=f32, std=0.02))
            got = ffn.fused_ln_mlp_residual(x, a, *fp)
            want = ffn.fused_ln_mlp_residual_reference(x, a, *fp)
            t_k = cuda_ms(lambda: ffn.fused_ln_mlp_residual(x, a, *fp))
            t_p = cuda_ms(lambda: ffn.fused_ln_mlp_residual_reference(x, a, *fp))
            _compare("ffn", tag, got, want, bound(want, dtype, 4, 1e-4),
                     t_k, t_p, stats)
            if dtype == bf:
                stats["ffn"]["ms"] += t_k
                stats["ffn"]["plain_ms"] += t_p

    # K4: epilogue at (2, 19, 128, 128), margin 40, both output types
    for dtype in (bf, f32):
        lg = randn(2, N_CLASSES, 128, 128, dtype=dtype, std=3.0)
        for output_type in ("argmax", "class_prob"):
            ekw = dict(margin=40, scale=4, output_type=output_type)
            got = epilogue.upsample_crop_convert(lg, **ekw)
            want = epilogue.upsample_crop_convert_reference(lg, **ekw)
            t_k = cuda_ms(lambda: epilogue.upsample_crop_convert(lg, **ekw))
            t_p = cuda_ms(lambda: epilogue.upsample_crop_convert_reference(lg, **ekw))
            tag = f"(2,19,128,128) m40 {'bf16' if dtype == bf else 'f32'} {output_type}"
            if output_type == "argmax":
                # the kernel's two-tap sums and the plain matmuls round apart:
                # only near-ties may flip; allow 1e-4 of the pixels
                frac = (got != want).float().mean().item()
                say("kernel", f"epilogue {tag}: differing pixels {frac:.2e} "
                    f"bound 1.0e-04 {'ok' if frac <= 1e-4 else 'FAIL'}; kernel "
                    f"{t_k:.4f} ms, plain {t_p:.4f} ms")
                if frac > 1e-4:
                    raise AssertionError(f"epilogue {tag}: {frac} of pixels differ")
                stats.setdefault("epilogue", {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
            else:
                _compare("epilogue", tag, got.int(), want.int(), 1.0, t_k, t_p, stats)
            if dtype == bf and output_type == "argmax":
                stats["epilogue"]["ms"] += t_k
                stats["epilogue"]["plain_ms"] += t_p
    return stats


def slice_config(img: str, weights: str) -> dict:
    """bench.py's zonal configuration (bench.py:55-90) for the port."""
    return {
        "output_path": os.path.join(TMP, "out"), "output_name": "chip_smoke",
        "write_dataframe": False, "output_type": "argmax", "cog_conversion": False,
        "model_weights": weights, "batch_size": BATCH, "num_worker": 4,
        "img_pixels_detection": 512, "margin": 40, "output_px_meters": RES,
        "compute_dtype": "bfloat16", "attn_f32": False, "normalize_on_device": True,
        "emit_label_placeholders": False,
        "monotemp_arch": "swin_base_patch4_window12_384-upernet",
        "modalities": {
            "inputs": {"AERIAL_RGBI": True},
            "AERIAL_RGBI": {"input_img_path": img, "channels": [1, 2, 3],
                            "normalization": {"type": "custom",
                                              "means": [105.66, 111.35, 102.18],
                                              "stds": [52.23, 45.62, 44.30]}},
        },
        "tasks": [{"name": "AERIAL_LABEL-COSIA", "active": True,
                   "class_names": {i: f"c{i}" for i in range(N_CLASSES)}}],
    }


def _zonal_pass(cfg: dict, model) -> tuple[float, dict]:
    """Wall seconds of one zonal pass (tiling, dataset, inference, stitch,
    D2H, write) with a prebuilt model, as bench.py times it, and the
    engine's phase timings of that pass."""
    import torch

    from flair_for_aigle_tpu_torch.zonal import inference as zi
    from flair_for_aigle_tpu_torch.zonal.model_utils import compute_patch_sizes
    from flair_for_aigle_tpu_torch.zonal.stripes import LAST_TIMINGS

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c = zi.initialize_geometry_and_resolutions(dict(cfg))
    c["output_type"] = "argmax"
    tiles = zi.generate_patches_from_reference(c)
    patch_sizes = compute_patch_sizes(c)
    dataset = zi.prep_dataset(c, tiles, patch_sizes)
    loader = zi.BatchedLoader(dataset, batch_size=BATCH, num_workers=c["num_worker"])
    ref_img = zi.open_raster(c["modalities"]["AERIAL_RGBI"]["input_img_path"])
    output_files, _ = zi.init_outputs(c, ref_img)
    zi.inference_and_write(model, loader, tiles, c, output_files, ref_img,
                           torch.device("cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ref_img.close()
    dataset.close()
    return wall, dict(LAST_TIMINGS)


def synthetic_raster(seed: int = 0):
    """(3, SIDE, SIDE) uint8 raster with the spatial correlation of aerial
    imagery: a 32 x 32 normal field per band, bilinearly upsampled, scaled
    to mean 110 and std 45, plus per-pixel noise of std 12."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    low = torch.from_numpy(rng.normal(size=(1, 3, 32, 32)).astype(np.float32))
    field = torch.nn.functional.interpolate(low, size=(SIDE, SIDE), mode="bilinear",
                                            align_corners=False)[0].numpy()
    field = 110 + 45 * field / field.std() + rng.normal(size=field.shape) * 12
    return np.clip(field, 0, 255).astype(np.uint8)


def phase_slice(card: str, write_geotiff, io_desc: str) -> dict:
    import numpy as np
    import torch
    from safetensors.torch import save_file

    from flair_for_aigle_tpu_torch.ops import epilogue, ffn, prep, window_attn
    from flair_for_aigle_tpu_torch.zonal import inference as zi
    from flair_for_aigle_tpu_torch.zonal.model_utils import build_inference_model

    say("slice", f"host IO: {io_desc}")
    os.makedirs(TMP, exist_ok=True)
    img = os.path.join(TMP, "raster.tif")
    raster = synthetic_raster(0)
    transform = zi.from_origin(700000.0, 6600000.0, RES, RES)
    write_geotiff(img, raster, transform, "EPSG:2154", compress="lzw", tile_size=512)
    weights = os.path.join(TMP, "weights.safetensors")
    cfg = slice_config(img, weights)
    # random weights from a seeded torch.Generator, written as a checkpoint
    # that run_inference loads like a published one
    seed_cfg = zi.initialize_geometry_and_resolutions(dict(cfg))
    zi._set_labels(seed_cfg)
    seed_model, _ = build_inference_model({**seed_cfg, "model_weights": ""},
                                          device="cpu", seed=0)
    save_file({k: v.contiguous() for k, v in seed_model.state_dict().items()}, weights)
    del seed_model

    fns = {"prep": prep.fused_ln_shift_partition,
           "window_attn": window_attn.fused_window_attention,
           "ffn": ffn.fused_ln_mlp_residual,
           "epilogue": epilogue.upsample_crop_convert}
    # the user entry point, with every launch count at 0 just before it
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    paths = zi.run_inference(dict(cfg))
    torch.cuda.synchronize()
    t_entry = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    say("slice", f"run_inference {t_entry:.2f} s (model build, checkpoint load and "
        f"first cuDNN autotune included); launches during it: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel did not run on the main path: {launches}")

    out_path = paths["AERIAL_LABEL-COSIA"]
    with zi.open_raster(out_path) as src:
        pred = src.read()
        t = src.transform
        geo_ok = ((src.height, src.width) == (SIDE, SIDE) and src.count == 1
                  and src.crs == "EPSG:2154"
                  and np.allclose([t.a, t.b, t.c, t.d, t.e, t.f],
                                  [transform.a, transform.b, transform.c,
                                   transform.d, transform.e, transform.f]))
    if not geo_ok:
        raise AssertionError("output GeoTIFF geometry differs from the raster's")
    if pred.max() >= N_CLASSES:
        raise AssertionError(f"label {pred.max()} >= {N_CLASSES}")
    n_tiles = len(zi.generate_patches_from_reference(
        zi.initialize_geometry_and_resolutions(dict(cfg))))
    say("slice", f"output {pred.shape} uint8, labels {int(pred.min())}..{int(pred.max())}, "
        f"geometry ok; {n_tiles} tiles")

    # one batch: kernels vs a forward made of the plain versions
    pcfg = zi.initialize_geometry_and_resolutions(dict(cfg))
    zi._set_labels(pcfg)
    model, _ = build_inference_model(pcfg, device="cuda")
    norm = {"AERIAL_RGBI": ("custom", cfg["modalities"]["AERIAL_RGBI"]["normalization"]["means"],
                            cfg["modalities"]["AERIAL_RGBI"]["normalization"]["stds"])}
    step = zi.ZonalStep(model, "argmax", 40, 512, 1, 1, torch.bfloat16, norm, torch.device("cuda"))
    offs = [(y, x) for y in range(0, SIDE - 512, 432) for x in range(0, SIDE - 512, 432)][:BATCH]
    tiles = torch.stack([torch.from_numpy(raster[:, y:y + 512, x:x + 512]) for y, x in offs]).cuda()
    batch = {"AERIAL_RGBI": tiles,
             "AERIAL_LABEL-COSIA": torch.zeros((len(offs), 1, 512, 512), device="cuda")}
    mods = {"prep": (prep, "fused_ln_shift_partition"),
            "window_attn": (window_attn, "fused_window_attention"),
            "ffn": (ffn, "fused_ln_mlp_residual"),
            "epilogue": (epilogue, "upsample_crop_convert")}

    def forward(plain: bool, dtype) -> torch.Tensor:
        step.compute_dtype = dtype
        try:
            if plain:
                for mod, name in mods.values():
                    setattr(mod, name, getattr(mod, name + "_reference"))
            return step.forward_convert(batch)["AERIAL_LABEL-COSIA"]
        finally:
            for key, (mod, name) in mods.items():
                setattr(mod, name, fns[key])

    pred_k, pred_r = forward(False, torch.bfloat16), forward(True, torch.bfloat16)
    agree = (pred_k == pred_r).float().mean().item()
    # context: the same comparison in float32, and bf16 drift against float32
    pred_k32, pred_r32 = forward(False, torch.float32), forward(True, torch.float32)
    agree32 = (pred_k32 == pred_r32).float().mean().item()
    drift_k = (pred_k == pred_r32).float().mean().item()
    drift_r = (pred_r == pred_r32).float().mean().item()
    # bounds: random weights leave near-tied logits, so bf16 rounding alone
    # flips up to about 1% of the labels (the plain bf16 forward against the
    # float32 one); the kernels must match the plain versions in float32,
    # agree on >= 99% of the pixels in bf16, and drift no further from
    # float32 than the plain versions do
    say("slice", f"argmax agreement kernels vs plain versions, one batch of {len(offs)}: "
        f"float32 {agree32:.5f} (bound >= 0.999), bf16 {agree:.5f} (bound >= 0.99); "
        f"bf16 vs the float32 plain forward: kernels {drift_k:.5f}, plain {drift_r:.5f} "
        f"(bound: kernels >= plain - 0.002)")
    if agree32 < 0.999 or agree < 0.99 or drift_k < drift_r - 0.002:
        raise AssertionError("kernel forward disagrees with the plain forward")

    # bench.py's metric: read -> tile -> infer -> stitch -> write with a
    # prebuilt model, one warm-up pass then one timed pass
    (first, _), (wall, phases) = [_zonal_pass(cfg, model) for _ in range(2)]
    km2 = SIDE * SIDE * RES * RES / 1e6
    say("slice", f"warm wall {wall:.3f} s (first pass {first:.3f} s), "
        f"{n_tiles / wall:.2f} tiles/s, {km2 / wall * 3600:.1f} km2/h on {card}; "
        "phases (s): " + ", ".join(f"{k} {v:.4f}" for k, v in phases.items()
                                   if k.endswith("_s")))
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "flair_for_aigle_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(flair_for_aigle_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from flair_for_aigle_tpu_torch.zonal.memory_io import host_io

    env = phase_env()
    phase_build()
    stats = phase_kernels()
    with host_io() as (write_geotiff, io_desc):
        launches = phase_slice(env["card"], write_geotiff, io_desc)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["kind"],
                                              "count": env["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
