"""bf16 against float32 labels of one zonal batch, in the PyTorch port and in
the JAX package, on the CPU, with the same random weights.

    JAX_PLATFORMS=cpu python tools/bf16_label_agreement.py [--arch resnet34-unet]

The batch and the weights are those of ``chip_smoke.py``'s ``[families]``
phase: 16 tiles of 512 px cut from its synthetic 2048 x 2048 raster, the
port's model built with seed 0 (``build_inference_model``), carried into
the JAX model through ``convert_torch_state_dict``. Prints one JSON line:
each package's bf16-vs-float32 argmax agreement over the cropped tiles, the
two packages' agreement in float32 and in bf16, and the float32 top-2 logit
gap at the pixels the port's bf16 flips, against the largest |logit|.
Random weights leave near-tied logits, so this says how much of a bf16
flip rate belongs to the weights rather than to the implementation.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", default="resnet34-unet")
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp
    import torch

    import chip_smoke as cs
    from flair_for_aigle_tpu.models.checkpoint import convert_torch_state_dict
    from flair_for_aigle_tpu.models.flair_model import FlairHubModel as JaxModel
    from flair_for_aigle_tpu_torch import bench
    from flair_for_aigle_tpu_torch.zonal import inference as zi
    from flair_for_aigle_tpu_torch.zonal.model_utils import build_inference_model

    cs.DEVICE = "cpu"
    batch = cs.one_batch(cs.synthetic_raster(0))
    cfg = {**bench.make_cfg("unused.tif", "unused"), "monotemp_arch": args.arch}
    zi._set_labels(cfg)
    model, mc = build_inference_model(cfg, device="cpu")
    n = cfg["modalities"]["AERIAL_RGBI"]["normalization"]
    step = cs._step(model, {"AERIAL_RGBI": ("custom", n["means"], n["stds"])})
    k16 = cs._labels(step, batch, torch.bfloat16)[:, 0].numpy()
    k32 = cs._labels(step, batch, torch.float32)[:, 0].numpy()
    gap, top = cs.f32_top2_gap(step, batch)
    gap = gap[:, 0].numpy()

    x = step._apply_norm("AERIAL_RGBI", batch["AERIAL_RGBI"]).numpy()
    jmodel = JaxModel(config=mc)
    jb = {"AERIAL_RGBI": jnp.asarray(x),
          "AERIAL_LABEL-COSIA": jnp.zeros((len(x), 1, 512, 512), jnp.float32)}
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.key(0), b), jb)
    empty = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    variables, report = convert_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, dict(empty))
    if report["missing"] or report["shape_mismatch"]:
        raise SystemExit(f"weights did not carry over: {report['missing'][:4]}")
    apply = jax.jit(jmodel.apply)
    m, ts = step.margin, step.tile_size
    jax_labels = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        lg = apply(variables, {**jb, "AERIAL_RGBI": jb["AERIAL_RGBI"].astype(dt)})[0]
        lg = lg["AERIAL_LABEL-COSIA"][:, :, m:ts - m, m:ts - m].astype(jnp.float32)
        jax_labels[name] = np.asarray(jnp.argmax(lg, axis=1))
    flips = k16 != k32
    print(json.dumps({
        "arch": args.arch, "tiles": int(len(x)),
        "port_bf16_vs_f32": float((~flips).mean()),
        "jax_bf16_vs_f32": float((jax_labels["bf16"] == jax_labels["f32"]).mean()),
        "port_vs_jax_f32": float((k32 == jax_labels["f32"]).mean()),
        "port_vs_jax_bf16": float((k16 == jax_labels["bf16"]).mean()),
        "max_abs_logit": float(top),
        "largest_gap_at_a_port_flip": float(gap[flips].max()) if flips.any() else 0.0,
        "median_gap": float(np.median(gap))}))


if __name__ == "__main__":
    main()
