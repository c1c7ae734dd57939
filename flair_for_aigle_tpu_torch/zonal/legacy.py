"""Legacy accumulate inference variant (host-side numpy canvas).

Port of ``flair_for_aigle_tpu/zonal/legacy.py``, the reference's older
``inference`` entry point: sums the int8-converted predictions of every
tile into a full-raster numpy canvas, clipped to the raster; returns
(raster_logits, transform). The production path is
``zonal.inference.inference_and_write`` (stitching on the device); this
variant exists for callers of the reference API.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from flair_for_aigle_tpu_torch.device import resolve_device
from flair_for_aigle_tpu_torch.ops.resize import resize_bilinear_ac_nhwc
from flair_for_aigle_tpu_torch.zonal.postprocess import convert

logger = logging.getLogger(__name__)


@torch.no_grad()
def inference(model, dataloader, tiles, config: Dict, raster_img, device="cuda"):
    """Legacy accumulate variant: ``model`` (already on ``device``, the
    CUDA card unless the caller asks for ``"cpu"``) runs on every array of
    each batch as the dataset gives it (host-normalised float32 inputs)."""
    from flair_for_aigle_tpu_torch.zonal.inference import resample_prediction

    device = resolve_device(device)
    margin_px = config["margin"]
    tile_size = config["img_pixels_detection"]
    output_type = config["output_type"]
    ref_res = config["reference_resolution"]
    out_res = config.get("output_px_meters", ref_res)
    needs_rescale = abs(ref_res - out_res) > 1e-6
    image_bounds = config["image_bounds"]
    transform = raster_img.transform

    n_out = 1
    for t in config["tasks"]:
        if t.get("active"):
            n_out = len(t["class_names"]) if output_type == "class_prob" else 1
            break
    img_height = int(round((image_bounds["top"] - image_bounds["bottom"]) / out_res))
    img_width = int(round((image_bounds["right"] - image_bounds["left"]) / out_res))
    raster_logits = np.zeros((n_out, img_height, img_width), dtype=np.int8)

    task0 = config["labels"][0]
    for batch in dataloader:
        valid = batch.pop("valid", None)
        indices = np.asarray(batch["index"]).reshape(-1)
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()
              if isinstance(v, np.ndarray) and k != "index"}
        lg = model(tb)[0][task0]
        if model.stride4:
            # stride-4 NHWC logits (the fused epilogue's input) back to the
            # full-resolution NCHW logits this variant crops
            lg = resize_bilinear_ac_nhwc(lg, lg.shape[-3] * 4, lg.shape[-2] * 4)
            lg = lg.permute(0, 3, 1, 2)
        logits = lg.float().cpu().numpy()
        for i, idx in enumerate(indices):
            if valid is not None and i >= valid:
                continue
            row = tiles[int(idx)]
            patch = logits[i, :, margin_px:tile_size - margin_px,
                           margin_px:tile_size - margin_px]
            if needs_rescale:
                patch = resample_prediction(patch, ref_res / out_res)
            pred = convert(patch, output_type).astype(np.int8)
            left_px = int(round((row["left"] - image_bounds["left"]) / out_res))
            top_px = int(round((image_bounds["top"] - row["top"]) / out_res))
            c, h, w = pred.shape
            x1, y1 = max(0, left_px), max(0, top_px)
            x2 = min(img_width, left_px + w)
            y2 = min(img_height, top_px + h)
            if x2 <= x1 or y2 <= y1:
                logger.warning("[!] Tile %s fully outside raster. Skipping.", row["id"])
                continue
            dx1, dy1 = x1 - left_px, y1 - top_px
            raster_logits[:, y1:y2, x1:x2] += pred[:, dy1:dy1 + (y2 - y1),
                                                   dx1:dx1 + (x2 - x1)]
    return raster_logits, transform
