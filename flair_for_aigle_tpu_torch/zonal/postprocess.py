"""Logit conversion + COG conversion (reference postprocess.py).

``convert`` matches flair_zonal_detection/postprocess.py:9-30 numerically:
class_prob = round(softmax*255) as uint8; argmax = uint8 class indices with
a leading channel axis. Device-side fused variants live in
zonal/inference.py (XLA fuses softmax+round+cast into the model epilogue);
this host version exists for API parity and host-side post-processing.
"""

from __future__ import annotations

import numpy as np

from flair_for_aigle_tpu_torch.geo.geotiff import convert_to_cog  # re-export


def softmax(x: np.ndarray, axis: int = 0) -> np.ndarray:
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / np.sum(e, axis=axis, keepdims=True)


def convert(img: np.ndarray, img_type: str) -> np.ndarray:
    if img_type == "class_prob":
        if img.ndim != 3:
            raise ValueError("Expected logits with shape (C, H, W)")
        probs = softmax(img, axis=0)
        return np.round(probs * 255).astype(np.uint8)
    if img_type == "argmax":
        pred = np.argmax(img, axis=0)
        return np.expand_dims(pred.astype(np.uint8), axis=0)
    raise ValueError(f"Unknown output type: {img_type}")


def create_polygon_from_bounds(x_min, x_max, y_min, y_max):
    from flair_for_aigle_tpu_torch.geo import geos

    return geos.box(x_min, min(y_min, y_max), x_max, max(y_min, y_max))
