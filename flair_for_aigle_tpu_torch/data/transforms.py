"""Pure-numpy per-sample transforms.

Behavioral ports of the reference's utils_data transforms:
* ``norm`` — flair_hub/data/utils_data/norm.py:8-52 ('custom' per-channel
  mean/std in float64, 'scaling' img_as_float to [0,1], 'without').
* ``calc_elevation`` — elevation.py:3-12 (DSM-DTM difference).
* ``reshape_label_ohe`` — label.py:3-14.
* ``apply_numpy_augmentations`` — augmentations.py:6-48 (joint h/v flips +
  k*90-degree rotation applied identically to all inputs and labels).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def img_as_float(img: np.ndarray) -> np.ndarray:
    """skimage.img_as_float semantics for the dtypes we encounter."""
    if np.issubdtype(img.dtype, np.floating):
        return img.astype(np.float64)
    info = np.iinfo(img.dtype)
    if info.min < 0:  # signed ints map to [-1, 1]
        return img.astype(np.float64) / max(abs(info.min), info.max)
    return img.astype(np.float64) / info.max


def norm(
    in_img: np.ndarray,
    norm_type: str | None = None,
    means: Sequence[float] = (),
    stds: Sequence[float] = (),
) -> np.ndarray:
    """Channel-first normalization; first dimension is channels."""
    if norm_type not in ("scaling", "custom", "without"):
        raise ValueError(
            "Normalization argument should be 'scaling', 'custom', or 'without'."
        )
    if norm_type == "custom":
        if len(means) != len(stds):
            raise ValueError("'custom' norm requires equal-length means and stds.")
        out = in_img.astype(np.float64)
        for i in range(out.shape[0]):
            out[i] -= means[i]
            out[i] /= stds[i]
        return out
    if norm_type == "scaling":
        return img_as_float(in_img)
    return in_img


def calc_elevation(arr: np.ndarray) -> np.ndarray:
    """(2+, H, W) -> (1, H, W) elevation difference channel0 - channel1."""
    elev = arr[0] - arr[1]
    return elev[np.newaxis, :, :]


def reshape_label_ohe(arr: np.ndarray, num_classes: int) -> np.ndarray:
    """Label raster -> one-hot (num_classes, ...)."""
    if arr.shape[0] == 1:
        arr = arr.squeeze(0)
    return np.stack([arr == i for i in range(num_classes)], axis=0)


def apply_numpy_augmentations(
    batch_dict: Dict[str, np.ndarray],
    input_keys: List[str],
    label_keys: List[str],
    p_flip: float = 0.5,
    p_rot: float = 0.5,
    rng: np.random.Generator | None = None,
) -> Dict[str, np.ndarray]:
    """Identical joint flips/rotations over every input + label array."""
    rng = rng or np.random.default_rng()
    do_hflip = rng.random() < p_flip
    do_vflip = rng.random() < p_flip
    k_rot = int(rng.integers(1, 4)) if rng.random() < p_rot else 0

    def apply(arr):
        if do_hflip:
            arr = np.flip(arr, axis=-1)
        if do_vflip:
            arr = np.flip(arr, axis=-2)
        if k_rot > 0:
            arr = np.rot90(arr, k=k_rot, axes=(-2, -1))
        return arr

    for key in list(input_keys) + list(label_keys):
        if key not in batch_dict:
            continue
        arr = batch_dict[key]
        shape = arr.shape
        reshaped = arr.reshape(-1, *shape[-2:])
        reshaped = np.stack([apply(frame) for frame in reshaped], axis=0)
        batch_dict[key] = np.ascontiguousarray(reshaped.reshape(
            shape[:-2] + reshaped.shape[-2:]
        ))
    return batch_dict
