"""Batch collation with Sentinel time-axis padding.

Behavioral port of flair_hub/data/utils_data/padding.py:48-88
(``pad_collate_flair``): SENTINEL ``*_TS`` / ``*_DATES`` entries are padded
along the time axis to the batch max, everything array-like is stacked,
strings pass through as lists.

TPU addition: ``fixed_t`` pads to a static bucket size (default: rounded up
to a multiple of ``t_bucket``) instead of the exact batch max, so jit traces
are reused across batches instead of recompiling per unique T.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, List, Sequence

import numpy as np

from flair_for_aigle_tpu_torch.data.sentinel import select_keep_indices, warn_once

logger = logging.getLogger(__name__)

TO_PAD_KEYS = [
    "SENTINEL2_TS", "SENTINEL2_DATES",
    "SENTINEL1-ASC_TS", "SENTINEL1-ASC_DATES",
    "SENTINEL1-DESC_TS", "SENTINEL1-DESC_DATES",
]


def pad_tensor(x: np.ndarray, length: int, pad_value: float = 0) -> np.ndarray:
    """Pad (T, ...) to ``length`` — or truncate per the unified T-overflow
    policy (data/sentinel.py:select_keep_indices, even temporal
    subsampling: collate has no per-date cloud scores). The keep indices
    depend only on (T, length), so a sample's ``*_TS`` and ``*_DATES``
    entries — equal T, collated independently — stay aligned."""
    padlen = length - x.shape[0]
    if padlen == 0:
        return x
    if padlen < 0:
        warn_once(
            ("collate", x.shape[0], length),
            "collate: sample has %d dates > fixed T %d: dropping %d by even "
            "temporal subsampling (reference pads to the batch max and "
            "never drops — raise fixed_t to avoid)",
            x.shape[0], length, -padlen)
        return x[select_keep_indices(x.shape[0], length)]
    pad = np.full((padlen, *x.shape[1:]), pad_value, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)


def pad_collate(
    samples: List[Dict[str, Any]],
    pad_value: float = 0,
    fixed_t: int | None = None,
    t_bucket: int = 8,
) -> Dict[str, Any]:
    """Collate a list of sample dicts into batched numpy arrays."""
    batch: Dict[str, Any] = {}
    for key in samples[0].keys():
        vals = [s[key] for s in samples]
        if key in TO_PAD_KEYS:
            if all(np.size(v) == 0 for v in vals):
                batch[key] = np.zeros((len(vals), 0), np.float32)
                continue
            sizes = [v.shape[0] for v in vals if np.size(v) > 0]
            max_t = max(sizes) if sizes else 0
            if fixed_t is not None:
                max_t = fixed_t
            elif t_bucket:
                max_t = int(math.ceil(max_t / t_bucket) * t_bucket)
            padded = [
                pad_tensor(np.asarray(v), max_t, pad_value)
                if np.size(v) > 0
                else np.full((max_t,), pad_value, np.float32)
                for v in vals
            ]
            batch[key] = np.stack(padded, axis=0)
        elif isinstance(vals[0], np.ndarray) or (
            np.isscalar(vals[0]) and not isinstance(vals[0], str)
        ):
            batch[key] = np.stack([np.asarray(v) for v in vals], axis=0)
        else:
            batch[key] = vals
    return batch
