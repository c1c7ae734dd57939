"""Resize primitives with PyTorch / SciPy semantics on NHWC tensors.

Port of ``flair_for_aigle_tpu/ops/resize.py``: the same index maps and
two-tap float32 weights (torch bilinear with align_corners False and True,
torch nearest, scipy ``zoom(order=0)``) and the same ``AdaptiveAvgPool2d``
bins. The bilinear and pooling maps are applied as two float32 matrix
products, which reproduces the reference's summation order.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

from flair_for_aigle_tpu_torch.utils import profiling


def _torch_bilinear_weights(in_size: int, out_size: int):
    """Source indices + lerp weights for align_corners=False."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = np.clip((dst + 0.5) * scale - 0.5, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo).astype(np.float32)


def _torch_nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """torch mode='nearest': floor(dst * in / out)."""
    scale = in_size / out_size
    idx = np.floor(np.arange(out_size, dtype=np.float64) * scale).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def scipy_zoom0_index(in_size: int, out_size: int) -> np.ndarray:
    """scipy.ndimage.zoom(order=0, grid_mode=False): output i reads input
    round(i * (in - 1) / (out - 1))."""
    if out_size <= 1 or in_size <= 1:
        return np.zeros(out_size, dtype=np.int64)
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    return np.clip(np.round(src).astype(np.int64), 0, in_size - 1)


def _two_tap_matrix(lo, hi, f, in_size: int, out_size: int) -> np.ndarray:
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), 1.0 - f)
    np.add.at(m, (rows, hi), f)
    return m


@lru_cache(maxsize=None)
def _bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    lo, hi, f = _torch_bilinear_weights(in_size, out_size)
    return _two_tap_matrix(lo, hi, f, in_size, out_size)


@lru_cache(maxsize=None)
def _bilinear_ac_matrix(in_size: int, out_size: int) -> np.ndarray:
    if out_size == 1:
        src = np.zeros(1)
    else:
        src = np.arange(out_size, dtype=np.float64) * (
            (in_size - 1) / (out_size - 1))
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    return _two_tap_matrix(lo, hi, (src - lo).astype(np.float32), in_size,
                           out_size)


@lru_cache(maxsize=None)
def _pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        lo = int(np.floor(i * in_size / out_size))
        hi = int(np.ceil((i + 1) * in_size / out_size))
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


@contextmanager
def _batch_invariant_blas(device: torch.device):
    """On a CUDA device, the products inside the block go through cuBLASLt.
    The two einsums of ``_apply_hw`` fold the batch into a product's N (or
    its batch count), and cuBLAS's default heuristics chose their kernel,
    and so their float32 summation, by it: on the H100 the 3 x 3 PSP pool of
    swin-base-UPerNet at batch 8 differed from the same tiles' rows at
    batch 16, so a zonal replica's labels differed from the one-device
    run's. Through cuBLASLt every row came out bit-identical
    (``chip_smoke.py`` ``[multigpu]``). The CPU is left as it is."""
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cuda.preferred_blas_library()
    torch.backends.cuda.preferred_blas_library("cublaslt")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_blas_library(saved)


def _apply_hw(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray) -> torch.Tensor:
    """out[o, p] = sum_h sum_w mh[o, h] x[h, w] mw[p, w] over (..., H, W, C),
    float32, rows first; each row independent of the others in its batch."""
    xf = x.float()
    with profiling.blocked():  # copies from pageable memory wait for the card
        mh_t = torch.as_tensor(mh, device=x.device)
        mw_t = torch.as_tensor(mw, device=x.device)
    with _batch_invariant_blas(x.device):
        out = torch.einsum("oh,...hwc->...owc", mh_t, xf)
        out = torch.einsum("pw,...owc->...opc", mw_t, out)
    return out.to(x.dtype)


def resize_bilinear_nhwc(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch bilinear, align_corners=False, on (..., H, W, C)."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    return _apply_hw(x, _bilinear_matrix(h, out_h), _bilinear_matrix(w, out_w))


def resize_bilinear_ac_nhwc(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch bilinear, align_corners=True (nn.UpsamplingBilinear2d)."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    return _apply_hw(x, _bilinear_ac_matrix(h, out_h),
                     _bilinear_ac_matrix(w, out_w))


def resize_nearest_nhwc(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch mode='nearest' on (..., H, W, C)."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    if out_h % h == 0 and out_w % w == 0:
        out = torch.repeat_interleave(x, out_h // h, dim=-3)
        return torch.repeat_interleave(out, out_w // w, dim=-2)
    with profiling.blocked():  # copies from pageable memory wait for the card
        ih = torch.as_tensor(_torch_nearest_index(h, out_h), device=x.device)
        iw = torch.as_tensor(_torch_nearest_index(w, out_w), device=x.device)
    return x.index_select(-3, ih).index_select(-2, iw)


def adaptive_avg_pool_nhwc(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch AdaptiveAvgPool2d bins on (..., H, W, C)."""
    h, w = x.shape[-3], x.shape[-2]
    return _apply_hw(x, _pool_matrix(h, out_h), _pool_matrix(w, out_w))
