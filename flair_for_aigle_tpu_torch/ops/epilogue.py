"""K4: fused zonal epilogue — x4 align-corners bilinear upsample + margin
crop + argmax / class-prob quantisation (CUDA kernel ``csrc/epilogue.cu``)
and its plain PyTorch version.

Replaces ``flair_for_aigle_tpu/ops/pallas/epilogue.py:184
upsample_crop_convert``. The kernel reads the stride-4 logits once and
writes the cropped uint8 prediction; the full-resolution float32 logits
never exist. Bandwidth-bound on the card; see the CUDA source.

argmax ties break to the lowest class index; class_prob is
round(softmax * 255) with the softmax statistics taken online over the
classes, as the reference's stats pass does.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from flair_for_aigle_tpu_torch.ops import _build

MAX_CLASSES = 64


@lru_cache(maxsize=None)
def _interp_matrix(in_size: int, scale: int, lo: int, hi: int) -> np.ndarray:
    """(hi-lo, in_size) float32: rows evaluate UpsamplingBilinear2d
    (align_corners=True, factor ``scale``) at output positions [lo, hi);
    weights built in float64 and stored as float32 (reference
    ``_interp_matrix`` :36)."""
    out_size = in_size * scale
    m = np.zeros((hi - lo, in_size), np.float32)
    for r, i in enumerate(range(lo, hi)):
        src = i * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        a = int(np.floor(src))
        b = min(a + 1, in_size - 1)
        f = src - a
        m[r, a] += 1.0 - f
        m[r, b] += f
    return m


@lru_cache(maxsize=None)
def _taps(in_size: int, scale: int, lo: int, hi: int):
    """Two-tap form of ``_interp_matrix``: (lo_idx, hi_idx, w_lo, w_hi) per
    output position — the same float32 weights; a single tap (boundary)
    carries its summed weight on lo_idx and 0 on hi_idx."""
    m = _interp_matrix(in_size, scale, lo, hi)
    n = hi - lo
    i_lo = np.zeros(n, np.int32)
    i_hi = np.zeros(n, np.int32)
    w_lo = np.zeros(n, np.float32)
    w_hi = np.zeros(n, np.float32)
    for r in range(n):
        nz = np.nonzero(m[r])[0]
        i_lo[r] = i_hi[r] = nz[0]
        w_lo[r] = m[r, nz[0]]
        if len(nz) > 1:
            i_hi[r] = nz[1]
            w_hi[r] = m[r, nz[1]]
    return i_lo, i_hi, w_lo, w_hi


def upsample_crop_convert_reference(logits_s4: torch.Tensor, *, margin: int,
                                    scale: int = 4,
                                    output_type: str = "argmax"
                                    ) -> torch.Tensor:
    """Plain version in the Pallas body's order: per class
    R @ L_k @ C float32 interpolation matmuls over the kept rows/columns,
    then a running argmax (strict >) or the online softmax statistics and
    the round(softmax * 255) write."""
    b, k_cls, h4, w4 = logits_s4.shape
    inner = h4 * scale - 2 * margin
    dev = logits_s4.device
    r = torch.as_tensor(_interp_matrix(h4, scale, margin, margin + inner),
                        device=dev)
    c = torch.as_tensor(_interp_matrix(w4, scale, margin, margin + inner),
                        device=dev).t()
    lg = logits_s4.float()

    def up(k):
        return torch.matmul(torch.matmul(r, lg[:, k]), c)  # (b, inner, inner)

    if output_type == "argmax":
        m = up(0)
        idx = torch.zeros(m.shape, dtype=torch.int64, device=dev)
        for k in range(1, k_cls):
            u = up(k)
            idx = torch.where(u > m, k, idx)
            m = torch.maximum(m, u)
        return idx.to(torch.uint8)[:, None]
    m = up(0)
    s = torch.ones_like(m)
    for k in range(1, k_cls):
        u = up(k)
        m_new = torch.maximum(m, u)
        s = s * torch.exp(m - m_new) + torch.exp(u - m_new)
        m = m_new
    planes = [torch.round(torch.exp(up(k) - m) * (255.0 / s))
              .to(torch.int32).to(torch.uint8) for k in range(k_cls)]
    return torch.stack(planes, dim=1)


_TAP_CACHE: dict = {}


def _device_taps(h4: int, w4: int, scale: int, margin: int, inner: int,
                 device) -> tuple:
    key = (h4, w4, scale, margin, inner, str(device))
    if key not in _TAP_CACHE:
        rows = _taps(h4, scale, margin, margin + inner)
        cols = _taps(w4, scale, margin, margin + inner)
        _TAP_CACHE[key] = tuple(torch.as_tensor(a, device=device)
                                for a in (*rows, *cols))
    return _TAP_CACHE[key]


def upsample_crop_convert(logits_s4: torch.Tensor, *, margin: int,
                          scale: int = 4,
                          output_type: str = "argmax") -> torch.Tensor:
    """logits_s4: (B, K, h/scale, w/scale) stride-``scale`` logits.
    Returns uint8 (B, 1, inner, inner) argmax labels or (B, K, inner, inner)
    round(softmax * 255), inner = h - 2 * margin. CPU tensors take the plain
    version; CUDA tensors launch the kernel (float32 or bfloat16,
    contiguous NCHW, K <= 64)."""
    if output_type not in ("argmax", "class_prob"):
        raise ValueError(f"unknown output_type {output_type!r}")
    if logits_s4.device.type == "cpu":
        return upsample_crop_convert_reference(logits_s4, margin=margin,
                                               scale=scale,
                                               output_type=output_type)
    b, k_cls, h4, w4 = logits_s4.shape
    inner = h4 * scale - 2 * margin
    if logits_s4.device.type != "cuda":
        raise ValueError(f"epilogue kernel: unsupported device {logits_s4.device}")
    if logits_s4.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"epilogue kernel: unsupported dtype {logits_s4.dtype}")
    if not logits_s4.is_contiguous():
        raise ValueError("epilogue kernel: logits must be contiguous NCHW")
    if k_cls > MAX_CLASSES or h4 != w4 or inner <= 0:
        raise ValueError(f"epilogue kernel: unsupported K={k_cls}, "
                         f"{h4}x{w4}, margin={margin}")
    taps = _device_taps(h4, w4, scale, margin, inner, logits_s4.device)
    n_out = 1 if output_type == "argmax" else k_cls
    out = torch.empty((b, n_out, inner, inner), dtype=torch.uint8,
                      device=logits_s4.device)
    rc = _build.lib().epilogue_fwd(
        logits_s4.data_ptr(), *(t.data_ptr() for t in taps), out.data_ptr(),
        b, k_cls, h4, w4, inner, int(output_type == "class_prob"),
        _build.dtype_code(logits_s4), _build.stream_ptr(logits_s4))
    _build.check(rc, "epilogue_fwd")
    upsample_crop_convert.launches += 1
    return out


upsample_crop_convert.launches = 0
