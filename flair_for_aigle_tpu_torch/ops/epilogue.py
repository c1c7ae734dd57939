"""K4: fused zonal epilogue — x4 align-corners bilinear upsample + margin
crop + argmax / class-prob quantisation (CUDA kernel ``csrc/epilogue.cu``)
and its plain PyTorch version.

Replaces ``flair_for_aigle_tpu/ops/pallas/epilogue.py:184
upsample_crop_convert``. The kernel reads the stride-4 logits once and
writes the cropped uint8 prediction; the full-resolution float32 logits
never exist. One block a tile of output rows and columns stages the source
rows and columns the tile needs, takes each row tap once into shared
memory, then each thread the column taps of a few adjacent pixels and one
packed store: ``epilogue_plan`` cuts the tiles and builds the kernel's
small tables; ``epilogue_info`` reports the kernels' resources. See the
CUDA source for the bounds.

argmax ties break to the lowest class index; class_prob is
round(softmax * 255) with the softmax statistics taken online over the
classes, as the reference's stats pass does.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from flair_for_aigle_tpu_torch.device import device_constant
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


#: threads of a kernel block
EPI_THREADS = 256
#: most dynamic shared memory a plan may ask of a block, at MAX_CLASSES
#: classes in float32 (the staged logits and the row taps)
EPI_MAX_SMEM = 160 * 1024
#: staged columns start on, and span, a multiple of this many elements (16
#: bytes of bf16, 32 of float32: whole 16-byte loads in either dtype)
EPI_CHUNK = 8


class EpiloguePlan(NamedTuple):
    """How ``csrc/epilogue.cu`` cuts one call: tiles of ``tr`` output rows
    by ``gt`` groups of ``p`` adjacent output pixels (a thread a group),
    ``col_tiles`` x ``row_tiles`` of them an image; each tile stages ``nc``
    source columns from ``col_start[t]`` and at most ``nr`` source rows
    (``row_tile[t]``: first row, rows). The tables, as the kernel reads
    them: ``row_loc`` (inner, 2) int32, each output row's two source rows
    relative to its tile's first staged row; ``row_w`` (inner, 2) float32,
    their weights; ``row_tile`` (row_tiles, 2) int32; ``col_start``
    (col_tiles,) int32, a multiple of ``EPI_CHUNK``; ``group_base`` (groups,)
    int32, a group's first source column relative to its tile's first
    staged column; ``col_w`` (groups p, 3) float32, each pixel's weights of
    the group's three source columns (zero past the last pixel)."""
    p: int
    gt: int
    tr: int
    col_tiles: int
    row_tiles: int
    nc: int
    nr: int
    row_loc: np.ndarray
    row_w: np.ndarray
    row_tile: np.ndarray
    col_start: np.ndarray
    group_base: np.ndarray
    col_w: np.ndarray


def epilogue_smem(k: int, itemsize: int, tr: int, nc: int, nr: int) -> int:
    """Dynamic shared bytes of a block (``csrc/epilogue.cu
    epi_smem_bytes``): the staged logits (K, nr, nc) in the logits' dtype,
    then the row taps (tr, K, nc) in float32."""
    return k * nr * nc * itemsize + tr * k * nc * 4


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _tile_cost(tiles: int, tr: int, gt: int, nc: int, nr: int) -> float:
    """A model of one image's warp instructions per class: the column taps
    and running argmax of each warp of groups (about 27 a warp and class),
    the row taps (a warp a row and class, two columns a lane, about 12 a
    64 columns) and the staging (a 16-byte chunk a lane)."""
    return tiles * (27 * _ceil(tr * gt, 32) + 12 * tr * _ceil(nc, 64) + nr * nc / 32)


@lru_cache(maxsize=64)
def epilogue_plan(h4: int, scale: int, margin: int) -> EpiloguePlan:
    """The tiles and tables of the kernel at (h4 = w4, scale, margin),
    inner = h4 scale - 2 margin > 0 (the wrapper's checks).

    A group holds p = 4 pixels where every four adjacent pixels' taps reach
    at most three neighbouring source columns (scale >= 3), else 2 (which
    always do). Of the column-tile counts whose tile rows hold 16 to 256
    groups and whose blocks fit ``EPI_MAX_SMEM`` at 64 float32 classes, the
    one of least ``_tile_cost``."""
    inner = h4 * scale - 2 * margin
    if inner <= 0:
        raise ValueError(f"epilogue plan: margin {margin} leaves no pixel of {h4 * scale}")
    rlo, rhi, rw_lo, rw_hi = _taps(h4, scale, margin, margin + inner)
    clo, chi, cw_lo, cw_hi = rlo, rhi, rw_lo, rw_hi  # h4 == w4: the same taps
    p = 4 if all(clo[j:j + 4].max() - clo[j] <= 1 and chi[j:j + 4].max() - clo[j] <= 2
                 for j in range(0, inner, 4)) else 2
    groups = _ceil(inner, p)

    def cols(gt: int):
        """(first staged column of each tile, staged columns)."""
        starts, width = [], 0
        for t in range(_ceil(groups, gt)):
            first = clo[t * gt * p] // EPI_CHUNK * EPI_CHUNK
            last = int(clo[min(groups, (t + 1) * gt) * p - p]) + 2
            starts.append(first)
            width = max(width, last - first + 1)
        return starts, _ceil(width, EPI_CHUNK) * EPI_CHUNK

    def rows(tr: int):
        """((first source row, rows) of each row tile, most rows)."""
        tiles = [(int(rlo[i]), int(rhi[i:i + tr].max()) - int(rlo[i]) + 1)
                 for i in range(0, inner, tr)]
        return tiles, max(n for _, n in tiles)

    best = None
    for n_ct in range(1, groups + 1):
        gt = _ceil(groups, n_ct)
        if gt > EPI_THREADS or _ceil(groups, gt) != n_ct:
            continue
        if gt < 16 and best is not None:
            break
        tr = min(EPI_THREADS // gt, inner)
        starts, nc = cols(gt)
        tiles, nr = rows(tr)
        if epilogue_smem(MAX_CLASSES, 4, tr, nc, nr) > EPI_MAX_SMEM:
            continue
        cost = _tile_cost(n_ct * len(tiles), tr, gt, nc, nr)
        if best is None or cost < best[0]:
            best = (cost, gt, tr, starts, nc, tiles, nr)
    if best is None:
        raise ValueError(f"epilogue plan: no tile of h4={h4}, scale={scale} fits "
                         f"{EPI_MAX_SMEM} bytes of shared memory")
    _, gt, tr, starts, nc, tiles, nr = best
    row_tile = np.asarray(tiles, np.int32)
    first = np.repeat(row_tile[:, 0], tr)[:inner]
    row_loc = np.stack([rlo - first, rhi - first], 1).astype(np.int32)
    row_w = np.stack([rw_lo, rw_hi], 1).astype(np.float32)
    col_start = np.asarray(starts, np.int32)
    j0 = np.arange(groups) * p
    group_base = (clo[j0] - col_start[np.arange(groups) // gt]).astype(np.int32)
    col_w = np.zeros((groups * p, 3), np.float32)
    for j in range(inner):
        d = int(clo[j] - clo[j - j % p])  # 0 or 1: where the pixel's taps start
        col_w[j, d] += cw_lo[j]
        col_w[j, d + 1] += cw_hi[j]
    return EpiloguePlan(p, gt, tr, len(starts), len(tiles), nc, nr, row_loc, row_w,
                        row_tile, col_start, group_base, col_w)


def _plan_tables(h4: int, scale: int, margin: int) -> tuple:
    """The six tables of ``epilogue_plan(h4, scale, margin)``, in the
    kernel's argument order."""
    plan = epilogue_plan(h4, scale, margin)
    return (plan.row_loc, plan.row_w, plan.row_tile, plan.col_start, plan.group_base,
            plan.col_w)


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
    plan = epilogue_plan(h4, scale, margin)
    tables = device_constant(_plan_tables, h4, scale, margin, device=logits_s4.device)
    # the kernel stages the logits 16 bytes at a time
    logits_s4 = _build.aligned(logits_s4)
    n_out = 1 if output_type == "argmax" else k_cls
    out = torch.empty((b, n_out, inner, inner), dtype=torch.uint8,
                      device=logits_s4.device)
    rc = _build.lib().epilogue_fwd(
        logits_s4.data_ptr(), *(t.data_ptr() for t in tables), out.data_ptr(),
        b, k_cls, h4, w4, inner, plan.tr, plan.gt, plan.nc, plan.nr,
        plan.col_tiles, plan.row_tiles, plan.p, int(output_type == "class_prob"),
        _build.dtype_code(logits_s4), _build.stream_ptr(logits_s4))
    _build.check(rc, "epilogue_fwd")
    upsample_crop_convert.launches += 1
    return out


upsample_crop_convert.launches = 0


def epilogue_info(k: int, dtype=torch.bfloat16, output_type: str = "argmax", *,
                  h4: int = 128, scale: int = 4, margin: int = 40) -> dict:
    """The resources of the kernel that ``upsample_crop_convert`` runs for
    K = k classes in ``dtype`` at (h4, scale, margin) on the current card,
    as the CUDA runtime reports them: registers per thread, local (spill)
    bytes per thread, shared bytes per block and resident blocks per SM;
    with the plan's tile (``tr`` rows by ``gt`` groups of ``p`` pixels)."""
    plan = epilogue_plan(h4, scale, margin)
    out = (ctypes.c_int * 4)()
    rc = _build.lib().epilogue_info(
        0 if dtype == torch.float32 else 1, plan.p, int(output_type == "class_prob"), k,
        plan.tr, plan.nc, plan.nr, ctypes.addressof(out))
    _build.check(rc, "epilogue_info")
    return {**dict(zip(("regs", "spill_bytes", "shared_bytes", "blocks_per_sm"), out)),
            "p": plan.p, "gt": plan.gt, "tr": plan.tr}
