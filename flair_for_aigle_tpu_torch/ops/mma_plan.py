"""The tile plans of ``csrc/gemm_mma.cuh``'s tensor-core GEMM, shared by
its callers: C (m, n) = A (m, k) W^T (``gemm_plan``) for K3's fc1 and fc2
(``ops/ffn.py``), K2's and K6's qkv and output projections and K6's do and
dx (``ops/window_attn.py``); and the weight gradients C (m, n) = A^T B
over k rows (``wgrad_plan``), K6's dWproj and dWqkv.

A tile's index in ``MMA_TILES`` is its code in ``gemm_mma.cuh gemm_tile``.
The plan is a function of the shapes, the dtype and the SM count alone, so
K6's qkv recompute takes the tile K2's forward took at the same rows and
computes the same qkv.
"""

from __future__ import annotations

import functools

import torch

#: the GEMM's tiles (rows of A, rows of W a block), by tile code
MMA_TILES = ((128, 128), (64, 128))
#: the tiles each dtype's plan picks from, largest first: float32's 128 x
#: 128 would hold one block an SM, and 64 x 128 ran faster at every
#: swin-base stage on the H100
PLAN_TILES = {torch.bfloat16: (0, 1), torch.float32: (1,)}
#: the tile of the weight gradients C = A^T B in either dtype: 64 x 128
#: (bf16's 128 x 128 spills in that layout: its copies' addresses need
#: more than the 128 registers of two blocks an SM)
WGRAD_TILE = 1
#: elements of K one pipeline step stages: 128 bytes of a bf16 row, 64 of
#: a float32 row
K_STEP = {torch.float32: 16, torch.bfloat16: 64}
#: fewest pipeline steps a split-K chunk of ``gemm_plan`` keeps
MIN_STEPS = 8
#: resident blocks per SM the GEMM kernel promises (``__launch_bounds__``
#: in gemm_mma.cuh: MMA_MIN_BLOCKS)
RESIDENT = 2


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def gemm_plan(m: int, n: int, k: int, n_sm: int, dtype,
              split: bool = False, codes=None) -> tuple[int, int, int]:
    """(tile code, k_chunk, partials) of one product C (m, n) = A (m, k)
    W^T in ``dtype`` on a card of ``n_sm`` SMs: the largest tile of
    the tile codes ``codes`` (by default ``PLAN_TILES[dtype]``) that gives
    every SM a block, at the full K.
    Where even the smallest tile does not and ``split`` is set (K3's fc2),
    K is cut into the fewest chunks of whole pipeline steps
    (``K_STEP[dtype]`` elements, at least ``MIN_STEPS`` of them a chunk)
    that do: block z of the grid sums K range [z k_chunk, (z + 1) k_chunk),
    and the partials are added in the order z = 0, 1, ... (a fixed order:
    two calls give the same bits). Without ``split`` the smallest tile
    runs at the full K."""
    for code in PLAN_TILES[dtype] if codes is None else codes:
        bm, bn = MMA_TILES[code]
        tiles = _ceil(m, bm) * _ceil(n, bn)
        if tiles >= n_sm:
            return code, k, 1
    if not split:
        return code, k, 1
    step = K_STEP[dtype]
    parts = max(1, min(_ceil(n_sm, tiles), k // (MIN_STEPS * step)))
    k_chunk = _ceil(_ceil(k, parts), step) * step
    return code, k_chunk, _ceil(k, k_chunk)


def wgrad_plan(m: int, n: int, k: int, n_sm: int, dtype) -> tuple[int, int, int]:
    """(tile code, k_chunk, partials) of one weight gradient C (m, n) = A^T
    B, A (k, m) and B (k, n), in ``dtype`` on a card of ``n_sm`` SMs. The
    output is small (C x C or 3C x C) and k large (every window row), so
    the tile ``WGRAD_TILE`` runs and K is cut into chunks of whole
    pipeline steps (``K_STEP[dtype]`` elements) until the blocks fill one
    wave of the kernel's ``RESIDENT`` blocks an SM: at most that many, and
    every SM a block. Block z of the grid sums K range [z k_chunk, (z + 1)
    k_chunk); the partials are added in the order z = 0, 1, ... (two calls
    give the same bits)."""
    code = WGRAD_TILE
    bm, bn = MMA_TILES[code]
    tiles = _ceil(m, bm) * _ceil(n, bn)
    step = K_STEP[dtype]
    steps = _ceil(k, step)
    parts = max(1, min(steps, RESIDENT * n_sm // tiles))
    k_chunk = _ceil(steps, parts) * step
    return code, k_chunk, _ceil(k, k_chunk)


@functools.lru_cache(maxsize=None)
def n_sm(device) -> int:
    """The SM count of a CUDA device (asked once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
