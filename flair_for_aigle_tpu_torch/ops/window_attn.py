"""K2: fused swin window attention forward (CUDA kernel
``csrc/window_attn.cu``) and K6, its backward (``csrc/window_attn_bwd.cu``),
with their plain PyTorch versions.

Replaces ``flair_for_aigle_tpu/ops/pallas/window_attn.py:973
fused_window_attention`` (forward; body ``_kernel_body`` :173). On the card
the two projections run ``csrc/gemm_mma.cuh``'s tensor-core GEMM (bf16, or
float32 as 3xTF32) with its bias epilogue, each with the tile that
``attn_gemm_tiles`` plans (``ops/mma_plan.py``), and the attention core
runs one block per (window, head), one warp per 16 query rows, with the
scores and probabilities in mma.sync registers (bf16 on m16n8k16; float32
as 3xTF32 on m16n8k8, ``csrc/window_attn_f32.cu``), so the (B*nW, nh, T, T)
scores never leave the SM. See the CUDA sources for the bounds. Every
tensor a kernel reads goes through ``_build.aligned`` (a view off a
16-byte boundary is copied).

Weights use the ``nn.Linear`` layout: ``wqkv`` (3C, C), ``wproj`` (C, C).
The softmax follows the Pallas body: ``attn_f32=True`` is the float32
static-shift form (exp(min(s, 80) - 30), +1e-37 denominator guard,
normalisation deferred past P V); ``attn_f32=False`` runs the scores in the
compute dtype with a per-row max.

Differentiable: ``fused_window_attention`` saves only its raw inputs and its
backward is ``fused_window_attention_backward`` (K6 on the card; on the CPU
autograd through the plain forward), as the reference's ``custom_vjp``
(``window_attn.py:941-970``). K6 replaces both TPU backward kernels, the
monolithic one (``:534``) and the head-chunked one (``:751``): the chunked
grid only fitted the TPU's VMEM at C = 512 / 1024. K6 recomputes qkv with
the kernel and tile K2's forward used at the same rows, and runs its do,
dx and weight-gradient products on the same GEMM (``csrc/
window_attn_bwd_gemm.cu``): do and dx on the weights' transposed copies
with K2's output-projection tile, the weight gradients as C = A^T B in
float32 split-K partials (``ops/mma_plan.py wgrad_plan``);
``backward_gemm`` runs one of them alone.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from flair_for_aigle_tpu_torch.ops import _build
from flair_for_aigle_tpu_torch.ops._vjp import plain_vjp
from flair_for_aigle_tpu_torch.ops.mma_plan import (
    MMA_TILES,
    PLAN_TILES,
    WGRAD_TILE,
    gemm_plan,
    n_sm,
    wgrad_plan,
)

#: static softmax shift and overflow clamp of the attn_f32 form
SHIFT = 30.0
CLAMP = 80.0
#: largest window (T = ws * ws tokens) the kernel takes: window 12
MAX_T = 144
HEAD_DIM = 32


@lru_cache(maxsize=None)
def shift_mask_bank(ws: int, ss: int) -> np.ndarray:
    """(4, T, T) float32 additive masks: [interior, last-col, last-row,
    last-row+col] — timm's shifted-window mask rows at each window position
    (``flair_for_aigle_tpu/ops/pallas/window_attn.py:103``)."""
    t = ws * ws

    def groups(last: bool) -> np.ndarray:
        g = np.zeros(ws, np.int64)
        if last:
            g[: ws - ss] = 1
            g[ws - ss:] = 2
        return g

    bank = np.zeros((4, t, t), np.float32)
    for p, (li, lj) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        gr, gc = groups(bool(li)), groups(bool(lj))
        gid = (gr[:, None] * 3 + gc[None, :]).reshape(-1)
        diff = gid[None, :] - gid[:, None]
        bank[p] = np.where(diff != 0, -100.0, 0.0)
    return bank


@lru_cache(maxsize=None)
def shift_mask_patterns(ws: int, ss: int) -> np.ndarray:
    """(3, T, T) float32 [ar, ac, ar*ac]: ar(i, j) = 1 where the last-row
    band ids of tokens i and j differ, ac the last-column analogue; the
    mask at window position (li, lj) is -100 (li ar + lj ac - li lj ar ac)
    (``flair_for_aigle_tpu/ops/pallas/window_attn.py:127``)."""
    t = ws * ws
    g = np.zeros(ws, np.int64)
    g[: ws - ss] = 1
    g[ws - ss:] = 2
    gr = g[(np.arange(t) // ws)]
    gc = g[(np.arange(t) % ws)]
    ar = (gr[:, None] != gr[None, :]).astype(np.float32)
    ac = (gc[:, None] != gc[None, :]).astype(np.float32)
    return np.stack([ar, ac, ar * ac])


@lru_cache(maxsize=None)
def _grid_mask(ws: int, ss: int, nwh: int, nww: int) -> np.ndarray:
    """(nwh*nww, T, T) mask per window of the padded grid, from the
    arithmetic pattern form the Pallas body uses."""
    ar, ac, arac = shift_mask_patterns(ws, ss)
    out = np.zeros((nwh * nww, ws * ws, ws * ws), np.float32)
    for wi in range(nwh):
        for wj in range(nww):
            li, lj = float(wi == nwh - 1), float(wj == nww - 1)
            out[wi * nww + wj] = -100.0 * (li * ar + lj * ac - li * lj * arac)
    return out


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """TorchLinear epilogue order: f32-accumulated product -> compute dtype
    -> + bias in the compute dtype."""
    dt = x.dtype
    return torch.matmul(x, w.to(dt).t()) + b.to(dt)


def _scores(q, k, bias, *, window_size: int, shift_size: int, grid_hw,
            attn_f32: bool) -> torch.Tensor:
    """Per head s = QK^T * scale + bias (+ shift mask), (bnw, nh, T, T), in
    the Pallas body's order of operations: float32 with ``attn_f32``, else
    rounded to the compute dtype after each op. q, k: (bnw, nh, T, hd)."""
    bnw, nh, t, hd = q.shape
    dt = q.dtype
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    mask = None
    if shift_size > 0:
        nwh, nww = grid_hw
        mask = torch.as_tensor(_grid_mask(window_size, shift_size, nwh, nww),
                               device=q.device)[:, None]  # (nW, 1, t, t)
    if attn_f32:
        s = s * hd ** -0.5 + bias.float()
    else:
        s = s.to(dt) * torch.tensor(hd ** -0.5, dtype=dt, device=q.device)
        s = s + bias.to(dt)
        mask = None if mask is None else mask.to(dt)
    if mask is not None:
        s = (s.reshape(-1, mask.shape[0], nh, t, t) + mask).reshape(bnw, nh, t, t)
    return s


def _split_heads(qkv, num_heads: int, t: int):
    """q, k, v (bnw, nh, T, hd) of qkv (B*nW*T, 3C)."""
    c = qkv.shape[1] // 3
    bnw = qkv.shape[0] // t
    return qkv.reshape(bnw, t, 3, num_heads, c // num_heads).permute(2, 0, 3, 1, 4)


def window_attention_core_reference(qkv, bias, *, num_heads: int,
                                    window_size: int, shift_size: int,
                                    grid_hw, attn_f32: bool = True) -> torch.Tensor:
    """Plain version of the attention core, in the Pallas body's order of
    operations: per head QK^T * scale + bias (+ shift mask), the softmax of
    the ``attn_f32`` mode and P V. qkv: (B*nW*T, 3C), the qkv projection's
    output; bias: (nh, T, T). Returns the heads merged, (B*nW*T, C)."""
    t = window_size * window_size
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, num_heads, t)             # (bnw, nh, t, hd)
    s = _scores(q, k, bias, window_size=window_size, shift_size=shift_size,
                grid_hw=grid_hw, attn_f32=attn_f32)
    if attn_f32:
        e = torch.exp(torch.clamp(s, max=CLAMP) - SHIFT)
        denom = e.sum(-1, keepdim=True) + 1e-37
    else:
        e = torch.exp(s - s.amax(-1, keepdim=True))
        denom = (e.sum(-1, keepdim=True) + 1e-37).float()
    o = torch.matmul(e.to(dt).float(), v.float()) / denom
    return o.to(dt).transpose(1, 2).reshape(qkv.shape[0], qkv.shape[1] // 3)


def fused_window_attention_reference(x, wqkv, bqkv, wproj, bproj, bias, *,
                                     num_heads: int, window_size: int,
                                     shift_size: int, grid_hw,
                                     attn_f32: bool = True) -> torch.Tensor:
    """Plain version of the kernel, in the Pallas body's order of
    operations. x: (B*nW, T, C); bias: (nh, T, T). Returns (B*nW, T, C)."""
    bnw, t, c = x.shape
    qkv = _linear(x.reshape(bnw * t, c), wqkv, bqkv)
    o = window_attention_core_reference(
        qkv, bias, num_heads=num_heads, window_size=window_size,
        shift_size=shift_size, grid_hw=grid_hw, attn_f32=attn_f32)
    return _linear(o, wproj, bproj).reshape(bnw, t, c)


def _check(x, num_heads: int, window_size: int, grid_hw, what: str,
           shape=None) -> None:
    """Raise on what the kernels do not take; ``shape`` (B*nW, T, C) stands
    for x's own shape where x holds the windows in another layout."""
    bnw, t, c = x.shape if shape is None else shape
    nh = num_heads
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if (c % nh or c // nh != HEAD_DIM or t != window_size ** 2 or t > MAX_T
            or c % 8):
        raise ValueError(
            f"{what}: unsupported C={c}, heads={nh}, T={t} "
            f"(needs head dim {HEAD_DIM}, T = ws^2 <= {MAX_T})")
    nwh, nww = grid_hw
    if bnw % (nwh * nww):
        raise ValueError(f"{what}: B*nW must be a multiple of the window grid")


def _params(x, wqkv, bqkv, wproj, bproj, bias, nh: int, bias_dtype, what: str):
    """The weights in the compute dtype and the bias in ``bias_dtype``, on
    x's device, contiguous, on a 16-byte boundary, shape-checked."""
    _, t, c = x.shape
    dt = x.dtype
    wqkv, bqkv, wproj, bproj = (_build.param(p, x.device, dt)
                                for p in (wqkv, bqkv, wproj, bproj))
    bias = _build.param(bias, x.device, bias_dtype)
    if (wqkv.shape != (3 * c, c) or bqkv.shape != (3 * c,)
            or wproj.shape != (c, c) or bproj.shape != (c,)
            or bias.shape != (nh, t, t)):
        raise ValueError(f"{what}: parameter shapes do not match x")
    return wqkv, bqkv, wproj, bproj, bias


def attn_gemm_tiles(m: int, c: int, sms: int, dtype) -> tuple[int, int]:
    """Tile codes (``ops/mma_plan.py MMA_TILES``) of the qkv (m, 3C) and
    output (m, C) projections at m = B*nW*T rows on a card of ``sms`` SMs:
    the largest tile that gives every SM a block, K never split. K6's qkv
    recompute takes the qkv tile, so it repeats K2's product."""
    return gemm_plan(m, 3 * c, c, sms, dtype)[0], gemm_plan(m, c, c, sms, dtype)[0]


def _launch(x, wqkv, bqkv, wproj, bproj, bias, *, num_heads: int,
            window_size: int, shift_size: int, grid_hw,
            attn_f32: bool) -> torch.Tensor:
    """The forward kernel on CUDA tensors, the plain version on CPU ones."""
    if x.device.type == "cpu":
        return fused_window_attention_reference(
            x, wqkv, bqkv, wproj, bproj, bias, num_heads=num_heads,
            window_size=window_size, shift_size=shift_size, grid_hw=grid_hw,
            attn_f32=attn_f32)
    what = "window attention kernel"
    _check(x, num_heads, window_size, grid_hw, what)
    x = _build.aligned(x)
    bnw, t, c = x.shape
    dt = x.dtype
    wqkv, bqkv, wproj, bproj, bias = _params(
        x, wqkv, bqkv, wproj, bproj, bias, num_heads,
        torch.float32 if attn_f32 else dt, what)
    nwh, nww = grid_hw
    tile_qkv, tile_proj = attn_gemm_tiles(bnw * t, c, n_sm(x.device), dt)
    qkv = torch.empty((bnw * t, 3 * c), dtype=dt, device=x.device)
    o = torch.empty((bnw * t, c), dtype=dt, device=x.device)
    out = torch.empty((bnw, t, c), dtype=dt, device=x.device)
    rc = _build.lib().window_attn_fwd(
        x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
        bproj.data_ptr(), bias.data_ptr(), qkv.data_ptr(), o.data_ptr(),
        out.data_ptr(), bnw, t, c, num_heads, window_size, shift_size, nwh,
        nww, int(bool(attn_f32)), tile_qkv, tile_proj, _build.dtype_code(x),
        _build.stream_ptr(x))
    _build.check(rc, "window_attn_fwd")
    fused_window_attention.launches += 1
    return out


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, bias, cfg):
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bproj, bias)
        ctx.cfg = cfg
        return _launch(x, wqkv, bqkv, wproj, bproj, bias, **cfg)

    @staticmethod
    def backward(ctx, g):
        grads = fused_window_attention_backward(g, *ctx.saved_tensors, **ctx.cfg)
        return (*(gr if need else None
                  for gr, need in zip(grads, ctx.needs_input_grad)), None)


def fused_window_attention(x, wqkv, bqkv, wproj, bproj, bias, *,
                           num_heads: int, window_size: int, shift_size: int,
                           grid_hw, attn_f32: bool = True) -> torch.Tensor:
    """Windowed MHA (qkv projection -> attention -> output projection) over
    partitioned windows x (B*nW, T, C), already cyclic-shifted when
    shift_size > 0, windows row-major over the padded (nwh, nww) grid.
    bias: (nh, T, T) relative-position bias. CPU tensors take the plain
    version; CUDA tensors launch the kernel (float32 or bfloat16, head dim
    32, T <= 144). Differentiable in every tensor input (K6 backward)."""
    cfg = dict(num_heads=num_heads, window_size=window_size,
               shift_size=shift_size, grid_hw=tuple(grid_hw),
               attn_f32=bool(attn_f32))
    return _WindowAttention.apply(x, wqkv, bqkv, wproj, bproj, bias, cfg)


fused_window_attention.launches = 0


def window_attention_core(qkv, bias, *, num_heads: int, window_size: int,
                          shift_size: int, grid_hw,
                          attn_f32: bool = True) -> torch.Tensor:
    """The attention core of ``fused_window_attention`` alone, on the qkv
    projection's output qkv (B*nW*T, 3C): returns the heads merged, (B*nW*T,
    C). CPU tensors take the plain version; CUDA tensors launch the core
    kernel that K2 launches between its two projections. Not
    differentiable."""
    cfg = dict(num_heads=num_heads, window_size=window_size,
               shift_size=shift_size, grid_hw=tuple(grid_hw),
               attn_f32=bool(attn_f32))
    if qkv.device.type == "cpu":
        return window_attention_core_reference(qkv, bias, **cfg)
    what = "window attention core kernel"
    t = window_size * window_size
    if qkv.dim() != 2 or qkv.shape[0] % t or qkv.shape[1] % 3:
        raise ValueError(f"{what}: qkv must be (B*nW*T, 3C), got {tuple(qkv.shape)}")
    m, c = qkv.shape[0], qkv.shape[1] // 3
    bnw = m // t
    _check(qkv, num_heads, window_size, grid_hw, what, shape=(bnw, t, c))
    qkv = _build.aligned(qkv)
    bias = _build.param(bias, qkv.device, torch.float32 if attn_f32 else qkv.dtype)
    if bias.shape != (num_heads, t, t):
        raise ValueError(f"{what}: bias must be ({num_heads}, {t}, {t})")
    o = torch.empty((m, c), dtype=qkv.dtype, device=qkv.device)
    nwh, nww = cfg["grid_hw"]
    rc = _build.lib().window_attn_core(
        qkv.data_ptr(), bias.data_ptr(), o.data_ptr(), bnw, t, c, num_heads,
        window_size, shift_size, nwh, nww, int(cfg["attn_f32"]),
        _build.dtype_code(qkv), _build.stream_ptr(qkv))
    _build.check(rc, "window_attn_core")
    window_attention_core.launches += 1
    return o


window_attention_core.launches = 0


def window_attention_core_info(t: int, attn_f32: bool,
                               dtype=torch.bfloat16) -> dict:
    """The core kernel's resources on the current card at T = t tokens, as
    the CUDA runtime reports them: registers per thread, local (spill)
    bytes per thread, shared bytes per block and resident blocks per SM."""
    out = (ctypes.c_int * 4)()
    rc = _build.lib().window_attn_core_info(
        t, int(bool(attn_f32)), 0 if dtype == torch.float32 else 1,
        ctypes.addressof(out))
    _build.check(rc, "window_attn_core_info")
    return dict(zip(("regs", "spill_bytes", "shared_bytes", "blocks_per_sm"), out))


def window_attention_gemm_info(dtype=torch.bfloat16, m: int | None = None,
                               c: int | None = None) -> dict:
    """The resources of the projections' GEMM kernel (``gemm_mma.cuh``,
    bias epilogue) in ``dtype`` on the current card, as the CUDA runtime
    reports them: registers per thread, local (spill) bytes per thread,
    shared bytes per block and resident blocks per SM, keyed ``"qkv
    64x128"``, .... Without ``m`` and ``c``, every tile of the dtype's plan
    (keyed ``"bias 128x128"``, ...); with them, the tiles that K2 takes for
    m = B*nW*T rows of C."""
    code = 0 if dtype == torch.float32 else 1
    if m is None:
        kernels = [("bias", t) for t in PLAN_TILES[dtype]]
    else:
        sms = n_sm(torch.device("cuda", torch.cuda.current_device()))
        kernels = list(zip(("qkv", "proj"), attn_gemm_tiles(m, c, sms, dtype)))
    info = {}
    for name, tile in kernels:
        out = (ctypes.c_int * 4)()
        rc = _build.lib().window_attn_gemm_info(code, tile, ctypes.addressof(out))
        _build.check(rc, "window_attn_gemm_info")
        bm, bn = MMA_TILES[tile]
        info[f"{name} {bm}x{bn}"] = dict(
            zip(("regs", "spill_bytes", "shared_bytes", "blocks_per_sm"), out))
    return info


def fused_window_attention_backward_reference(g, x, wqkv, bqkv, wproj, bproj,
                                              bias, **cfg) -> tuple:
    """Plain backward: autograd through the plain forward. Returns
    (dx, dwqkv, dbqkv, dwproj, dbproj, dbias) in the inputs' dtypes."""
    return plain_vjp(lambda *a: fused_window_attention_reference(*a, **cfg),
                     (x, wqkv, bqkv, wproj, bproj, bias), g)


def window_attention_core_backward_reference(qkv, do, bias, *, num_heads: int,
                                             window_size: int, shift_size: int,
                                             grid_hw, attn_f32: bool = True) -> tuple:
    """Plain version of K6's attention core, in the Pallas backward body's
    order of operations (``_bwd_kernel_body`` :466-515): per head the
    scores and probabilities p of the ``attn_f32`` mode recomputed from qkv
    (B*nW*T, 3C), pc = p in the compute dtype, then o = pc V, dv = pc^T do,
    dp = do V^T, ds = p (dp - sum_j dp p), dq = scale ds K and dk = scale
    ds^T Q, all products float32. do: (B*nW*T, C), the gradient at the
    output projection's input, in the compute dtype; bias: (nh, T, T).
    Returns o (B*nW*T, C) and dqkv (B*nW*T, 3C) in the compute dtype, dbias
    (nh, T, T) = ds summed over the windows and dbqkv (3C) = the float32
    dqkv summed over the rows."""
    t = window_size * window_size
    m, c3 = qkv.shape
    bnw, nh = m // t, num_heads
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, nh, t)
    scale = (c3 // 3 // nh) ** -0.5
    g = do.reshape(bnw, t, nh, -1).transpose(1, 2).float()
    s = _scores(q, k, bias, window_size=window_size, shift_size=shift_size,
                grid_hw=grid_hw, attn_f32=attn_f32)
    e = (torch.exp(torch.clamp(s, max=CLAMP) - SHIFT) if attn_f32
         else torch.exp(s - s.amax(-1, keepdim=True)))
    p = e / (e.sum(-1, keepdim=True) + 1e-37)
    pc = p.to(dt).float()
    p = p.float()
    o = torch.matmul(pc, v.float()).to(dt)
    dv = torch.matmul(pc.transpose(-1, -2), g)
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(m, c3)
    return (o.transpose(1, 2).reshape(m, c3 // 3), dqkv.to(dt), ds.sum(0),
            dqkv.sum(0))


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _core_groups(bnw: int, nh: int, slots: int) -> int:
    """Window groups of K6's core launch (one block per group and head,
    each walking its group's windows): as many groups as one wave of the
    kernel's ``slots`` resident blocks holds, each with as few windows as
    that allows, so that a launch never ends on a nearly empty second wave."""
    per = _ceil(bnw, max(1, min(bnw, slots // nh)))
    return _ceil(bnw, per)


@lru_cache(maxsize=None)
def _core_slots(t: int, attn_f32: bool, dtype: torch.dtype, n_sm: int) -> int:
    """Blocks of K6's core kernel resident on the card at once, as the CUDA
    runtime reports its residency at T = t tokens."""
    return n_sm * window_attention_core_backward_info(t, attn_f32, dtype)["blocks_per_sm"]


class BwdPlan(NamedTuple):
    """K6's launch plan at B*nW windows of T tokens and C channels."""
    groups: int        # window groups of the core launch
    tile_qkv: int      # the qkv recompute's tile: K2's qkv tile
    tile_proj: int     # do's and dx's tile: K2's output-projection tile
    tile_w: int        # the weight gradients' tile
    k_chunk_proj: int  # rows of each dWproj partial (and of dbproj's)
    k_chunk_qkv: int   # rows of each dWqkv partial
    wpart: int         # float32 elements of the partials' buffer


def _bwd_plan(bnw: int, nh: int, t: int, c: int, n_sm: int, slots: int, dtype) -> BwdPlan:
    """K6's plan: the core's window groups for its ``slots`` resident
    blocks, K2's projection tiles at the same rows, and the weight
    gradients' ``wgrad_plan`` (dWproj (C, C) and dWqkv (3C, C) over the
    B*nW*T rows, in partials of at most ``WGRAD_ROWS`` rows), whose
    partials size the buffer they share with dbproj's column sums (a
    partial of C per dWproj chunk)."""
    m = bnw * t
    tile_qkv, tile_proj = attn_gemm_tiles(m, c, n_sm, dtype)
    tile_w, k_proj, n_proj = wgrad_plan(c, c, m, n_sm, dtype)
    _, k_qkv, n_qkv = wgrad_plan(3 * c, c, m, n_sm, dtype)
    return BwdPlan(_core_groups(bnw, nh, slots), tile_qkv, tile_proj, tile_w, k_proj, k_qkv,
                   max(n_proj * c * c, n_qkv * 3 * c * c))


def window_attention_core_backward(qkv, do, bias, *, num_heads: int,
                                   window_size: int, shift_size: int, grid_hw,
                                   attn_f32: bool = True) -> tuple:
    """K6's attention core alone: on the recomputed qkv (B*nW*T, 3C) and do
    (B*nW*T, C), returns (o, dqkv, dbias, dbqkv) as
    ``window_attention_core_backward_reference`` does. CPU tensors take the
    plain version; CUDA tensors launch the core kernel that K6 launches
    between its GEMMs, then the fixed-order sums of its per-group dbias and
    dbqkv partials (one count in ``launches`` per call)."""
    cfg = dict(num_heads=num_heads, window_size=window_size,
               shift_size=shift_size, grid_hw=tuple(grid_hw),
               attn_f32=bool(attn_f32))
    if qkv.device.type == "cpu":
        return window_attention_core_backward_reference(qkv, do, bias, **cfg)
    what = "window attention backward core kernel"
    t = window_size * window_size
    if qkv.dim() != 2 or qkv.shape[0] % t or qkv.shape[1] % 3:
        raise ValueError(f"{what}: qkv must be (B*nW*T, 3C), got {tuple(qkv.shape)}")
    m, c = qkv.shape[0], qkv.shape[1] // 3
    bnw, nh = m // t, num_heads
    _check(qkv, nh, window_size, grid_hw, what, shape=(bnw, t, c))
    if do.shape != (m, c):
        raise ValueError(f"{what}: do must be ({m}, {c}), got {tuple(do.shape)}")
    qkv = _build.aligned(qkv)
    do = _build.aligned(do.to(qkv.device, qkv.dtype).contiguous())
    bias = _build.param(bias, qkv.device, torch.float32)
    if bias.shape != (nh, t, t):
        raise ValueError(f"{what}: bias must be ({nh}, {t}, {t})")
    dev = qkv.device
    sms = n_sm(dev)
    groups = _core_groups(bnw, nh, _core_slots(t, bool(attn_f32), qkv.dtype, sms))
    o = torch.empty((m, c), dtype=qkv.dtype, device=dev)
    dqkv = torch.empty((m, 3 * c), dtype=qkv.dtype, device=dev)
    dbias_part, dbqkv_part, dbias, dbqkv = (
        torch.empty(shape, dtype=torch.float32, device=dev)
        for shape in ((groups, nh, t, t), (groups, 3 * c), (nh, t, t), (3 * c,)))
    nwh, nww = cfg["grid_hw"]
    rc = _build.lib().window_attn_bwd_core(
        qkv.data_ptr(), do.data_ptr(), bias.data_ptr(), o.data_ptr(), dqkv.data_ptr(),
        dbias_part.data_ptr(), dbqkv_part.data_ptr(), dbias.data_ptr(), dbqkv.data_ptr(),
        bnw, t, c, nh, window_size, shift_size, nwh, nww, int(cfg["attn_f32"]), groups,
        _build.dtype_code(qkv), _build.stream_ptr(qkv))
    _build.check(rc, "window_attn_bwd_core")
    window_attention_core_backward.launches += 1
    return o, dqkv, dbias, dbqkv


window_attention_core_backward.launches = 0


def window_attention_core_backward_info(t: int, attn_f32: bool,
                                        dtype=torch.bfloat16) -> dict:
    """K6's core kernel's resources on the current card at T = t tokens, as
    the CUDA runtime reports them: registers per thread, local (spill)
    bytes per thread, shared bytes per block, resident blocks and resident
    warps per SM."""
    out = (ctypes.c_int * 5)()
    rc = _build.lib().window_attn_bwd_core_info(
        t, int(bool(attn_f32)), 0 if dtype == torch.float32 else 1,
        ctypes.addressof(out))
    _build.check(rc, "window_attn_bwd_core_info")
    return dict(zip(("regs", "spill_bytes", "shared_bytes", "blocks_per_sm",
                     "warps_per_sm"), out))


def fused_window_attention_backward(g, x, wqkv, bqkv, wproj, bproj, bias, *,
                                    num_heads: int, window_size: int,
                                    shift_size: int, grid_hw,
                                    attn_f32: bool = True) -> tuple:
    """Gradients of ``fused_window_attention`` for the output gradient g:
    (dx, dwqkv, dbqkv, dwproj, dbproj, dbias), weights in the ``nn.Linear``
    layout ((3C, C), (C, C)). CPU tensors take the plain version; CUDA
    tensors launch K6 (weight and bias gradients accumulate in float32 and
    are returned in the parameters' dtypes)."""
    cfg = dict(num_heads=num_heads, window_size=window_size,
               shift_size=shift_size, grid_hw=tuple(grid_hw),
               attn_f32=bool(attn_f32))
    if x.device.type == "cpu":
        return fused_window_attention_backward_reference(
            g, x, wqkv, bqkv, wproj, bproj, bias, **cfg)
    what = "window attention backward kernel"
    _check(x, num_heads, window_size, grid_hw, what)
    bnw, t, c = x.shape
    nh = num_heads
    dt = x.dtype
    dev = x.device
    if g.shape != x.shape:
        raise ValueError(f"{what}: g and x shapes differ")
    x = _build.aligned(x)
    g = _build.aligned(g.to(dev, dt).contiguous())
    wq, bq, wp, _, b32 = _params(x, wqkv, bqkv, wproj, bproj, bias, nh,
                                 torch.float32, what)
    # do = g Wproj and dx = dqkv Wqkv as C = A W^T on the transposed copies
    wq_t, wp_t = (_build.aligned(w.t().contiguous()) for w in (wq, wp))
    m = bnw * t
    sms = n_sm(dev)
    plan = _bwd_plan(bnw, nh, t, c, sms, _core_slots(t, bool(attn_f32), dt, sms), dt)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def cdt(*shape):
        return torch.empty(shape, dtype=dt, device=dev)

    qkv, do, o, dqkv = cdt(m, 3 * c), cdt(m, c), cdt(m, c), cdt(m, 3 * c)
    dbias_part, dbqkv_part = f32(plan.groups, nh, t, t), f32(plan.groups, 3 * c)
    wpart = f32(plan.wpart)
    dx = cdt(bnw, t, c)
    dwqkv, dbqkv, dwproj, dbproj, dbias = (f32(3 * c, c), f32(3 * c), f32(c, c),
                                           f32(c), f32(nh, t, t))
    nwh, nww = grid_hw
    rc = _build.lib().window_attn_bwd(
        x.data_ptr(), g.data_ptr(), wq.data_ptr(), bq.data_ptr(), wq_t.data_ptr(),
        wp_t.data_ptr(), b32.data_ptr(), qkv.data_ptr(), do.data_ptr(), o.data_ptr(),
        dqkv.data_ptr(), dbias_part.data_ptr(), dbqkv_part.data_ptr(),
        wpart.data_ptr(), dx.data_ptr(), dwqkv.data_ptr(), dbqkv.data_ptr(),
        dwproj.data_ptr(), dbproj.data_ptr(), dbias.data_ptr(), bnw, t, c, nh,
        window_size, shift_size, nwh, nww, int(bool(attn_f32)), plan.groups,
        plan.tile_qkv, plan.tile_proj, plan.tile_w, plan.k_chunk_proj, plan.k_chunk_qkv,
        _build.dtype_code(x), _build.stream_ptr(x))
    _build.check(rc, "window_attn_bwd")
    fused_window_attention_backward.launches += 1
    return (dx, dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype),
            dwproj.to(wproj.dtype), dbproj.to(bproj.dtype), dbias.to(bias.dtype))


fused_window_attention_backward.launches = 0


def backward_gemm_reference(a, b, *, wgrad: bool) -> torch.Tensor:
    """Plain version of ``backward_gemm``: the float32 product, rounded to
    a's dtype (do and dx) or kept in float32 (the weight gradients)."""
    if wgrad:
        return torch.matmul(a.float().t(), b.float())
    return torch.matmul(a.float(), b.float().t()).to(a.dtype)


def backward_gemm(a, b, *, wgrad: bool) -> torch.Tensor:
    """One of K6's products alone, as K6 runs it (``csrc/
    window_attn_bwd_gemm.cu``): ``wgrad=False``, rnd(a b^T) in a's dtype
    with a (M, K) and b (N, K), K2's output-projection tile at M rows (do =
    g Wproj and dx = dqkv Wqkv, b the weight's transposed copy);
    ``wgrad=True``, the float32 a^T b with a (K, M) and b (K, N), K split by
    ``wgrad_plan`` and the partials summed in order (dWproj = g^T o, dWqkv
    = dqkv^T x). CPU tensors take the plain version; CUDA tensors (float32,
    as 3xTF32, or bfloat16; M, N and, for ``wgrad=False``, K multiples of
    8) launch the kernel or raise."""
    if a.device.type == "cpu":
        return backward_gemm_reference(a, b, wgrad=wgrad)
    what = "window attention backward GEMM"
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{what}: a and b must lie on one CUDA device, got {a.device}, {b.device}")
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
        raise ValueError(f"{what}: takes float32 or bfloat16 pairs, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what}: a and b must be contiguous matrices")
    if wgrad:
        (k, m), (kb, n) = a.shape, b.shape
    else:
        (m, k), (n, kb) = a.shape, b.shape
    if k != kb or m % 8 or n % 8 or (not wgrad and k % 8):
        raise ValueError(f"{what}: shapes {tuple(a.shape)}, {tuple(b.shape)} do not fit "
                         f"(wgrad={wgrad}; M, N and the GEMM's K multiples of 8)")
    a, b = _build.aligned(a), _build.aligned(b)
    sms, dt = n_sm(a.device), a.dtype
    if wgrad:
        tile, k_chunk, parts = wgrad_plan(m, n, k, sms, dt)
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
        part = torch.empty(parts * m * n, dtype=torch.float32, device=a.device)
    else:
        tile, k_chunk = gemm_plan(m, n, k, sms, dt)[0], k
        out = torch.empty((m, n), dtype=dt, device=a.device)
        part = out
    rc = _build.lib().window_attn_bwd_gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), part.data_ptr(), m, n, k, k_chunk, tile,
        int(wgrad), _build.dtype_code(a), _build.stream_ptr(a))
    _build.check(rc, "window_attn_bwd_gemm")
    backward_gemm.launches += 1
    return out


backward_gemm.launches = 0


def window_attention_backward_gemm_info(dtype=torch.bfloat16) -> dict:
    """The resources of K6's product kernels (``gemm_mma.cuh``) in
    ``dtype`` on the current card, as the CUDA runtime reports them:
    registers per thread, local (spill) bytes per thread, shared bytes per
    block and resident blocks per SM, keyed ``"round 64x128"`` (do and dx,
    every tile of the dtype's plan) and ``"wgrad 64x128"`` (the weight
    gradients' tile, ``mma_plan.WGRAD_TILE``)."""
    code = 0 if dtype == torch.float32 else 1
    kernels = [("round", t, 0) for t in PLAN_TILES[dtype]] + [("wgrad", WGRAD_TILE, 1)]
    info = {}
    for name, tile, wgrad in kernels:
        out = (ctypes.c_int * 4)()
        rc = _build.lib().window_attn_bwd_gemm_info(code, tile, wgrad, ctypes.addressof(out))
        _build.check(rc, "window_attn_bwd_gemm_info")
        bm, bn = MMA_TILES[tile]
        info[f"{name} {bm}x{bn}"] = dict(
            zip(("regs", "spill_bytes", "shared_bytes", "blocks_per_sm"), out))
    return info
