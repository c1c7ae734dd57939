"""K3: fused transformer-block tail — residual + LayerNorm + MLP + residual
(CUDA kernel ``csrc/ffn.cu``) and its plain PyTorch version; K7: its
backward (CUDA kernel ``csrc/ffn_bwd.cu``) and the backward's plain version.

Replaces ``flair_for_aigle_tpu/ops/pallas/ffn.py:481 fused_ln_mlp_residual``
(forward; body ``_kernel_body`` :120). On the card the fc1/fc2 products are
mma.sync tensor-core GEMMs (``csrc/gemm_mma.cuh``: bf16, or float32 as
3xTF32) whose epilogues apply bias + exact GELU (fc1) and the float32
residual (fc2, recomputing x + attn); the LayerNorm is one bandwidth-bound
pass. ``mlp_plan`` (``ops/mma_plan.py gemm_plan``) picks each product's
tile and fc2's split of K, for K3 and for K8 (``ops/finish.py``), which
runs the same products; ``ffn_info`` reports the GEMM kernels' resources. Every tensor
the kernels read goes through ``_build.aligned`` (a view off a 16-byte
boundary is copied). See the CUDA sources for
the bounds.

Weights use the ``nn.Linear`` layout: ``w1`` (hidden, C), ``w2`` (C, hidden).
Differentiable. The backward reads ``FLAIR_FFN_BWD`` when it runs, as the
reference's custom VJP does (``ffn.py:464-475``): ``kernel`` runs K7
(``fused_ln_mlp_residual_backward``, which replaces ``ffn.py:297
_build_bwd_call`` and the LayerNorm epilogue of ``_kernel_bwd`` :370) on
CUDA tensors and K7's plain version on CPU tensors; anything else, the
reference's default, recomputes through the plain forward under autograd.
K7's five products run on ``gemm_mma.cuh`` too (fc1 recomputed at K3's
tile with h0 kept, dh with the GELU derivative and db1's partials in its
epilogue, dln and the two weight gradients), planned by ``_bwd_plan``;
``ffn_bwd_gemm_info`` reports their kernels' resources.
"""

from __future__ import annotations

import ctypes
import os

import torch

from flair_for_aigle_tpu_torch.ops import _build
from flair_for_aigle_tpu_torch.ops._vjp import plain_vjp
from typing import NamedTuple

from flair_for_aigle_tpu_torch.ops.mma_plan import (
    MMA_TILES,
    PLAN_TILES,
    WGRAD_TILE,
    gemm_plan,
    n_sm,
    wgrad_plan,
)


def gelu_exact(h: torch.Tensor) -> torch.Tensor:
    """gelu(approximate=False) evaluated in float32, result in h's dtype."""
    hf = h.float()
    return (0.5 * hf * (1.0 + torch.erf(hf * 0.7071067811865476))).to(h.dtype)


def fused_ln_mlp_residual_reference(x, attn, ln_scale, ln_bias, w1, b1, w2,
                                    b2, *, eps: float = 1e-5) -> torch.Tensor:
    """Plain version, in the Pallas body's order: x2 = x + attn in the
    compute dtype; LN statistics in float32; fc1 -> compute dtype -> + b1 ->
    GELU; out = (x2 + b2) + fc2 in float32, rounded once."""
    shape = x.shape
    dt = x.dtype
    c = shape[-1]
    x2 = (x + attn.to(dt)).reshape(-1, c).float()
    mean = x2.mean(-1, keepdim=True)
    var = ((x2 - mean) ** 2).mean(-1, keepdim=True)
    ln = ((x2 - mean) * torch.rsqrt(var + eps) * ln_scale.float()
          + ln_bias.float()).to(dt)
    h = torch.matmul(ln, w1.to(dt).t()) + b1.to(dt)
    h = gelu_exact(h)
    part = torch.matmul(h.float(), w2.to(dt).float().t())
    return ((x2 + b2.to(dt).float()) + part).to(dt).reshape(shape)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def mlp_plan(n: int, c: int, hidden: int, device, dtype) -> tuple[int, int, int, int]:
    """(tile1, tile2, k_chunk2, nz2): the tiles of fc1 and fc2 over n rows
    on ``device``'s SMs (``ops/mma_plan.py gemm_plan``) and fc2's split of
    K, as ``csrc/gemm_mma.cuh gemm_mlp`` takes them; shared by K3 and K8
    (``ops/finish.py``), whose products are the same."""
    sms = n_sm(device)
    tile1, _, _ = gemm_plan(n, hidden, c, sms, dtype)
    tile2, k_chunk2, nz2 = gemm_plan(n, c, hidden, sms, dtype, split=True)
    return tile1, tile2, k_chunk2, nz2


def _launch(x, attn, ln_scale, ln_bias, w1, b1, w2, b2, eps: float):
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_ln_mlp_residual_reference(x, attn, ln_scale, ln_bias, w1,
                                               b1, w2, b2, eps=eps)
    shape = x.shape
    c = shape[-1]
    hidden = w1.shape[0]
    dt = x.dtype
    if x.device.type != "cuda":
        raise ValueError(f"ffn kernel: unsupported device {x.device}")
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ffn kernel: unsupported dtype {dt}")
    if attn.shape != shape:
        raise ValueError("ffn kernel: x and attn shapes differ")
    if c > 1024 or c % 8 or hidden % 8:
        raise ValueError(f"ffn kernel: unsupported C={c}, hidden={hidden}")
    x = _build.aligned(x.contiguous())
    attn = _build.aligned(attn.to(x.device, dt).contiguous())
    lns, lnb = (_build.aligned(p.detach().to(x.device, torch.float32).contiguous())
                for p in (ln_scale, ln_bias))
    w1, b1, w2, b2 = (_build.aligned(p.detach().to(x.device, dt).contiguous())
                      for p in (w1, b1, w2, b2))
    if (w1.shape != (hidden, c) or b1.shape != (hidden,)
            or w2.shape != (c, hidden) or b2.shape != (c,)
            or lns.shape != (c,) or lnb.shape != (c,)):
        raise ValueError("ffn kernel: parameter shapes do not match x")
    n = x.numel() // c
    tile1, tile2, k_chunk2, nz2 = mlp_plan(n, c, hidden, x.device, dt)
    ln = torch.empty((n, c), dtype=dt, device=x.device)
    h = torch.empty((n, hidden), dtype=dt, device=x.device)
    part = (torch.empty((nz2, n, c), dtype=torch.float32, device=x.device)
            if nz2 > 1 else None)
    out = torch.empty(shape, dtype=dt, device=x.device)
    rc = _build.lib().ffn_fwd(
        x.data_ptr(), attn.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        ln.data_ptr(), h.data_ptr(), 0 if part is None else part.data_ptr(),
        out.data_ptr(), n, c, hidden, tile1, tile2, k_chunk2, nz2, float(eps),
        _build.dtype_code(x), _build.stream_ptr(x))
    _build.check(rc, "ffn_fwd")
    fused_ln_mlp_residual.launches += 1
    return out


class _Ffn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, attn, ln_scale, ln_bias, w1, b1, w2, b2, eps):
        ctx.save_for_backward(x, attn, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.eps = eps
        return _launch(x, attn, ln_scale, ln_bias, w1, b1, w2, b2, eps)

    @staticmethod
    def backward(ctx, g):
        if os.environ.get("FLAIR_FFN_BWD", "xla") == "kernel":
            x, attn, ln_scale, ln_bias, w1, b1, w2, b2 = ctx.saved_tensors
            grads = fused_ln_mlp_residual_backward(
                g, x, attn, ln_scale, ln_bias, w1, b1, w2, eps=ctx.eps)
            grads = (*grads[:7], grads[7].to(b2.dtype))
            return (*(gr if need else None
                      for gr, need in zip(grads, ctx.needs_input_grad)), None)
        grads = plain_vjp(
            lambda *a: fused_ln_mlp_residual_reference(*a, eps=ctx.eps),
            ctx.saved_tensors, g, ctx.needs_input_grad[:8])
        return (*grads, None)


def fused_ln_mlp_residual(x, attn, ln_scale, ln_bias, w1, b1, w2, b2, *,
                          eps: float = 1e-5) -> torch.Tensor:
    """``x2 = x + attn; x2 + fc2(gelu(fc1(LN(x2))))`` over (..., C) rows.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 or bfloat16, contiguous, C <= 1024, C and hidden multiples
    of 8). Differentiable in every input."""
    return _Ffn.apply(x, attn, ln_scale, ln_bias, w1, b1, w2, b2, eps)


fused_ln_mlp_residual.launches = 0

#: ffn_info's epilogues: the C entry's code of each
_EPILOGUES = {"fc1": 0, "fc2": 1, "fc2 split": 2}


def ffn_info(c: int, hidden: int, dtype=torch.bfloat16, n: int | None = None) -> dict:
    """The resources of K3's GEMM kernels in ``dtype`` on the current card,
    as the CUDA runtime reports them: registers per thread, local (spill)
    bytes per thread, shared bytes per block and resident blocks per SM,
    keyed ``"fc1 128x128"``, ``"fc2 split 64x128"`` (fc2's split-K
    partials), .... Without ``n``, every tile of the dtype's plan with
    every epilogue; with ``n``, the two kernels that
    ``fused_ln_mlp_residual`` launches for n rows of C = c with this
    hidden width."""
    if c > 1024 or c % 8 or hidden % 8:
        raise ValueError(f"ffn kernel: unsupported C={c}, hidden={hidden}")
    code = 0 if dtype == torch.float32 else 1
    if n is None:
        kernels = [(e, t) for e in _EPILOGUES for t in PLAN_TILES[dtype]]
    else:
        tile1, tile2, _, nz2 = mlp_plan(
            n, c, hidden, torch.device("cuda", torch.cuda.current_device()), dtype)
        kernels = [("fc1", tile1), ("fc2 split" if nz2 > 1 else "fc2", tile2)]
    info = {}
    for epi, tile in kernels:
        out = (ctypes.c_int * 4)()
        rc = _build.lib().ffn_gemm_info(code, tile, _EPILOGUES[epi], ctypes.addressof(out))
        _build.check(rc, "ffn_gemm_info")
        bm, bn = MMA_TILES[tile]
        info[f"{epi} {bm}x{bn}"] = dict(
            zip(("regs", "spill_bytes", "shared_bytes", "blocks_per_sm"), out))
    return info


def _matmul(a, b):
    """a @ b: the one helper through which K7's plain version takes its five
    products (fc1, dh, dW2, dW1, dln), so that a test can run them as the
    card's tensor cores take them (``tests/_tf32.py``)."""
    return torch.matmul(a, b)


def fused_ln_mlp_residual_backward_reference(x, attn, ln_scale, ln_bias, w1, b1,
                                             w2, g, *, eps: float = 1e-5) -> tuple:
    """K7's plain version, step by step in the rounding order of the Pallas
    backward (``_bwd_body`` :245-291 and ``_kernel_bwd``'s LayerNorm epilogue
    :393-419): h0 = rnd(ln W1^T) + b1 in the compute dtype, h = GELU(h0);
    g cast to the compute dtype for the products, db2 = sum g in float32;
    dh = g W2 in float32, dh0 = dh * gelu'(h0) with gelu' = Phi + z phi in
    float32, db1 = sum dh0; dh0c = rnd(dh0) for dW1 = dh0c^T ln and dln =
    dh0c W1 (float32); the LayerNorm backward in float32 and dx = rnd(g +
    dx2) = dattn. The products go through ``_matmul``. Returns (dx, dattn,
    dln_scale, dln_bias, dw1, db1, dw2, db2), the weight gradients in the
    ``nn.Linear`` layout and the inputs' dtypes (db2 in w2's)."""
    shape = x.shape
    dt = x.dtype
    c = shape[-1]
    x2 = (x + attn.to(dt)).reshape(-1, c).float()
    mean = x2.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x2 - mean) ** 2).mean(-1, keepdim=True) + eps)
    nrm = (x2 - mean) * rstd
    ln = (nrm * ln_scale.float() + ln_bias.float()).to(dt)
    h0 = _matmul(ln, w1.to(dt).t()) + b1.to(dt)
    h = gelu_exact(h0)
    gc = g.reshape(-1, c).to(dt).float()
    db2 = gc.sum(0)
    dw2 = _matmul(gc.t(), h.float())
    z = h0.float()
    dgelu = (0.5 * (1.0 + torch.erf(z * 0.7071067811865476))
             + z * torch.exp(-0.5 * z * z) * 0.3989422804014327)
    dh0 = _matmul(gc, w2.to(dt).float()) * dgelu
    db1 = dh0.sum(0)
    dh0c = dh0.to(dt).float()
    dw1 = _matmul(dh0c.t(), ln.float())
    dln = _matmul(dh0c, w1.to(dt).float())
    dlns = (dln * nrm).sum(0)
    dlnb = dln.sum(0)
    dnrm = dln * ln_scale.float()
    m1 = dnrm.mean(-1, keepdim=True)
    m2 = (dnrm * nrm).mean(-1, keepdim=True)
    dx2 = rstd * (dnrm - m1 - nrm * m2)
    dx = (g.reshape(-1, c).float() + dx2).to(dt).reshape(shape)
    return (dx, dx.to(attn.dtype), dlns.to(ln_scale.dtype),
            dlnb.to(ln_bias.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
            dw2.to(w2.dtype), db2.to(w2.dtype))


#: most rows one of K7's weight-gradient partials sums. The tensor cores
#: add each k step's products into the float32 accumulator without
#: rounding to nearest, so a partial's error grows with its rows (about
#: as its rows times the square root of n): at 81920 rows, partials of
#: 2496 put dW2 at twice the backward's elementwise bound on the H100,
#: partials of 1008 at 32768 rows at 0.43 of it. Shorter partials, added
#: in order in float32 by sum_partials_kernel, keep it well inside; a
#: whole number of pipeline steps in either dtype.
WGRAD_ROWS = 512


class BwdPlan(NamedTuple):
    """K7's launch plan at n rows of C (tile codes of ``ops/mma_plan.py``)."""
    tile_h: int       # fc1's and dh's tile (n x hidden over C): K3's fc1 tile
    tile_w: int       # the weight gradients' tile
    k_chunk_w2: int   # rows of each dW2 partial
    k_chunk_w1: int   # rows of each dW1 partial
    tile_dln: int     # dln's tile
    k_chunk_dln: int  # hidden columns each dln partial sums (hidden: not split)
    rows: int         # rows per block of the LayerNorm-backward pass
    db1_blocks: int   # db1's float32 partials: one per row block of tile_h
    part: int         # float32 elements of the partials' buffer


def _bwd_plan(n: int, c: int, hidden: int, n_sm: int, dtype) -> BwdPlan:
    """K7's plan on a card of ``n_sm`` SMs: fc1 and dh take the tile of
    ``mlp_plan``'s fc1 (``gemm_plan`` at n x hidden over C), so that the
    recomputed h is K3's; dW2 (C, hidden) and dW1 (hidden, C) the
    ``wgrad_plan`` over the n rows, in partials of at most ``WGRAD_ROWS``
    rows; dln ``gemm_plan`` at n x C over hidden, K cut where the smallest
    tile leaves SMs idle; the LayerNorm-backward pass about two blocks per
    SM. The three split products run one after
    another, so one buffer holds the partials of each in turn, sized for
    the largest."""
    tile_h, _, _ = gemm_plan(n, hidden, c, n_sm, dtype)
    tile_w, k_w2, _ = wgrad_plan(c, hidden, n, n_sm, dtype)
    _, k_w1, _ = wgrad_plan(hidden, c, n, n_sm, dtype)
    k_w2, k_w1 = min(k_w2, WGRAD_ROWS), min(k_w1, WGRAD_ROWS)
    nz_w2, nz_w1 = _ceil(n, k_w2), _ceil(n, k_w1)
    tile_dln, k_dln, nz_dln = gemm_plan(n, c, hidden, n_sm, dtype, split=True)
    part = max(nz_w2 * c * hidden, nz_w1 * hidden * c, nz_dln * n * c if nz_dln > 1 else 0)
    return BwdPlan(tile_h, tile_w, k_w2, k_w1, tile_dln, k_dln, max(8, _ceil(n, 4 * n_sm)),
                   _ceil(n, MMA_TILES[tile_h][0]), part)


def fused_ln_mlp_residual_backward(g, x, attn, ln_scale, ln_bias, w1, b1, w2,
                                   *, eps: float = 1e-5) -> tuple:
    """Gradients of ``fused_ln_mlp_residual`` for the output gradient g:
    (dx, dattn, dln_scale, dln_bias, dw1, db1, dw2, db2), weights in the
    ``nn.Linear`` layout. CPU tensors take the plain version; CUDA tensors
    launch K7 (float32 or bfloat16, C <= 1024, C and hidden multiples of 8;
    parameter gradients accumulate in float32 and are returned in the
    parameters' dtypes, db2 in w2's)."""
    if x.device.type == "cpu":
        return fused_ln_mlp_residual_backward_reference(
            x, attn, ln_scale, ln_bias, w1, b1, w2, g, eps=eps)
    what = "ffn backward kernel"
    shape = x.shape
    c = shape[-1]
    hidden = w1.shape[0]
    dt = x.dtype
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: unsupported dtype {dt}")
    if attn.shape != shape or g.shape != shape:
        raise ValueError(f"{what}: x, attn and g shapes differ")
    if c > 1024 or c % 8 or hidden % 8:
        raise ValueError(f"{what}: unsupported C={c}, hidden={hidden}")
    xc = _build.aligned(x.contiguous())
    ac = _build.aligned(attn.to(dev, dt).contiguous())
    gc = _build.aligned(g.to(dev, dt).contiguous())
    lns, lnb = (_build.aligned(p.detach().to(dev, torch.float32).contiguous())
                for p in (ln_scale, ln_bias))
    w1c, b1c, w2c = (_build.aligned(p.detach().to(dev, dt).contiguous())
                     for p in (w1, b1, w2))
    if (w1c.shape != (hidden, c) or b1c.shape != (hidden,)
            or w2c.shape != (c, hidden) or lns.shape != (c,) or lnb.shape != (c,)):
        raise ValueError(f"{what}: parameter shapes do not match x")
    n = x.numel() // c
    plan = _bwd_plan(n, c, hidden, n_sm(dev), dt)
    # dh = g W2 and dln = dh0c W1 as C = A W^T on the transposed copies
    w1t, w2t = (_build.aligned(w.t().contiguous()) for w in (w1c, w2c))

    def f32(*s):
        return torch.empty(s, dtype=torch.float32, device=dev)

    def cdt(*s):
        return torch.empty(s, dtype=dt, device=dev)

    ln, h0, h, dh0c = cdt(n, c), cdt(n, hidden), cdt(n, hidden), cdt(n, hidden)
    db1_part, part = f32(plan.db1_blocks, hidden), f32(plan.part)
    dln, row_part = f32(n, c), f32(_ceil(n, plan.rows), 3 * c)
    dx = torch.empty(shape, dtype=dt, device=dev)
    dvec, dw1, db1, dw2 = f32(3, c), f32(hidden, c), f32(hidden), f32(c, hidden)
    rc = _build.lib().ffn_bwd(
        xc.data_ptr(), ac.data_ptr(), gc.data_ptr(), lns.data_ptr(),
        lnb.data_ptr(), w1c.data_ptr(), b1c.data_ptr(), w1t.data_ptr(),
        w2t.data_ptr(), ln.data_ptr(), h0.data_ptr(), h.data_ptr(),
        dh0c.data_ptr(), db1_part.data_ptr(), part.data_ptr(), dln.data_ptr(),
        row_part.data_ptr(), dx.data_ptr(), dvec.data_ptr(), dw1.data_ptr(),
        db1.data_ptr(), dw2.data_ptr(), n, c, hidden, plan.tile_h, plan.tile_w,
        plan.k_chunk_w2, plan.k_chunk_w1, plan.tile_dln, plan.k_chunk_dln,
        plan.rows, float(eps), _build.dtype_code(x), _build.stream_ptr(x))
    _build.check(rc, "ffn_bwd")
    fused_ln_mlp_residual_backward.launches += 1
    dlns, dlnb, db2 = dvec
    return (dx, dx.to(attn.dtype), dlns.to(ln_scale.dtype),
            dlnb.to(ln_bias.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
            dw2.to(w2.dtype), db2.to(w2.dtype))


fused_ln_mlp_residual_backward.launches = 0

#: ffn_bwd_gemm_info's products: the C entry's code of each
_BWD_PRODUCTS = {"fc1": 0, "dh": 1, "wgrad": 2, "dln": 3}


def ffn_bwd_gemm_info(dtype=torch.bfloat16) -> dict:
    """The resources of K7's product kernels (``gemm_mma.cuh``) in
    ``dtype`` on the current card, as the CUDA runtime reports them:
    registers per thread, local (spill) bytes per thread, shared bytes per
    block and resident blocks per SM, keyed ``"fc1 128x128"`` (fc1's
    recompute, ``MMA_GELU_AUX``), ``"dh 64x128"`` (``MMA_DGELU``), ``"dln
    64x128"`` (``MMA_PART``) at every tile of the dtype's plan, and
    ``"wgrad 64x128"`` (``MMA_WGRAD``, ``mma_plan.WGRAD_TILE``)."""
    code = 0 if dtype == torch.float32 else 1
    kernels = [(p, t) for p in ("fc1", "dh", "dln") for t in PLAN_TILES[dtype]]
    info = {}
    for name, tile in kernels + [("wgrad", WGRAD_TILE)]:
        out = (ctypes.c_int * 4)()
        rc = _build.lib().ffn_bwd_gemm_info(code, tile, _BWD_PRODUCTS[name],
                                            ctypes.addressof(out))
        _build.check(rc, "ffn_bwd_gemm_info")
        bm, bn = MMA_TILES[tile]
        info[f"{name} {bm}x{bn}"] = dict(
            zip(("regs", "spill_bytes", "shared_bytes", "blocks_per_sm"), out))
    return info
