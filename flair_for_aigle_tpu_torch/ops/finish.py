"""K8: fused swin-block finish — window reverse + crop + un-shift + residual
+ LayerNorm + MLP + residual (CUDA kernel ``csrc/finish.cu``) and its plain
PyTorch version.

Replaces ``flair_for_aigle_tpu/ops/pallas/finish.py:166
fused_reverse_ln_mlp_residual`` (``_build_call`` :41), which the swin block
runs when ``FLAIR_SWIN_FINISH=1``. On the card a gather pass reads each
output token's attention row straight from the windows (16 bytes a lane,
``ops/prep.py prep_group``'s lane groups), so the reversed, cropped and
rolled raster never exists, and writes that row and its LayerNorm;
``finish_gather_reference`` is its plain version, index map and all. fc1
and fc2 are then K3's own products (``ops/ffn.py mlp_plan``,
``csrc/gemm_mma.cuh gemm_mlp``). ``finish_info`` reports the gather pass's
resources. See the CUDA source for the bounds.

Weights use the ``nn.Linear`` layout: ``w1`` (hidden, C), ``w2`` (C, hidden).
Differentiable: the backward recomputes through the plain version from the
saved raw inputs, as the reference's ``custom_vjp`` does (``finish.py:157-160``);
like the reference's, it differentiates the plain ffn, so the ffn backward
kernel (``FLAIR_FFN_BWD=kernel``) never runs inside a finish block.
"""

from __future__ import annotations

import ctypes

import torch

from flair_for_aigle_tpu_torch.ops import _build
from flair_for_aigle_tpu_torch.ops._vjp import plain_vjp
from flair_for_aigle_tpu_torch.ops.ffn import fused_ln_mlp_residual_reference, mlp_plan
from flair_for_aigle_tpu_torch.ops.prep import _padded, prep_group, prep_vec, window_reverse


def fused_reverse_ln_mlp_residual_reference(win, x, ln_scale, ln_bias, w1, b1,
                                            w2, b2, *, ws: int, ss: int,
                                            eps: float = 1e-5) -> torch.Tensor:
    """Plain version, in the Pallas body's order: ``attn =
    roll(window_reverse(win)[:, :h, :w], +ss)``, then K3's plain version
    (x2 = x + attn in the compute dtype, LN statistics in float32, fc1 ->
    compute dtype -> + b1 -> exact GELU, out = (x2 + b2) + fc2 in float32,
    rounded once)."""
    _, h, w, _ = x.shape
    y = window_reverse(win, ws, _padded(h, ws), _padded(w, ws))[:, :h, :w]
    if ss:
        y = torch.roll(y, (ss, ss), dims=(1, 2))
    return fused_ln_mlp_residual_reference(x, y, ln_scale, ln_bias, w1, b1, w2,
                                           b2, eps=eps)


def finish_gather_reference(win, x, ln_scale, ln_bias, *, ws: int, ss: int,
                            eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The gather pass's plain version, by its index map: output token (b,
    r, c) of x (B, H, W, C) reads window row (q % ws) ws + p % ws of window
    (b, q // ws, p // ws), q = (r - ss) mod H and p = (c - ss) mod W (the
    cropped size: no pad row or column of the padded grid is read).
    Returns (ln, a), both (B H W, C) in x's dtype: a the gathered attention
    rows, ln the LayerNorm of x2 = x + a rounded to x's dtype (float32
    statistics), as K3's plain version normalises."""
    b, h, w, c = x.shape
    nwh, nww = _padded(h, ws) // ws, _padded(w, ws) // ws
    dev = x.device
    q = (torch.arange(h, device=dev) - ss) % h
    p = (torch.arange(w, device=dev) - ss) % w
    window = ((torch.arange(b, device=dev)[:, None, None] * nwh + (q // ws)[None, :, None])
              * nww + (p // ws)[None, None, :])
    token = ((q % ws) * ws)[:, None] + (p % ws)[None, :]
    a = win.reshape(-1, c)[(window * ws * ws + token[None]).reshape(-1)].to(x.dtype)
    x2 = (x.reshape(-1, c) + a).float()
    mean = x2.mean(-1, keepdim=True)
    var = ((x2 - mean) ** 2).mean(-1, keepdim=True)
    ln = ((x2 - mean) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float())
    return ln.to(x.dtype), a


def _launch(win, x, ln_scale, ln_bias, w1, b1, w2, b2, ws: int, ss: int,
            eps: float) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_reverse_ln_mlp_residual_reference(
            win, x, ln_scale, ln_bias, w1, b1, w2, b2, ws=ws, ss=ss, eps=eps)
    what = "finish kernel"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: unsupported dtype {dt}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous NHWC")
    b, h, w, c = x.shape
    hidden = w1.shape[0]
    if c > 1024 or c % 8 or hidden % 8 or not 0 <= ss < ws:
        raise ValueError(f"{what}: unsupported C={c}, hidden={hidden}, "
                         f"ws={ws}, ss={ss}")
    n_win = b * (_padded(h, ws) // ws) * (_padded(w, ws) // ws)
    if win.shape != (n_win, ws * ws, c):
        raise ValueError(f"{what}: windows {tuple(win.shape)} do not tile "
                         f"x {tuple(x.shape)} with ws={ws}")
    # the gather pass and the GEMMs read their operands 16 bytes at a time
    x = _build.aligned(x)
    win = _build.aligned(win.to(x.device, dt).contiguous())
    lns, lnb = (_build.aligned(p.detach().to(x.device, torch.float32).contiguous())
                for p in (ln_scale, ln_bias))
    w1, b1, w2, b2 = (_build.aligned(p.detach().to(x.device, dt).contiguous())
                      for p in (w1, b1, w2, b2))
    if (w1.shape != (hidden, c) or b1.shape != (hidden,)
            or w2.shape != (c, hidden) or b2.shape != (c,)
            or lns.shape != (c,) or lnb.shape != (c,)):
        raise ValueError(f"{what}: parameter shapes do not match x")
    n = b * h * w
    g, v = prep_group(c, dt)
    tile1, tile2, k_chunk2, nz2 = mlp_plan(n, c, hidden, x.device, dt)
    ln = torch.empty((n, c), dtype=dt, device=x.device)
    a = torch.empty((n, c), dtype=dt, device=x.device)
    hid = torch.empty((n, hidden), dtype=dt, device=x.device)
    part = (torch.empty((nz2, n, c), dtype=torch.float32, device=x.device)
            if nz2 > 1 else None)
    out = torch.empty_like(x)
    rc = _build.lib().finish_fwd(
        win.data_ptr(), x.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        ln.data_ptr(), a.data_ptr(), hid.data_ptr(),
        0 if part is None else part.data_ptr(), out.data_ptr(),
        b, h, w, c, hidden, ws, ss, g, v, tile1, tile2, k_chunk2, nz2, float(eps),
        _build.dtype_code(x), _build.stream_ptr(x))
    _build.check(rc, "finish_fwd")
    fused_reverse_ln_mlp_residual.launches += 1
    return out


class _Finish(torch.autograd.Function):
    @staticmethod
    def forward(ctx, win, x, ln_scale, ln_bias, w1, b1, w2, b2, ws, ss, eps):
        ctx.save_for_backward(win, x, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.cfg = dict(ws=ws, ss=ss, eps=eps)
        return _launch(win, x, ln_scale, ln_bias, w1, b1, w2, b2, ws, ss, eps)

    @staticmethod
    def backward(ctx, g):
        grads = plain_vjp(
            lambda *a: fused_reverse_ln_mlp_residual_reference(*a, **ctx.cfg),
            ctx.saved_tensors, g, ctx.needs_input_grad[:8])
        return (*grads, None, None, None)


def fused_reverse_ln_mlp_residual(win, x, ln_scale, ln_bias, w1, b1, w2, b2,
                                  *, ws: int, ss: int,
                                  eps: float = 1e-5) -> torch.Tensor:
    """Attention windows (B*nW, ws*ws, C) of the padded, shifted raster +
    block shortcut x (B, H, W, C) -> block output (B, H, W, C) in x's dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 or bfloat16, contiguous NHWC, C <= 1024, C and hidden multiples
    of 8). Differentiable in every tensor input."""
    return _Finish.apply(win, x, ln_scale, ln_bias, w1, b1, w2, b2, ws, ss,
                         eps)


fused_reverse_ln_mlp_residual.launches = 0


def finish_min_blocks(v: int, dtype) -> int:
    """Resident blocks per SM the gather pass's launch bounds promise, from
    the values a lane holds of each token (``csrc/finish.cu
    fin_min_blocks``): 4 up to 8 values, 3 up to 16, else 2."""
    f = v * prep_vec(dtype)
    return 4 if f <= 8 else 3 if f <= 16 else 2


def finish_info(c: int, dtype=torch.bfloat16) -> dict:
    """The resources of the gather pass that ``fused_reverse_ln_mlp_residual``
    runs at C = c in ``dtype`` on the current card, as the CUDA runtime
    reports them: registers per thread, local (spill) bytes per thread,
    shared bytes per block and resident blocks per SM; with the group
    width ``g``, vectors a lane ``v`` (``ops/prep.py prep_group``) and the
    blocks per SM its launch bounds promise. fc1 and fc2 are K3's kernels
    (``ops/ffn.py ffn_info``)."""
    g, v = prep_group(c, dtype)
    out = (ctypes.c_int * 4)()
    rc = _build.lib().finish_info(0 if dtype == torch.float32 else 1, g, v, ctypes.addressof(out))
    _build.check(rc, "finish_info")
    return {**dict(zip(("regs", "spill_bytes", "shared_bytes", "blocks_per_sm"), out)),
            "g": g, "v": v, "min_blocks": finish_min_blocks(v, dtype)}
