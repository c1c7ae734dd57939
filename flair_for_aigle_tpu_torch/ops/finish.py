"""K8: fused swin-block finish — window reverse + crop + un-shift + residual
+ LayerNorm + MLP + residual (CUDA kernel ``csrc/finish.cu``) and its plain
PyTorch version.

Replaces ``flair_for_aigle_tpu/ops/pallas/finish.py:166
fused_reverse_ln_mlp_residual`` (``_build_call`` :41), which the swin block
runs when ``FLAIR_SWIN_FINISH=1``. On the card a gather + LayerNorm pass
reads each output token's attention row straight from the windows, so the
reversed, cropped and rolled raster never exists; fc1 and fc2 are K3's
tensor-core GEMMs. See the CUDA source for the bounds.

Weights use the ``nn.Linear`` layout: ``w1`` (hidden, C), ``w2`` (C, hidden).
Differentiable: the backward recomputes through the plain version from the
saved raw inputs, as the reference's ``custom_vjp`` does (``finish.py:157-160``);
like the reference's, it differentiates the plain ffn, so the ffn backward
kernel (``FLAIR_FFN_BWD=kernel``) never runs inside a finish block.
"""

from __future__ import annotations

import torch

from flair_for_aigle_tpu_torch.ops import _build
from flair_for_aigle_tpu_torch.ops._vjp import plain_vjp
from flair_for_aigle_tpu_torch.ops.ffn import fused_ln_mlp_residual_reference
from flair_for_aigle_tpu_torch.ops.prep import _padded, window_reverse


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
    # the GEMMs read their operands 16 bytes at a time
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
    ln = torch.empty((n, c), dtype=dt, device=x.device)
    x2 = torch.empty((n, c), dtype=dt, device=x.device)
    hid = torch.empty((n, hidden), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    rc = _build.lib().finish_fwd(
        win.data_ptr(), x.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        ln.data_ptr(), x2.data_ptr(), hid.data_ptr(), out.data_ptr(),
        b, h, w, c, hidden, ws, ss, float(eps), _build.dtype_code(x),
        _build.stream_ptr(x))
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
