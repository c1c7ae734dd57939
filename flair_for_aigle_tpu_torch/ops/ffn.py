"""K3: fused transformer-block tail — residual + LayerNorm + MLP + residual
(CUDA kernel ``csrc/ffn.cu``) and its plain PyTorch version.

Replaces ``flair_for_aigle_tpu/ops/pallas/ffn.py:481 fused_ln_mlp_residual``
(forward; body ``_kernel_body`` :120). On the card the fc1/fc2 products are
tensor-core GEMMs whose epilogues apply bias + exact GELU (fc1) and the
float32 residual (fc2, recomputing x + attn); the LayerNorm is one
bandwidth-bound pass. See the CUDA source for the bounds.

Weights use the ``nn.Linear`` layout: ``w1`` (hidden, C), ``w2`` (C, hidden).
Differentiable: the backward recomputes through the plain version from the
saved raw inputs, the reference's default route (``ffn.py:474-475``; its
opt-in backward kernel, ``FLAIR_FFN_BWD=kernel``, is not ported yet).
"""

from __future__ import annotations

import torch

from flair_for_aigle_tpu_torch.ops import _build
from flair_for_aigle_tpu_torch.ops._vjp import plain_vjp


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
    x = x.contiguous()
    attn = attn.to(x.device, dt).contiguous()
    lns, lnb = (p.detach().to(x.device, torch.float32).contiguous()
                for p in (ln_scale, ln_bias))
    w1, b1, w2, b2 = (p.detach().to(x.device, dt).contiguous()
                      for p in (w1, b1, w2, b2))
    if (w1.shape != (hidden, c) or b1.shape != (hidden,)
            or w2.shape != (c, hidden) or b2.shape != (c,)
            or lns.shape != (c,) or lnb.shape != (c,)):
        raise ValueError("ffn kernel: parameter shapes do not match x")
    n = x.numel() // c
    ln = torch.empty((n, c), dtype=dt, device=x.device)
    h = torch.empty((n, hidden), dtype=dt, device=x.device)
    out = torch.empty(shape, dtype=dt, device=x.device)
    rc = _build.lib().ffn_fwd(
        x.data_ptr(), attn.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        ln.data_ptr(), h.data_ptr(), out.data_ptr(), n, c, hidden, float(eps),
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
