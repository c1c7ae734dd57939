"""K5: fused swin patch merging — 2x2 gather + LayerNorm + bias-free
reduction (CUDA kernel ``csrc/merge.cu``) and its plain PyTorch version.

Replaces ``flair_for_aigle_tpu/ops/pallas/merge.py:120 fused_patch_merge``
(``_build_call`` :32). On the card one block per output token gathers the
four input tokens in timm order [x00, x10, x01, x11], takes float32
two-pass LayerNorm statistics over the 4C concat and writes the LN row in
the compute dtype; the reduction is a tensor-core GEMM (``gemm.cuh``). See
the CUDA source for the bounds. The reduction weight uses the ``nn.Linear``
layout (out_c, 4C). H and W must be even: the odd pad stays in
``models/swin.py PatchMerging``, as in the reference (``swin.py:333-335``).

Differentiable: the backward recomputes through the plain version from the
saved raw inputs (``merge.py:112-114``).
"""

from __future__ import annotations

import torch

from flair_for_aigle_tpu_torch.ops import _build
from flair_for_aigle_tpu_torch.ops._vjp import plain_vjp

#: largest 4C the kernel holds in registers (128 threads x 32 values)
MAX_4C = 4096


def fused_patch_merge_reference(x: torch.Tensor, ln_scale, ln_bias, w_red, *,
                                eps: float = 1e-5) -> torch.Tensor:
    """Plain version (the reference's ``_xla_forward``, ``merge.py:81``):
    timm-order gather, float32 LN over 4C, LN rounded to the compute dtype,
    float32-accumulated reduction rounded once."""
    b, h, w, c = x.shape
    dt = x.dtype
    y = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
    yf = y.reshape(b, h // 2, w // 2, 4 * c).float()
    mean = yf.mean(-1, keepdim=True)
    var = ((yf - mean) ** 2).mean(-1, keepdim=True)
    ln = ((yf - mean) * torch.rsqrt(var + eps) * ln_scale.float()
          + ln_bias.float()).to(dt)
    return torch.matmul(ln, w_red.to(dt).t())


def _launch(x: torch.Tensor, ln_scale, ln_bias, w_red, eps: float) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_patch_merge_reference(x, ln_scale, ln_bias, w_red, eps=eps)
    b, h, w, c = x.shape
    dt = x.dtype
    if x.device.type != "cuda":
        raise ValueError(f"merge kernel: unsupported device {x.device}")
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"merge kernel: unsupported dtype {dt}")
    if not x.is_contiguous():
        raise ValueError("merge kernel: input must be contiguous NHWC")
    if h % 2 or w % 2 or c % 8 or 4 * c > MAX_4C:
        raise ValueError(f"merge kernel: unsupported H={h}, W={w}, C={c} "
                         f"(needs even H and W, C % 8 == 0, 4C <= {MAX_4C})")
    # the reduction GEMM reads its operands 16 bytes at a time
    x = _build.aligned(x)
    lns, lnb = (_build.aligned(p.detach().to(x.device, torch.float32).contiguous())
                for p in (ln_scale, ln_bias))
    wr = _build.aligned(w_red.detach().to(x.device, dt).contiguous())
    out_c = wr.shape[0]
    if lns.shape != (4 * c,) or lnb.shape != (4 * c,) or wr.shape != (out_c, 4 * c):
        raise ValueError("merge kernel: parameter shapes do not match x")
    ln = torch.empty((b * (h // 2) * (w // 2), 4 * c), dtype=dt, device=x.device)
    out = torch.empty((b, h // 2, w // 2, out_c), dtype=dt, device=x.device)
    rc = _build.lib().merge_fwd(
        x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), wr.data_ptr(),
        ln.data_ptr(), out.data_ptr(), b, h, w, c, out_c, float(eps),
        _build.dtype_code(x), _build.stream_ptr(x))
    _build.check(rc, "merge_fwd")
    fused_patch_merge.launches += 1
    return out


class _Merge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_red, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w_red)
        ctx.eps = eps
        return _launch(x, ln_scale, ln_bias, w_red, eps)

    @staticmethod
    def backward(ctx, g):
        grads = plain_vjp(
            lambda *a: fused_patch_merge_reference(*a, eps=ctx.eps),
            ctx.saved_tensors, g, ctx.needs_input_grad[:4])
        return (*grads, None)


def fused_patch_merge(x: torch.Tensor, ln_scale, ln_bias, w_red, *,
                      eps: float = 1e-5) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, out_c): timm patch merging. CPU tensors
    take the plain version; CUDA tensors launch the kernel (float32 or
    bfloat16, contiguous NHWC, even H and W). Differentiable in every
    input."""
    return _Merge.apply(x, ln_scale, ln_bias, w_red, eps)


fused_patch_merge.launches = 0
