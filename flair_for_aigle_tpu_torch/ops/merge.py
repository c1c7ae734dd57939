"""K5: fused swin patch merging — 2x2 gather + LayerNorm + bias-free
reduction (CUDA kernel ``csrc/merge.cu``) and its plain PyTorch version.

Replaces ``flair_for_aigle_tpu/ops/pallas/merge.py:120 fused_patch_merge``
(``_build_call`` :32). On the card the merge is one GEMM on
``csrc/gemm_mma.cuh`` whose A operand is produced from x as it is copied
into shared memory: the four input tokens gathered in timm order [x00,
x10, x01, x11], normalised there with float32 two-pass LayerNorm
statistics over the 4C concat that a block prologue takes, and rounded to
the compute dtype, so the LN rows never reach device memory. See the CUDA
source for the bounds. ``ops/mma_plan.py gemm_plan`` picks the tile and
whether K is cut (float32 partials then summed in a fixed order and
rounded); ``merge_info`` reports the kernels' resources. The reduction
weight uses the ``nn.Linear`` layout (out_c, 4C). H and W must be even:
the odd pad stays in ``models/swin.py PatchMerging``, as in the reference
(``swin.py:333-335``).

Differentiable: the backward recomputes through the plain version from the
saved raw inputs (``merge.py:112-114``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flair_for_aigle_tpu_torch.ops import _build
from flair_for_aigle_tpu_torch.ops._vjp import plain_vjp
from flair_for_aigle_tpu_torch.ops.mma_plan import MMA_TILES, gemm_plan, n_sm

#: largest 4C the wrapper takes (swin-base's widest merge: 4C = 2048)
MAX_4C = 4096
#: the GEMM tiles the merge's plan picks from: 64 x 128 in both dtypes (at
#: 128 x 128 the LayerNorm producer's bf16 kernel spills past the 128
#: registers of two blocks an SM)
MERGE_TILES = (1,)


def patch_gather(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C): each 2x2 neighbourhood's four
    tokens in timm order [x00, x10, x01, x11] (row offset first)."""
    b, h, w, c = x.shape
    y = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
    return y.reshape(b, h // 2, w // 2, 4 * c)


def fused_patch_merge_reference(x: torch.Tensor, ln_scale, ln_bias, w_red, *,
                                eps: float = 1e-5) -> torch.Tensor:
    """Plain version (the reference's ``_xla_forward``, ``merge.py:81``):
    timm-order gather, float32 LN over 4C, LN rounded to the compute dtype,
    float32-accumulated reduction rounded once."""
    dt = x.dtype
    yf = patch_gather(x).float()
    mean = yf.mean(-1, keepdim=True)
    var = ((yf - mean) ** 2).mean(-1, keepdim=True)
    ln = ((yf - mean) * torch.rsqrt(var + eps) * ln_scale.float()
          + ln_bias.float()).to(dt)
    return torch.matmul(ln, w_red.to(dt).t())


@functools.lru_cache(maxsize=256)
def merge_plan(m: int, n: int, k: int, sms: int, dtype) -> tuple[int, int, int]:
    """(tile code, k_chunk, partials) of the merge's product of m rows:
    ``gemm_plan`` with a split of K, from ``MERGE_TILES``. Cached: a model
    calls it with a few shapes."""
    return gemm_plan(m, n, k, sms, dtype, split=True, codes=MERGE_TILES)


def _launch(x: torch.Tensor, ln_scale, ln_bias, w_red, eps: float) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_patch_merge_reference(x, ln_scale, ln_bias, w_red, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"merge kernel: unsupported device {x.device}")
    return _kernel(x, ln_scale, ln_bias, w_red, eps)


def _kernel(x: torch.Tensor, ln_scale, ln_bias, w_red, eps: float) -> torch.Tensor:
    """The kernel's launch: checks, plan, the output (and the float32
    partials where the plan cuts K) and nothing else allocated; parameters
    already in place pass through uncopied."""
    b, h, w, c = x.shape
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"merge kernel: unsupported dtype {dt}")
    if not x.is_contiguous():
        raise ValueError("merge kernel: input must be contiguous NHWC")
    if h % 2 or w % 2 or c % 8 or 4 * c > MAX_4C:
        raise ValueError(f"merge kernel: unsupported H={h}, W={w}, C={c} "
                         f"(needs even H and W, C % 8 == 0, 4C <= {MAX_4C})")
    # the GEMM reads x and the weight 16 bytes at a time, the parameters
    # 32 bytes at a time (at 16-byte boundaries)
    x = _build.aligned(x)
    lns, lnb = (_build.param(p, x.device, torch.float32) for p in (ln_scale, ln_bias))
    wr = _build.param(w_red, x.device, dt)
    out_c = wr.shape[0]
    if lns.shape != (4 * c,) or lnb.shape != (4 * c,) or wr.shape != (out_c, 4 * c):
        raise ValueError("merge kernel: parameter shapes do not match x")
    m = b * (h // 2) * (w // 2)
    tile, k_chunk, nz = merge_plan(m, out_c, 4 * c, n_sm(x.device), dt)
    part = (torch.empty((nz, m, out_c), dtype=torch.float32, device=x.device)
            if nz > 1 else None)
    out = torch.empty((b, h // 2, w // 2, out_c), dtype=dt, device=x.device)
    rc = _build.lib().merge_fwd(
        x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), wr.data_ptr(),
        0 if part is None else part.data_ptr(), out.data_ptr(), b, h, w, c, out_c,
        tile, k_chunk, nz, eps, _build.dtype_code(x), _build.stream_ptr(x))
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
    input; where no gradient is wanted (inference) it skips the autograd
    node."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, ln_scale, ln_bias, w_red)):
        return _Merge.apply(x, ln_scale, ln_bias, w_red, eps)
    return _launch(x, ln_scale, ln_bias, w_red, eps)


fused_patch_merge.launches = 0


def merge_info(dtype=torch.bfloat16, m: int | None = None, c: int | None = None) -> dict:
    """The resources of the merge's GEMM kernels (``gemm_mma.cuh`` with
    K5's LayerNorm producer of A) in ``dtype`` on the current card, as the
    CUDA runtime reports them: registers per thread, local (spill) bytes
    per thread, shared bytes per block and resident blocks per SM, keyed
    ``"64x128"``, ``"64x128 split"`` (K cut, float32 partials). Without
    ``m``, every tile of ``MERGE_TILES``, unsplit and split; with
    ``m`` output rows of C = c, the kernel ``fused_patch_merge`` launches."""
    code = 0 if dtype == torch.float32 else 1
    if m is None:
        kernels = [(t, split) for t in MERGE_TILES for split in (False, True)]
    else:
        sms = n_sm(torch.device("cuda", torch.cuda.current_device()))
        tile, _, nz = merge_plan(m, 2 * c, 4 * c, sms, dtype)
        kernels = [(tile, nz > 1)]
    info = {}
    for tile, split in kernels:
        out = (ctypes.c_int * 4)()
        rc = _build.lib().merge_info(code, tile, int(split), ctypes.addressof(out))
        _build.check(rc, "merge_info")
        bm, bn = MMA_TILES[tile]
        info[f"{bm}x{bn}{' split' if split else ''}"] = dict(
            zip(("regs", "spill_bytes", "shared_bytes", "blocks_per_sm"), out))
    return info
