"""K1: fused swin-block prologue — LN + cyclic shift + pad + window
partition (CUDA kernel ``csrc/prep.cu``) and its plain PyTorch version.

Replaces ``flair_for_aigle_tpu/ops/pallas/prep.py:146
fused_ln_shift_partition``. On the card the op is bandwidth-bound (one read
of the activation, one write of the windows); the kernel resolves the
shift/pad/partition gather as it walks the padded raster, a group of lanes
a token, 16 bytes a lane at a time, and keeps each token's channels in
registers between the LayerNorm statistics and the write, so the
activation is read once and no shifted or padded copy exists.
``prep_plan`` cuts the work (group width, vectors a lane, positions a
unit, blocks); ``prep_info`` reports the kernels' resources.

Differentiable: the backward recomputes through the plain version from the
saved raw inputs, as the reference's ``custom_vjp`` does (``prep.py:137-141``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from flair_for_aigle_tpu_torch.ops import _build
from flair_for_aigle_tpu_torch.ops._vjp import plain_vjp
from flair_for_aigle_tpu_torch.ops.mma_plan import n_sm

#: threads of a kernel block
PREP_THREADS = 256
#: most positions of the padded raster a group walks in one unit
PREP_MAX_RUN = 16
#: units each resident group gets at least, where the raster allows
PREP_UNITS_PER_GROUP = 4


class PrepPlan(NamedTuple):
    """How ``csrc/prep.cu`` cuts one call: a token to a group of ``g``
    lanes, ``v`` 16-byte vectors a lane (lane l of a group owns the vectors
    l, l + g, ...), units of ``run`` consecutive positions of the padded
    raster, ``blocks`` blocks of ``threads``."""
    g: int
    v: int
    run: int
    threads: int
    blocks: int


def prep_vec(dtype) -> int:
    """Values of a 16-byte vector: 8 bf16, 4 float32."""
    return {torch.bfloat16: 8, torch.float32: 4}[dtype]


def prep_min_blocks(v: int, dtype) -> int:
    """Resident blocks per SM the kernel's launch bounds promise, from the
    values a lane holds of each token (``csrc/prep.cu prep_min_blocks``):
    4 up to 8 values, 2 up to 16, 3 beyond (scale and bias then in shared
    memory, and one token's registers a lane)."""
    f = v * prep_vec(dtype)
    return 4 if f <= 8 else 2 if f <= 16 else 3


def prep_group(c: int, dtype) -> tuple[int, int]:
    """(g, v): the group width, the power of two at or above C / VEC up to
    32, and the vectors a lane then holds. Raises ValueError where C is not
    a whole number of vectors or above 1024."""
    vec = prep_vec(dtype)
    if c % vec or not 0 < c <= 1024:
        raise ValueError(f"prep kernel: C={c} must be a multiple of {vec} in "
                         f"{str(dtype).replace('torch.', '')}, at most 1024")
    nv = c // vec
    g = min(32, 1 << (nv - 1).bit_length())
    return g, -(-nv // g)


@functools.lru_cache(maxsize=256)
def prep_plan(c: int, dtype, sms: int, n_pos: int) -> PrepPlan:
    """The plan of one call over ``n_pos`` positions of the padded raster
    (B hp wp tokens) of C channels in ``dtype`` on a card of ``sms`` SMs:
    the group of ``prep_group``; units of the fewest positions (up to
    ``PREP_MAX_RUN``) that still give every group of one resident wave
    ``PREP_UNITS_PER_GROUP`` units; at most that wave of blocks, and no
    more than the units fill. Cached: a model calls it with a few shapes."""
    g, v = prep_group(c, dtype)
    per_block = PREP_THREADS // g
    wave = sms * prep_min_blocks(v, dtype)
    run = max(1, min(PREP_MAX_RUN, n_pos // (PREP_UNITS_PER_GROUP * wave * per_block)))
    units = -(-n_pos // run)
    return PrepPlan(g, v, run, PREP_THREADS, max(1, min(wave, -(-units // per_block))))


def _padded(n: int, ws: int) -> int:
    return n + (ws - n % ws) % ws


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C), windows row-major per image."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    x = x.reshape(-1, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, w, c)


def fused_ln_shift_partition_reference(x: torch.Tensor, ln_scale, ln_bias, *,
                                       ws: int, ss: int,
                                       eps: float = 1e-5) -> torch.Tensor:
    """Plain version: LN (float32 statistics) -> roll(-ss) -> zero pad ->
    window partition, in the Pallas body's order of operations."""
    b, h, w, c = x.shape
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = (y * ln_scale.float() + ln_bias.float()).to(x.dtype)
    if ss:
        y = torch.roll(y, (-ss, -ss), dims=(1, 2))
    hp, wp = _padded(h, ws), _padded(w, ws)
    if hp > h or wp > w:
        y = torch.nn.functional.pad(y, (0, 0, 0, wp - w, 0, hp - h))
    return window_partition(y, ws)


def _launch(x: torch.Tensor, ln_scale, ln_bias, ws: int, ss: int,
            eps: float) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_ln_shift_partition_reference(x, ln_scale, ln_bias, ws=ws,
                                                  ss=ss, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"prep kernel: unsupported device {x.device}")
    return _kernel(x, ln_scale, ln_bias, ws, ss, eps)


def _kernel(x: torch.Tensor, ln_scale, ln_bias, ws: int, ss: int, eps: float) -> torch.Tensor:
    """The kernel's launch: checks, plan, the output and nothing else
    allocated; parameters already in place pass through uncopied."""
    b, h, w, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"prep kernel: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("prep kernel: input must be contiguous NHWC")
    if not 0 <= ss < ws:
        raise ValueError(f"prep kernel: unsupported ws={ws}, ss={ss}")
    hp, wp = _padded(h, ws), _padded(w, ws)
    plan = prep_plan(c, x.dtype, n_sm(x.device), b * hp * wp)
    # the kernel reads x, the scale and the bias 16 bytes at a time
    x = _build.aligned(x)
    scale, bias = (_build.param(p, x.device, torch.float32) for p in (ln_scale, ln_bias))
    if scale.numel() != c or bias.numel() != c:
        raise ValueError("prep kernel: LayerNorm params must have C entries")
    out = torch.empty((b * (hp // ws) * (wp // ws), ws * ws, c),
                      dtype=x.dtype, device=x.device)
    rc = _build.lib().prep_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, h, w, c, ws, ss, eps, plan.g, plan.v, plan.run, plan.blocks,
        _build.dtype_code(x), _build.stream_ptr(x))
    _build.check(rc, "prep_fwd")
    fused_ln_shift_partition.launches += 1
    return out


class _Prep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, ws, ss, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias)
        ctx.cfg = dict(ws=ws, ss=ss, eps=eps)
        return _launch(x, ln_scale, ln_bias, ws, ss, eps)

    @staticmethod
    def backward(ctx, g):
        grads = plain_vjp(
            lambda *a: fused_ln_shift_partition_reference(*a, **ctx.cfg),
            ctx.saved_tensors, g, ctx.needs_input_grad[:3])
        return (*grads, None, None, None)


def fused_ln_shift_partition(x: torch.Tensor, ln_scale, ln_bias, *, ws: int,
                             ss: int, eps: float = 1e-5) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C): LN + roll(-ss) + pad-to-window +
    window partition. CPU tensors take the plain version; CUDA tensors
    launch the kernel (float32 or bfloat16, contiguous NHWC, C <= 1024, C a
    multiple of 8 in bf16 and of 4 in float32). Differentiable in x and the
    LayerNorm parameters; where no gradient is wanted (inference) it skips
    the autograd node."""
    if torch.is_grad_enabled() and (x.requires_grad or ln_scale.requires_grad
                                    or ln_bias.requires_grad):
        return _Prep.apply(x, ln_scale, ln_bias, ws, ss, eps)
    return _launch(x, ln_scale, ln_bias, ws, ss, eps)


fused_ln_shift_partition.launches = 0


def prep_info(c: int, dtype=torch.bfloat16) -> dict:
    """The resources of the kernel that ``fused_ln_shift_partition`` runs
    at C = c in ``dtype`` on the current card, as the CUDA runtime reports
    them: registers per thread, local (spill) bytes per thread, shared
    bytes per block and resident blocks per SM; with the plan's group
    width ``g``, vectors a lane ``v`` and the blocks per SM its launch
    bounds promise."""
    g, v = prep_group(c, dtype)
    out = (ctypes.c_int * 4)()
    rc = _build.lib().prep_info(0 if dtype == torch.float32 else 1, g, v, ctypes.addressof(out))
    _build.check(rc, "prep_info")
    return {**dict(zip(("regs", "spill_bytes", "shared_bytes", "blocks_per_sm"), out)),
            "g": g, "v": v, "min_blocks": prep_min_blocks(v, dtype)}
